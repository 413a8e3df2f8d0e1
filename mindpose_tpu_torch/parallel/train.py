"""The train step, on one device or data-parallel over a process group.

Counterpart of mindpose_tpu/parallel/train.py: the JAX step ``jit``s
forward, backward and the optimizer update over a functional
``TrainState``; here the parameters and BatchNorm statistics live in the
module and the optimizer's state in the optimizer, and the step updates
them in place. Multi-component losses are summed for the backward pass and
returned per component.

Data parallelism: where the JAX step runs a ``shard_map`` over the mesh's
data axis and ``pmean``s the gradients, the loss and the BatchNorm running
statistics (:160-164), the port runs one process per card, each with a full
replica fed its own shard of the records. Within a process group the step
wraps the net in ``DistributedDataParallel(broadcast_buffers=False)``,
which averages the gradients in the last microbatch's backward (the others
run under ``no_sync``: JAX accumulates per shard, then ``pmean``s once);
after the optimizer step it all-reduces the loss vector and every
BatchNorm running mean and variance to their mean. BatchNorm normalizes
with each rank's own batch statistics, as in JAX, and DDP's default would
copy rank 0's running statistics to the others instead of averaging them.
Every rank then holds the same parameters, optimizer state and
statistics, bit for bit: the all-reduced values are the same on each.

FSDP (``parallel/fsdp.py``): a net that ``shard_net`` sharded runs as it
is, without DDP; all microbatches but the last run with FSDP's gradient
sync off, so that the last backward reduce-scatters the accumulated
gradients once, as JAX's FSDP step (:129) reduces its accumulated ones.
The loss vector is all-reduced to its mean; the BatchNorm statistics were
taken over the global batch inside the forward, so they are not averaged
again.

``amp_level`` O1/O2/O3 is the JAX package's bf16 compute dtype
(``tools/train.py`` builds the net with ``dtype=bfloat16`` for any level but
O0): the forward runs under ``torch.autocast(bfloat16)`` with float32
parameters, BatchNorm takes its statistics in float32, and the loss is
float32. A float32 step on a CUDA device turns TF32 off, as the predictor
does: PyTorch would otherwise run float32 convolutions in TF32.
"""
import contextlib
from typing import Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..models.networks import NetWithLoss
from .fsdp import is_sharded, no_gradient_sync

__all__ = ["accum_loss_and_grads", "build_train_step", "build_ema_update"]

_AMP_LEVELS = ("O0", "O1", "O2", "O3")


def accum_loss_and_grads(
    net_with_loss: nn.Module,
    batch: Sequence[torch.Tensor],
    accum_steps: int = 1,
    preprocess: Optional[Callable] = None,
    autocast: Callable[[], contextlib.AbstractContextManager] = contextlib.nullcontext,
) -> torch.Tensor:
    """Run forward and backward; leave the gradients in ``.grad``; return the loss vector.

    With ``accum_steps > 1`` the batch splits into that many microbatches
    along dim 0, run in order at fixed parameters: gradients are summed over
    them and divided by ``accum_steps``, and the loss vectors averaged. The
    BatchNorm running statistics update once per microbatch, in order, as
    the JAX scan threads them (the semantics of training at the smaller
    batch). ``preprocess`` runs on each microbatch before the forward.
    ``net_with_loss`` may be a ``DistributedDataParallel`` over one, or hold
    a sharded net: all microbatches but the last run under DDP's
    ``no_sync`` or FSDP's ``no_gradient_sync``, so that the gradients are
    reduced across ranks once.
    """
    params = [p for p in net_with_loss.parameters() if p.requires_grad]
    for p in params:
        p.grad = None
    if accum_steps <= 1:
        micro = [tuple(batch)]
    else:
        b = int(batch[0].shape[0])
        if b % accum_steps:
            raise ValueError(f"batch size {b} is not divisible by accum_steps={accum_steps}")
        micro = list(zip(*(x.reshape(accum_steps, b // accum_steps, *x.shape[1:])
                           for x in batch)))
    no_sync = getattr(net_with_loss, "no_sync", contextlib.nullcontext)
    if is_sharded(net_with_loss):
        def no_sync():
            return no_gradient_sync(net_with_loss)
    losses = []
    for i, mb in enumerate(micro):
        if preprocess is not None:
            mb = preprocess(*mb)
        with no_sync() if i < len(micro) - 1 else contextlib.nullcontext():
            with autocast():
                loss_vec = net_with_loss(*mb)
            loss_vec.sum().backward()
        losses.append(loss_vec.detach())
    if len(micro) > 1:
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum_steps)
    return torch.stack(losses).mean(0)


def batch_norm_statistics(module: nn.Module) -> List[torch.Tensor]:
    """Every BatchNorm running mean and variance of ``module``, in module order."""
    return [t for m in module.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats
            for t in (m.running_mean, m.running_var)]


@torch.no_grad()
def average_across_ranks(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the group's ranks, in place.

    One all-reduce (a sum, then a division by the world size, as
    ``lax.pmean``) per dtype over the tensors laid end to end; every rank
    gets the same values.
    """
    world = dist.get_world_size(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def build_train_step(
    net_with_loss: NetWithLoss,
    optimizer: torch.optim.Optimizer,
    schedule: Optional[Callable[[int], float]] = None,
    preprocess: Optional[Callable] = None,
    accum_steps: int = 1,
    amp_level: str = "O0",
    start_step: int = 0,
    process_group=None,
) -> Callable[..., torch.Tensor]:
    """Returns ``step(*batch) -> loss vector`` (detached).

    ``batch`` holds the data columns in order (data, label, *extra), or the
    raw columns that ``preprocess`` (data/device_pipeline.py) turns into
    them on the device. Each call takes one optimizer step; with a
    ``schedule`` it first sets every parameter group's learning rate to
    ``schedule(steps taken so far)`` times the group's ``lr_scale`` (layer
    decay; 1 where the group has none), as optax evaluates a schedule at the
    count before it increments. ``step.count`` is that count; it starts at
    ``start_step``, the steps a resumed run has already taken, so that the
    schedule continues where that run left it.

    Data-parallel within ``process_group``, or the default group where one
    is initialised and ``process_group`` is None: the forward and backward
    run through ``step.module``, a ``DistributedDataParallel`` over
    ``net_with_loss`` (its construction copies rank 0's parameters and
    buffers to every rank), and the returned loss vector and the BatchNorm
    running statistics are the means over the ranks. At world size 1 the
    wrap and the all-reduces still run, so that a one-card run under
    torchrun measures their cost. Every net of the port gives each of its
    parameters a gradient, so DDP looks for none left unused. A net that
    ``parallel/fsdp.shard_net`` sharded is not wrapped (``step.module`` is
    ``net_with_loss``): FSDP reduces the gradients, and only the loss
    vector is all-reduced after the step.
    """
    if amp_level not in _AMP_LEVELS:
        raise ValueError(f"amp_level must be one of {_AMP_LEVELS}, got {amp_level!r}")
    device = next(net_with_loss.parameters()).device
    if process_group is None and dist.is_available() and dist.is_initialized():
        process_group = dist.group.WORLD
    module = net_with_loss
    statistics = []
    if process_group is not None and not is_sharded(net_with_loss):
        module = nn.parallel.DistributedDataParallel(
            net_with_loss, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False, process_group=process_group)
        statistics = batch_norm_statistics(net_with_loss)
    if amp_level == "O0":
        autocast = contextlib.nullcontext
    else:
        def autocast():
            return torch.autocast(device.type, dtype=torch.bfloat16)

    def step(*batch: torch.Tensor) -> torch.Tensor:
        if device.type == "cuda" and amp_level == "O0":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if schedule is not None:
            lr = float(schedule(step.count))
            for group in optimizer.param_groups:
                group["lr"] = lr * group.get("lr_scale", 1.0)
        loss_vec = accum_loss_and_grads(module, batch, accum_steps, preprocess, autocast)
        optimizer.step()
        if process_group is not None:
            average_across_ranks([loss_vec, *statistics], process_group)
        step.count += 1
        return loss_vec

    step.count = int(start_step)
    step.module = module
    return step


Tensors = Mapping[str, torch.Tensor]


def build_ema_update(decay: float) -> Callable[[Tensors, Tensors], Tensors]:
    """``update(ema_params, params)``: ema = decay * ema + (1 - decay) * params.

    Takes two dicts of tensors with the same keys (a ``state_dict``'s
    floating tensors, say) and updates ``ema_params`` in place, where the
    JAX package returns a new tree; returns it. A sharded net's parameters
    and their EMA clones are ``DTensor``s of the same placements, so each
    rank updates its own shards, as JAX's EMA inherits the FSDP sharding
    (``tools/train.py:355-359``).
    """

    @torch.no_grad()
    def update(ema_params: Tensors, params: Tensors) -> Tensors:
        for k, e in ema_params.items():
            e.mul_(decay).add_(params[k].to(e.dtype), alpha=1.0 - decay)
        return ema_params

    return update
