"""The train step, on one device.

Counterpart of mindpose_tpu/parallel/train.py without the mesh: the JAX
step ``jit``s forward, backward and the optimizer update over a functional
``TrainState``; here the parameters and BatchNorm statistics live in the
module and the optimizer's state in the optimizer, and the step updates
them in place. Multi-component losses are summed for the backward pass and
returned per component. Data parallelism (DDP, with the BatchNorm running
statistics averaged across ranks, as the JAX step ``pmean``s them) is not
ported yet.

``amp_level`` O1/O2/O3 is the JAX package's bf16 compute dtype
(``tools/train.py`` builds the net with ``dtype=bfloat16`` for any level but
O0): the forward runs under ``torch.autocast(bfloat16)`` with float32
parameters, BatchNorm takes its statistics in float32, and the loss is
float32. A float32 step on a CUDA device turns TF32 off, as the predictor
does: PyTorch would otherwise run float32 convolutions in TF32.
"""
import contextlib
from typing import Callable, Mapping, Optional, Sequence

import torch

from ..models.networks import NetWithLoss

__all__ = ["accum_loss_and_grads", "build_train_step", "build_ema_update"]

_AMP_LEVELS = ("O0", "O1", "O2", "O3")


def accum_loss_and_grads(
    net_with_loss: NetWithLoss,
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
    losses = []
    for mb in micro:
        if preprocess is not None:
            mb = preprocess(*mb)
        with autocast():
            loss_vec = net_with_loss(*mb)
        loss_vec.sum().backward()
        losses.append(loss_vec.detach())
    if len(micro) > 1:
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum_steps)
    return torch.stack(losses).mean(0)


def build_train_step(
    net_with_loss: NetWithLoss,
    optimizer: torch.optim.Optimizer,
    schedule: Optional[Callable[[int], float]] = None,
    preprocess: Optional[Callable] = None,
    accum_steps: int = 1,
    amp_level: str = "O0",
    start_step: int = 0,
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
    """
    if amp_level not in _AMP_LEVELS:
        raise ValueError(f"amp_level must be one of {_AMP_LEVELS}, got {amp_level!r}")
    device = next(net_with_loss.parameters()).device
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
        loss_vec = accum_loss_and_grads(net_with_loss, batch, accum_steps, preprocess, autocast)
        optimizer.step()
        step.count += 1
        return loss_vec

    step.count = int(start_step)
    return step


Tensors = Mapping[str, torch.Tensor]


def build_ema_update(decay: float) -> Callable[[Tensors, Tensors], Tensors]:
    """``update(ema_params, params)``: ema = decay * ema + (1 - decay) * params.

    Takes two dicts of tensors with the same keys (a ``state_dict``'s
    floating tensors, say) and updates ``ema_params`` in place, where the
    JAX package returns a new tree; returns it.
    """

    @torch.no_grad()
    def update(ema_params: Tensors, params: Tensors) -> Tensors:
        for k, e in ema_params.items():
            e.mul_(decay).add_(params[k].to(e.dtype), alpha=1.0 - decay)
        return ema_params

    return update
