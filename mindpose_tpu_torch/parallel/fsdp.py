"""FSDP: the parameters and optimizer state sharded over the ranks.

Counterpart of ``mindpose_tpu/parallel/fsdp.py``. The JAX package annotates
each leaf of at least 2^16 elements with a ``PartitionSpec`` over the
mesh's ``model`` axis and lets GSPMD insert the all-gathers and
reduce-scatters of one jit over the global batch. The port runs one process
per card and shards with torch's ``fully_shard`` on the 2-D ``(data,
model)`` mesh of ``parallel/mesh.create_mesh``: each ViT encoder block and
each HRNet exchange unit is a unit of its own, then the root takes the
rest. On that mesh ``fully_shard`` is HSDP: parameters replicated over
``data`` and sharded over ``model``, each rank fed its own slice of the
global batch, the gradients reduce-scattered over ``model`` and
all-reduced over ``data`` to the global batch's mean, as JAX's batch split
over both axes (``fsdp_batch_spec``) gives it. The optimizer, built over
the sharded parameters, keeps its moments in the same shards.

Each parameter is sharded along the dim that ``fsdp_spec``'s shape rule
picks, the largest that the ``model`` axis divides (a ViT's position grid
(1, gh, gw, D) along D, not its leading 1), and along dim 0, padded, where
none divides. Unlike JAX, which replicates leaves below 2^16 elements,
every leaf is sharded.

BatchNorm: JAX's FSDP step is one program over the global batch, so its
batch statistics are the global batch's (``fsdp.py:13-19``). ``shard_net``
therefore sets every ``BatchNorm2d``'s ``sync_group`` to the world, and the
statistics are all-reduced inside the forward; every rank then holds the
same running statistics, and the step does not average them again.

``full_state`` gathers the net, optimizer and EMA state into the files a
single-device run writes (``replicate_sharded``'s role, :104-126).
"""
import contextlib
import warnings
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.backbones.hrnet import HRModule
from ..models.backbones.vit import EncoderBlock
from ..models.common import BatchNorm2d
from .mesh import MODEL_AXIS

__all__ = [
    "shard_net",
    "is_sharded",
    "fsdp_shard_dim",
    "no_gradient_sync",
    "full_state",
    "load_optimizer_state",
    "load_sharded",
    "parameter_names",
]

# the units sharded (and all-gathered) on their own, before the root
UNITS = (EncoderBlock, HRModule)


def fsdp_shard_dim(shape, axis_size: int) -> Optional[int]:
    """``fsdp_spec``'s shape rule (``mindpose_tpu/parallel/fsdp.py:51``) as a
    dim: the largest dim that ``axis_size`` divides (ties to the later
    one), or None where none does. Unlike the JAX rule it has no size
    threshold."""
    shape = tuple(int(s) for s in shape)
    for d in sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True):
        if shape[d] % axis_size == 0:
            return d
    return None


def shard_net(net: nn.Module, mesh) -> nn.Module:
    """Shard ``net`` in place with ``fully_shard`` on ``mesh`` (the ``(data,
    model)`` mesh), and synchronise its BatchNorm statistics over the world.

    Every rank calls it, with the same net: restore weights before, and
    build the optimizer after. Returns ``net``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of the {dist.get_world_size()} ranks")
    model = mesh[MODEL_AXIS].size()

    def placement(param: nn.Parameter):
        d = fsdp_shard_dim(param.shape, model)
        return None if d is None else Shard(d)

    for module in [m for m in net.modules() if isinstance(m, UNITS)]:
        fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    fully_shard(net, mesh=mesh, shard_placement_fn=placement)
    norms = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    if norms:
        # torch marks the differentiable all-reduce deprecated, and warns at each call site
        warnings.filterwarnings("ignore", message="torch.distributed.nn.functional.all_reduce")
    for m in norms:
        m.sync_group = dist.group.WORLD
    return net


def _fsdp_root(module: nn.Module):
    from torch.distributed.fsdp import FSDPModule

    return next((m for m in module.modules() if isinstance(m, FSDPModule)), None)


def is_sharded(module: nn.Module) -> bool:
    """True where ``module`` holds a ``fully_shard``-ed net."""
    return _fsdp_root(module) is not None


@contextlib.contextmanager
def no_gradient_sync(module: nn.Module) -> Iterator[None]:
    """FSDP's counterpart of DDP's ``no_sync``: the block's backward
    accumulates unsharded gradients on each rank without reduce-scattering
    them, and the next backward with the sync on reduces their sum."""
    root = _fsdp_root(module)
    root.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        root.set_requires_gradient_sync(True)


def parameter_names(net: nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The name of each of the optimizer's parameters, in its state_dict's
    numbering (over the groups, in order)."""
    names = {id(p): n for n, p in net.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _by_name(state: Dict[str, Any], names: List[str]) -> Dict[str, Any]:
    """An ``optimizer.state_dict()`` (numbered parameters) keyed by name."""
    groups = [dict(g, params=[names[i] for i in g["params"]]) for g in state["param_groups"]]
    return {"state": {names[i]: v for i, v in state["state"].items()}, "param_groups": groups}


def _by_index(state: Dict[str, Any], names: List[str]) -> Dict[str, Any]:
    """The inverse of ``_by_name``: the numbering a single-device run saves."""
    index = {n: i for i, n in enumerate(names)}
    groups = [dict(g, params=[index[n] for n in g["params"]]) for g in state["param_groups"]]
    return {"state": {index[n]: v for n, v in state["state"].items()}, "param_groups": groups}


def full_state(net: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
               ema: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]],
                          Optional[Dict[str, torch.Tensor]]]:
    """The sharded ``net``'s state_dict, ``optimizer``'s state_dict and the EMA
    parameters, whole and on the CPU, on rank 0; ``({}, None, None)`` on the
    others.

    A collective: every rank calls it. The optimizer's state comes numbered
    as ``optimizer.state_dict()`` numbers it on one device, so rank 0 writes
    the file that a single-device run writes.
    """
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )
    from torch.distributed.tensor import DTensor

    options = StateDictOptions(full_state_dict=True, cpu_offload=True)
    net_state = get_model_state_dict(net, options=options)
    # buffers are not sharded: on a CPU net the offload hands back the live
    # tensors, which the next step would change under the caller
    buffers = {n for n, _ in net.named_buffers()}
    net_state = {n: t.clone() if n in buffers else t for n, t in net_state.items()}
    optim_state = None
    if optimizer is not None:
        optim_state = get_optimizer_state_dict(net, optimizer, options=options)
    ema_state = None
    if ema is not None:
        ema_state = {n: (t.full_tensor() if isinstance(t, DTensor) else t).cpu()
                     for n, t in ema.items()}
    if dist.get_rank() != 0:
        return {}, None, None
    if optim_state is not None:
        optim_state = _by_index(optim_state, parameter_names(net, optimizer))
    return net_state, optim_state, ema_state


def load_optimizer_state(net: nn.Module, optimizer: torch.optim.Optimizer,
                         state: Dict[str, Any], names: List[str]) -> None:
    """Load a whole ``optimizer.state_dict()``, numbered over ``names``, into
    the optimizer of the sharded ``net``: each rank keeps its shards.

    Every rank calls it with the same state, before the first step."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_optimizer_state_dict,
    )

    set_optimizer_state_dict(net, optimizer, _by_name(state, names),
                             options=StateDictOptions(full_state_dict=True))


@torch.no_grad()
def load_sharded(params: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor]) -> None:
    """Copy whole tensors into (possibly sharded) ones of the same names: each
    rank keeps its own shard of each."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    for name, p in params.items():
        value = values[name].to(p.device, p.dtype)
        if isinstance(p, DTensor):
            value = distribute_tensor(value, p.device_mesh, p.placements)
        p.copy_(value)
