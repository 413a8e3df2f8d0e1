"""Optimizer factory on torch.optim.

Counterpart of mindpose_tpu/optim/optim_factory.py: the registered names
adam/sgd/momentum/adagrad/adamw, and the no-weight-decay group of biases
and normalization scales (``filter_bias_and_bn``). Each optimizer computes
what its optax counterpart does:
- adamw decouples the decay (``optax.adamw``): p -= lr * (adam + wd * p);
- adam, sgd, momentum and adagrad add L2 decay to the gradient before the
  update (``optax.add_decayed_weights`` ahead of the optimizer);
- adagrad starts its accumulator at 0.1 with eps 1e-7, as ``optax.adagrad``
  (which takes the eps inside the square root, torch outside it: a 2e-7
  relative difference at the accumulator's least value).

``layer_decay`` (the ViTPose fine-tuning recipe) gives each parameter a
learning-rate scale (``layer_decay_scales``); the parameters split into one
group per (decays, scale) pair, each group's scale kept as
``group["lr_scale"]`` and its rate ``lr * lr_scale``. optax scales the whole
update after the optimizer, weight decay included; a torch group's rate
multiplies the step and the decoupled decay alike, so the two agree.

``radial_projection`` (adamw only, as in JAX) builds ``RadialAdamW``:
optax's chain ``scale_by_adam``, ``project_radial`` over
``radial_projection_mask``, ``add_decayed_weights``,
``scale_by_learning_rate`` (``optim_factory.py:233-245``), with torch
AdamW's state, so checkpoints, a JAX TrainState's moments, the rate writes
and FSDP's optimizer state treat it as AdamW. Its groups split once more,
by the dim each projected filter keeps.

The learning rate is a float. A schedule (step -> lr) is given to
``parallel.train.build_train_step`` alone, which sets each step's rate from
it, times the group's ``lr_scale``.
"""
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..register import entrypoint, register

__all__ = ["create_optimizer", "decay_mask", "layer_decay_scales", "radial_projection_mask",
           "RadialAdamW"]

_NORMS = (nn.modules.batchnorm._NormBase, nn.LayerNorm, nn.GroupNorm)


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """True for parameters that receive weight decay, by ``named_parameters`` name.

    The JAX package exempts flax leaves named ``bias`` and ``scale``. In
    torch a normalization layer's scale is named ``weight``, like a conv's
    kernel, so the test is by module type: every ``bias`` and every weight
    of a normalization layer is exempt; every other parameter decays.
    """
    mask = {}
    for mod_name, mod in module.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = not (name == "bias" or isinstance(mod, _NORMS))
    return mask


_BLOCK = re.compile(r"(?:^|\.)blocks\.(\d+)\.")


def layer_decay_scales(module: nn.Module, decay: float) -> Dict[str, float]:
    """Per-parameter layer-wise lr multipliers for a block-indexed (ViT) backbone,
    by ``named_parameters`` name.

    Counterpart of the JAX package's ``layer_decay_scales``: ``decay ** (depth
    + 1 - layer_id)``, where block ``i`` (``backbone.blocks.{i}.*``) has
    layer_id ``i + 1``, the patch embed and the position grid 0, and
    everything else (the final norm, the head) ``depth + 1``. Raises for a
    module with no ``blocks.{i}``, where the knob has no defined meaning.
    """
    params = dict(module.named_parameters())
    blocks = {name: int(m.group(1)) for name in params if (m := _BLOCK.search(name))}
    if not blocks:
        raise ValueError(
            "layer_decay requires a block-indexed (ViT) backbone; this "
            "parameter tree has no block_{i} scopes")
    depth = max(blocks.values()) + 1

    def layer_id(name: str) -> int:
        if name in blocks:
            return blocks[name] + 1
        parts = name.split(".")
        if parts[0] == "backbone" and ("patch_embed" in parts or "pos_embed" in parts):
            return 0
        return depth + 1

    return {name: decay ** (depth + 1 - layer_id(name)) for name in params}


# where a converter entry puts the flax leaf's last axis, the filter's output
# channel (flax kernels [kh, kw, I, O]; ``models/convert.py``'s layouts)
_CHANNEL_DIM = {"conv": 0, "conv_bias": 0, "deconv": 1, "param": 3}


def radial_projection_mask(net: nn.Module) -> Dict[str, Optional[int]]:
    """The JAX package's ``radial_projection_mask`` (``optim_factory.py:38-59``)
    seen through the converter's ``net_mapping``, by ``named_parameters`` name:
    for each projected tensor the dim of its output channel, None for the rest.

    JAX projects every 4-D leaf of the backbone but ViT's ``patch_embed``
    (ViT's 4-D ``pos_embedding`` too), and the head's leaves under a
    ``ConvTranspose`` or ``BasicBlock`` scope; each per output channel, flax's
    last axis: dim 0 of a ``Conv2d`` weight, dim 1 of a ``ConvTranspose2d``
    weight ([I, O, kh, kw]), dim 3 of the position grid (1, gh, gw, D).
    """
    from ..models.convert import net_mapping

    mask: Dict[str, Optional[int]] = dict.fromkeys(name for name, _ in net.named_parameters())
    for kind, name, path in net_mapping(net):
        if kind not in _CHANNEL_DIM or any("patch_embed" in n for n in path):
            continue
        if path[0] == "backbone" or any("ConvTranspose" in n or "BasicBlock" in n
                                        for n in path):
            mask[name if kind == "param" else f"{name}.weight"] = _CHANNEL_DIM[kind]
    return mask


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (sharing its storage), else ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


class RadialAdamW(torch.optim.AdamW):
    """AdamW whose update leaves each projected filter's norm unchanged to first order.

    Per parameter, as optax's chain computes it: the bias-corrected Adam
    direction u = m_hat / (sqrt(v_hat) + eps); where the group's
    ``radial_dim`` is set, each output channel's radial part removed,
    u -= w * <u, w> / (<w, w> + 1e-12), the sums over every other dim; the
    decay added after the projection, u += weight_decay * w; then w -= lr * u.
    The state is torch AdamW's (``step``, ``exp_avg``, ``exp_avg_sq``).
    A DTensor (FSDP) parameter is updated shard by shard; where it is
    sharded along a summed dim, the shards' sums are all-reduced over that
    mesh dim, so they cover the whole filter.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0) -> None:
        super().__init__(params, lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
        for group in self.param_groups:
            group.setdefault("radial_dim", None)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p,
                                                           memory_format=torch.preserve_format)
                state["step"] += 1
            states = [self.state[p] for p in params]
            ws = [_local(p) for p in params]
            grads = [_local(p.grad) for p in params]
            mus = [_local(s["exp_avg"]) for s in states]
            nus = [_local(s["exp_avg_sq"]) for s in states]
            steps = [float(s["step"]) for s in states]
            torch._foreach_lerp_(mus, grads, 1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nus, [1.0 - b2 ** t for t in steps])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, denom)
            torch._foreach_div_(updates, [1.0 - b1 ** t for t in steps])
            if group["radial_dim"] is not None:
                _project_radial(updates, ws, params, group["radial_dim"])
            if group["weight_decay"]:
                torch._foreach_add_(updates, ws, alpha=group["weight_decay"])
            torch._foreach_add_(ws, updates, alpha=-group["lr"])
        return loss


def _project_radial(updates, ws, params, keep: int) -> None:
    """u -= w * <u, w> / (<w, w> + 1e-12) per index of dim ``keep``, in place;
    a DTensor's shard sums all-reduced over each mesh dim that splits a summed dim."""
    import torch.distributed as dist

    sums = []
    for u, w in zip(updates, ws):
        dims = tuple(d for d in range(w.dim()) if d != keep)
        sums.append(torch.stack([(u * w).sum(dims, keepdim=True),
                                 (w * w).sum(dims, keepdim=True)]))
    pending: Dict[Any, list] = {}  # process group -> indices whose sums it completes
    for i, p in enumerate(params):
        for mesh_dim, placement in enumerate(getattr(p, "placements", ())):
            if placement.is_shard() and placement.dim != keep:
                pending.setdefault(p.device_mesh.get_group(mesh_dim), []).append(i)
    for group, index in pending.items():
        flat = torch.cat([sums[i].reshape(-1) for i in index])
        dist.all_reduce(flat, group=group)
        for i, part in zip(index, flat.split([sums[i].numel() for i in index])):
            sums[i] = part.view_as(sums[i])
    for u, w, (dot, nrm) in zip(updates, ws, sums):
        u.sub_(w * (dot / (nrm + 1e-12)))


def _adam_kwargs(kw: Dict[str, Any]) -> Dict[str, Any]:
    out = {"betas": (kw.get("b1", 0.9), kw.get("b2", 0.999))}
    if "eps" in kw:
        out["eps"] = kw["eps"]
    return out


def _register_optimizers():
    @register("optim", extra_name="adam")
    def adam(groups, learning_rate, **kw):
        return torch.optim.Adam(groups, lr=learning_rate, **_adam_kwargs(kw))

    @register("optim", extra_name="adamw")
    def adamw(groups, learning_rate, **kw):
        return torch.optim.AdamW(groups, lr=learning_rate, **_adam_kwargs(kw))

    @register("optim", extra_name="sgd")
    def sgd(groups, learning_rate, **kw):
        return torch.optim.SGD(groups, lr=learning_rate)

    @register("optim", extra_name="momentum")
    def momentum(groups, learning_rate, momentum=0.9, **kw):
        return torch.optim.SGD(groups, lr=learning_rate, momentum=momentum)

    @register("optim", extra_name="adagrad")
    def adagrad(groups, learning_rate, **kw):
        return torch.optim.Adagrad(groups, lr=learning_rate, initial_accumulator_value=0.1,
                                   eps=1e-7)


_register_optimizers()


def create_optimizer(
    module: nn.Module,
    name: str = "adam",
    learning_rate: float = 0.001,
    weight_decay: float = 0.0,
    filter_bias_and_bn: bool = True,
    radial_projection: bool = False,
    layer_decay: float = 0.0,
    **kwargs: Any,
) -> torch.optim.Optimizer:
    """Create a torch optimizer over ``module``'s parameters.

    With ``weight_decay`` and ``filter_bias_and_bn`` the parameters split
    into a decayed group and an undecayed one (``decay_mask``); otherwise
    every parameter decays. With ``layer_decay`` in (0, 1] each of those
    splits again by the parameters' ``layer_decay_scales``; with
    ``radial_projection`` (adamw only) by the dim each projected filter
    keeps (``radial_projection_mask``), into a ``RadialAdamW``.
    """
    if radial_projection and name not in ("adamw", "AdamWeightDecay"):
        raise ValueError(f"radial_projection is only supported with adamw (got {name!r})")
    params = dict(module.named_parameters())
    scales = dict.fromkeys(params, 1.0)
    if layer_decay:
        if not 0.0 < layer_decay <= 1.0:
            raise ValueError(f"layer_decay must be in (0, 1], got {layer_decay}")
        scales = layer_decay_scales(module, layer_decay)
    mask = (decay_mask(module) if weight_decay and filter_bias_and_bn
            else dict.fromkeys(params, True))
    radial = radial_projection_mask(module) if radial_projection else dict.fromkeys(params)
    lr = float(learning_rate)
    groups: Dict[Any, Dict[str, Any]] = {}  # by (decays, scale, radial dim), in order of first use
    for n, p in params.items():
        key = (mask[n], scales[n], radial[n])
        if key not in groups:
            groups[key] = {"params": [], "weight_decay": weight_decay if mask[n] else 0.0,
                           "lr": lr * scales[n], "lr_scale": scales[n]}
            if radial_projection:
                groups[key]["radial_dim"] = radial[n]
        groups[key]["params"].append(p)
    if radial_projection:
        return RadialAdamW(list(groups.values()), lr=lr, **_adam_kwargs(kwargs))
    return entrypoint("optim", name)(list(groups.values()), learning_rate=lr, **kwargs)
