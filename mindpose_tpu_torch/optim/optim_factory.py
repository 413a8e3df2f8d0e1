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

The learning rate is a float. A schedule (step -> lr) is given to
``parallel.train.build_train_step`` alone, which sets each step's rate from
it, times the group's ``lr_scale``.
"""
import re
from typing import Any, Dict

import torch
from torch import nn

from ..register import entrypoint, register

__all__ = ["create_optimizer", "decay_mask", "layer_decay_scales"]

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
    splits again by the parameters' ``layer_decay_scales``.
    """
    if radial_projection:
        raise NotImplementedError(
            "radial_projection is not ported (ROADMAP.md, Queue 1, DDP: it serves only the "
            "frozen-statistics BatchNorm, which the port refuses)")
    params = dict(module.named_parameters())
    scales = dict.fromkeys(params, 1.0)
    if layer_decay:
        if not 0.0 < layer_decay <= 1.0:
            raise ValueError(f"layer_decay must be in (0, 1], got {layer_decay}")
        scales = layer_decay_scales(module, layer_decay)
    mask = (decay_mask(module) if weight_decay and filter_bias_and_bn
            else dict.fromkeys(params, True))
    lr = float(learning_rate)
    groups: Dict[Any, Dict[str, Any]] = {}  # by (decays, scale), in order of first use
    for n, p in params.items():
        key = (mask[n], scales[n])
        if key not in groups:
            groups[key] = {"params": [], "weight_decay": weight_decay if mask[n] else 0.0,
                           "lr": lr * scales[n], "lr_scale": scales[n]}
        groups[key]["params"].append(p)
    return entrypoint("optim", name)(list(groups.values()), learning_rate=lr, **kwargs)
