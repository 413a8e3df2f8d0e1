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

The learning rate is a float. A schedule (step -> lr) is given to
``parallel.train.build_train_step`` alone, which sets each step's rate from
it.
"""
from typing import Any, Dict

import torch
from torch import nn

from ..register import entrypoint, register

__all__ = ["create_optimizer", "decay_mask"]

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
    every parameter decays.
    """
    if radial_projection:
        raise NotImplementedError(
            "radial_projection is not ported (ROADMAP.md, Queue 1, DDP: it serves only the "
            "frozen-statistics BatchNorm, which the port refuses)")
    if layer_decay:
        raise NotImplementedError("layer_decay is not ported yet (ROADMAP.md, Queue 1, ViTPose)")
    params = dict(module.named_parameters())
    if weight_decay and filter_bias_and_bn:
        mask = decay_mask(module)
        groups = [
            {"params": [p for n, p in params.items() if mask[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0},
        ]
    else:
        groups = [{"params": list(params.values()), "weight_decay": weight_decay}]
    return entrypoint("optim", name)(groups, learning_rate=float(learning_rate), **kwargs)
