"""Post-training int8 weight quantization for serving.

Counterpart of ``mindpose_tpu/models/quantize.py``, with its rule leaf for
leaf. The JAX package quantizes each flax leaf named ``kernel`` or
``embedding`` that is floating and holds at least ``_MIN_SIZE`` elements:
symmetric, one float32 scale per output channel (the leaf's last axis),
``scale = max(absmax, 1e-12) / 127`` and ``q = clip(round(w / scale), -127,
127)`` as int8 (round half to even, in numpy and in torch alike). Every
other leaf (biases, BatchNorm and LayerNorm parameters and statistics, the
position grid) stays float.

The port's weights are a ``state_dict`` in torch's layouts, so the rule
selects by the flax leaf that each tensor converts from: the entries of
``models/convert.net_mapping`` say which that is (``weight`` also names a
BatchNorm's or a LayerNorm's scale, which stays float). The output axis of
each kind, in torch's layout:

- ``Conv2d`` [O, I, kh, kw] and ``Linear`` [O, I]: dim 0, one scale per row;
- ``ConvTranspose2d`` [I, O, kh, kw] (the flax kernel flipped, which moves
  no value between channels): dim 1;
- ViT's attention ``out`` kernel [heads, hd, D] is ``proj.weight`` [D, D]:
  one scale per row;
- its query, key and value kernels [D, heads, hd] are the three thirds of
  ``qkv.weight`` [3D, D], row ``h * hd + j`` of a third from head ``h`` and
  index ``j``: JAX takes the absmax over every axis but ``hd``, so each third
  has one scale per ``j``, shared by the heads and the inputs; the port views
  the weight as [3, heads, hd, D] and keeps a [3, 1, hd, 1] scale.

Each scale keeps the shape that broadcasts it over its weight (or that
view), with one float32 value per JAX scale, so ``quantized_bytes`` equals
JAX's for every net. The JAX package's ``_MIN_SIZE`` applies to each of
query, key and value, a third of the fused tensor.

``quantize_variables`` runs in the state's place (the predictor quantizes
the loaded float weights on the host, then uploads the int8 tensors);
``quantized_eval_apply`` dequantizes inside every call of the forward, as
JAX's jit does, and no float copy of a quantized weight outlives the call.
"""
from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple

import torch
from torch import nn

from .convert import net_mapping, num_heads

__all__ = [
    "QTensor",
    "quantize_variables",
    "dequantize_variables",
    "quantized_eval_apply",
    "quantized_bytes",
]

_MIN_SIZE = 1024  # the JAX package's: tiny leaves stay float
_KERNEL_KINDS = ("conv", "conv_bias", "deconv", "dense", "out", "qkv")


class QTensor(NamedTuple):
    """An int8 weight in torch's layout with its float32 scales.

    ``(q.reshape(groups) * scale).reshape(q.shape)`` is the dequantized
    weight; ``groups`` is ``q``'s shape but for ViT's fused ``qkv``.
    """

    q: torch.Tensor
    scale: torch.Tensor
    groups: Tuple[int, ...]


def _quantize(w: torch.Tensor, groups: Tuple[int, ...], out_dims: Tuple[int, ...]) -> QTensor:
    """JAX's arithmetic on ``w`` viewed as ``groups``, one scale per index of ``out_dims``."""
    v = w.detach().to(torch.float32).reshape(groups)
    reduce = tuple(d for d in range(v.dim()) if d not in out_dims)
    absmax = v.abs().amax(dim=reduce, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return QTensor(q.reshape(w.shape), scale, tuple(groups))


def _kernel_layout(kind: str, w: torch.Tensor, heads: int) -> Tuple[Tuple[int, ...],
                                                                   Tuple[int, ...], int]:
    """(groups, output dims, elements of one JAX leaf) of a kernel entry's weight."""
    if kind == "deconv":
        return tuple(w.shape), (1,), w.numel()
    if kind == "qkv":
        d = w.shape[1]
        return (3, heads, d // heads, d), (0, 2), w.numel() // 3
    return tuple(w.shape), (0,), w.numel()


def quantize_variables(state: Mapping[str, torch.Tensor], net: nn.Module) -> Dict[str, Any]:
    """``net``'s ``state`` with each weight that JAX quantizes as a ``QTensor``.

    ``net`` gives the mapping (``models/convert.net_mapping``) and ViT's head
    counts; its own tensors are not read, so it may live on the meta device.
    Every other entry of ``state`` is kept as it is.
    """
    heads = num_heads(net)
    out: Dict[str, Any] = dict(state)
    for kind, name, _ in net_mapping(net):
        key = f"{name}.weight"
        if kind not in _KERNEL_KINDS or key not in state:
            continue
        w = state[key]
        if not w.is_floating_point():
            continue
        groups, out_dims, leaf_size = _kernel_layout(kind, w, heads.get(name, 1))
        if leaf_size >= _MIN_SIZE:
            out[key] = _quantize(w, groups, out_dims)
    return out


def _dequantize(t: QTensor, dtype: torch.dtype) -> torch.Tensor:
    # int8 * float32 promotes to float32: the product of q.float() and the scale
    return (t.q.reshape(t.groups) * t.scale).reshape(t.q.shape).to(dtype)


def dequantize_variables(qstate: Mapping[str, Any],
                         dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """A float state: every ``QTensor`` of ``qstate`` dequantized, the rest as it is."""
    return {k: _dequantize(v, dtype) if isinstance(v, QTensor) else v for k, v in qstate.items()}


def quantized_eval_apply(eval_net: Any, qstate: Mapping[str, Any]) -> Callable[..., Any]:
    """``(image, *decoder_inputs) -> decoder outputs`` over int8 weights.

    ``eval_net`` is the port's ``EvalNet``. Its net's quantized parameters are
    replaced in place by tensors on the meta device, so that the only copy of
    those weights is ``qstate``'s int8 one, on the net's device; every call
    dequantizes them into a float state that ``torch.func.functional_call``
    binds for that forward alone. The callable's ``quantized`` attribute holds
    those int8 tensors, by state key.
    """
    net = eval_net.net
    device = next(t.device for t in net.state_dict().values() if t.device.type != "meta")
    quantized = {k: QTensor(v.q.to(device), v.scale.to(device), v.groups)
                 for k, v in qstate.items() if isinstance(v, QTensor)}
    for key in quantized:
        module_name, _, leaf = key.rpartition(".")
        module = net.get_submodule(module_name)
        old = getattr(module, leaf)
        setattr(module, leaf, nn.Parameter(torch.empty_like(old, device="meta"),
                                           requires_grad=False))

    def apply(*inputs: torch.Tensor) -> Any:
        weights = {k: _dequantize(v, torch.float32) for k, v in quantized.items()}
        x = torch.func.functional_call(net, weights, (inputs[0],))
        result = eval_net.decoder(x, *inputs[1:])
        return (result, x) if eval_net.output_raw else result

    apply.quantized = quantized
    return apply


def quantized_bytes(qstate: Mapping[str, Any]) -> Tuple[int, int]:
    """(quantized bytes, float32 bytes of the same weights) over the quantized
    entries: the weight traffic that int8 saves, as JAX counts it."""
    qb = fb = 0
    for v in qstate.values():
        if isinstance(v, QTensor):
            qb += v.q.numel() + v.scale.numel() * 4
            fb += v.q.numel() * 4
    return qb, fb
