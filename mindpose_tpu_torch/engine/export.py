"""Serving export: the port's EvalNet -> a serialized ``torch.export`` program.

Counterpart of ``mindpose_tpu/engine/export.py``, which lowers an EvalNet to
a StableHLO artifact with ``jax.export``. Here the artifact is
``torch.export.save`` of ``torch.export.export``: the eval-mode net and its
decoder as one graph, the weights baked in as the program's state, the
batch dimension symbolic unless pinned. The top-down heatmap decode is a
``torch.library`` op (``mindpose::decode_heatmap``, or
``mindpose::argmax_shift_decode`` before the DARK refinement), so on a CUDA
device every call of the artifact launches the hand-written decode kernel
once.

Serving needs no config, checkpoint or net code: ``load_serving_fn`` gives
a callable from the bytes alone. It imports one module of the port,
``mindpose_tpu_torch.ops.cuda.decode``, which registers the decode ops that
the program calls. ``torch.export`` has no counterpart of ``jax.export``'s
``platforms``: an artifact serves on the device it was exported on, where
its weights live.

The artifact takes what the port's ``EvalNet`` takes, NCHW: ``image`` [b, 3,
H, W] float32, the normalized crops (``TopDownPredictor.preprocess``'s
layout), then the decoder's inputs, by default ``center`` [b, 2], ``scale``
[b, 2] and ``score`` [b], float32. It returns the decoder's outputs (the
top-down decoders: ``(preds [b, K, 3], boxes [b, 6])``), and with
``output_raw`` the head's outputs after them.
"""
import io
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

__all__ = ["ServingModule", "export_serving_fn", "export_eval_net", "load_serving_fn",
           "save_program", "trace_eval_net", "trace_serving_fn"]

_EXAMPLE_BATCH = 2  # torch.export specializes dims of size 0 and 1
# on the card PyTorch runs an eval-mode BatchNorm through cuDNN for at most
# 65535 crops a call, and the trace keeps that branch: the symbolic batch's range
_MAX_BATCH = 65535


class ServingModule(nn.Module):
    """``forward(image, *decoder_inputs)``: what ``EvalNet.__call__`` computes,
    as a module that ``torch.export`` traces. ``EvalNet``'s call runs in
    ``torch.inference_mode``, which makes inference tensors, so the export
    traces this module instead. With ``autocast_dtype`` the net runs under
    ``torch.autocast`` of that type, as the inferencer runs O1-O3; the decoder
    casts to float32 itself."""

    def __init__(self, net: nn.Module, decoder: Any, output_raw: bool = False,
                 autocast_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.net = net.eval()
        self.decoder = decoder
        self.output_raw = output_raw
        self.autocast_dtype = autocast_dtype

    def forward(self, image: torch.Tensor, *decoder_inputs: torch.Tensor) -> Any:
        if self.autocast_dtype is None:
            x = self.net(image)
        else:
            with torch.autocast(image.device.type, dtype=self.autocast_dtype):
                x = self.net(image)
        result = self.decoder(x, *decoder_inputs)
        return (result, x) if self.output_raw else result


def trace_serving_fn(
    module: nn.Module,
    example_inputs: Sequence[torch.Tensor],
    dynamic_shapes: Optional[Sequence[Any]] = None,
) -> torch.export.ExportedProgram:
    """``torch.export`` of ``module(*example_inputs)``, before it is serialized.

    Args:
        module: the function to serve, as a module (``torch.export`` traces
            modules; JAX's ``fn``); the tensors it holds (its weights) are
            baked into the program.
        example_inputs: one tensor per argument, on the device to serve on.
        dynamic_shapes: ``torch.export``'s per-argument specs (for a symbolic
            batch, see :func:`export_eval_net`); None traces static shapes.
    """
    with torch.no_grad():
        return torch.export.export(module, tuple(example_inputs), dynamic_shapes=dynamic_shapes)


def save_program(program: torch.export.ExportedProgram) -> bytes:
    """``torch.export.save`` of ``program`` into bytes."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_serving_fn(
    module: nn.Module,
    example_inputs: Sequence[torch.Tensor],
    dynamic_shapes: Optional[Sequence[Any]] = None,
) -> bytes:
    """Trace ``module(*example_inputs)`` with ``torch.export`` and serialize it
    (the arguments as :func:`trace_serving_fn`'s)."""
    return save_program(trace_serving_fn(module, example_inputs, dynamic_shapes))


def trace_eval_net(
    eval_net: Any,
    image_hw: Tuple[int, int],
    batch: Union[str, int] = "b",
    extra_specs: Optional[Sequence[torch.Tensor]] = None,
    amp_level: str = "O0",
) -> torch.export.ExportedProgram:
    """:func:`export_eval_net`'s program, before it is serialized."""
    net = eval_net.net
    device = next(net.parameters()).device
    symbolic = isinstance(batch, str)
    n = _EXAMPLE_BATCH if symbolic else int(batch)
    h, w = int(image_hw[0]), int(image_hw[1])
    if extra_specs is None:
        extras = [torch.zeros(n, 2), torch.ones(n, 2), torch.ones(n)]
    else:
        extras = [torch.zeros((n,) + tuple(s.shape[1:]), dtype=s.dtype) for s in extra_specs]
    inputs = [t.to(device) for t in [torch.zeros(n, 3, h, w)] + extras]
    dynamic_shapes = None
    if symbolic:
        dim = torch.export.Dim(batch, min=1, max=_MAX_BATCH)
        dynamic_shapes = ({0: dim}, tuple({0: dim} for _ in extras))
    module = ServingModule(net, eval_net.decoder, eval_net.output_raw,
                           None if amp_level == "O0" else torch.bfloat16)
    return trace_serving_fn(module, inputs, dynamic_shapes)


def export_eval_net(
    eval_net: Any,
    image_hw: Tuple[int, int],
    batch: Union[str, int] = "b",
    extra_specs: Optional[Sequence[torch.Tensor]] = None,
    amp_level: str = "O0",
) -> bytes:
    """Export an EvalNet (forward + decode) with its weights baked in.

    Args:
        eval_net: the port's ``EvalNet``; its net's weights are baked into
            the artifact, on the device they lie on.
        image_hw: static input (H, W).
        batch: a symbolic dim name (default ``"b"``: any batch of 1 to
            65535) or an int to pin a static batch.
        extra_specs: example tensors of the decoder's inputs after the image;
            their first dim is the batch, replaced by ``batch``. Default: the
            top-down decoders' (center [b, 2], scale [b, 2], score [b]).
        amp_level: "O0" exports float32; O1-O3 run the net under bf16
            autocast, as the inferencer runs them.
    """
    return save_program(trace_eval_net(eval_net, image_hw, batch, extra_specs, amp_level))


def load_serving_fn(data: bytes) -> Callable[..., Any]:
    """Deserialize an exported artifact; returns a callable ``f(*tensors)``.

    The decode ops are registered first (the one module of the port that a
    program needs). Each call runs without autograd and, on a CUDA device,
    with TF32 off for cuDNN and CUDA matmuls, as ``TopDownPredictor`` serves
    float32.
    """
    from ..ops.cuda import decode  # noqa: F401  (registers mindpose::* ops)

    module = torch.export.load(io.BytesIO(data)).module()

    def serve(*inputs: torch.Tensor) -> Any:
        if any(t.device.type == "cuda" for t in inputs):
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            return module(*inputs)

    return serve
