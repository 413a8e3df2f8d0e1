"""Heatmap decode: the Hopper kernel and its plain versions, as two PyTorch ops.

Replaces the TPU kernel ``mindpose_tpu/ops/pallas/decode.py:argmax_shift_decode``
(body ``_decode_kernel``). The kernel is ``csrc/decode.cu``, built by nvcc at
first use and bound through ctypes; its source note gives its bound and design.
Two wrappers launch it:

- ``argmax_shift_decode``: per (crop, joint) row the first argmax with the
  optional quarter-pixel shift, and the maximum;
- ``decode_heatmap``: the whole top-down decoder, those coordinates mapped
  back to the original frame, with the boxes row: one launch per chunk.

Each wrapper checks its inputs and calls a ``torch.library`` custom op
(``mindpose::argmax_shift_decode``, ``mindpose::decode_heatmap``), so that
``torch.export`` captures the decode as one node of the exported program
(``engine/export.py``). Each op has a fake implementation (the output
shapes, for tracing with a symbolic batch), a CPU implementation, which is
the plain PyTorch version, and a CUDA implementation, which launches the
kernel or raises. There is no fallback from the kernel to the plain
version. Importing this module registers the ops, and a loaded exported
program needs them registered. ``argmax_shift_decode.launches`` counts the
kernel's launches through either op, from eager code and from an exported
program alike.
"""
import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..heatmap import argmax_coords, quarter_offset
from .build import load_library

__all__ = [
    "argmax_shift_decode",
    "argmax_shift_decode_plain",
    "decode_heatmap",
    "decode_heatmap_plain",
    "preds_and_boxes",
]

# flags of mp_heatmap_decode (csrc/decode.cu)
_SHIFT, _TO_ORIGINAL, _USE_UDP, _VECTOR = 1, 2, 4, 8
_MAX_ROW = 2**30  # the kernel's int indices


def argmax_shift_decode_plain(
    heatmap: torch.Tensor, shift: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode of an NCHW heatmap: coords [N, K, 2], maxvals [N, K]."""
    coords, maxvals, idx = argmax_coords(heatmap)
    if shift:
        coords = quarter_offset(heatmap, coords, idx)
    return coords, maxvals


def _transform_preds(
    coords: torch.Tensor,
    center: torch.Tensor,
    scale: torch.Tensor,
    heatmap_hw: Tuple[int, int],
    use_udp: bool,
    pixel_std: float,
) -> torch.Tensor:
    """Map heatmap coords back to the raw-image frame."""
    h, w = heatmap_hw
    scale = scale * pixel_std
    if use_udp:
        scale_x = scale[:, 0:1] / (w - 1.0)
        scale_y = scale[:, 1:2] / (h - 1.0)
    else:
        scale_x = scale[:, 0:1] / w
        scale_y = scale[:, 1:2] / h
    x = coords[..., 0] * scale_x + center[:, 0:1] - scale[:, 0:1] * 0.5
    y = coords[..., 1] * scale_y + center[:, 1:2] - scale[:, 1:2] * 0.5
    return torch.stack([x, y], dim=-1)


def decode_heatmap_plain(
    heatmap: torch.Tensor,
    center: torch.Tensor,
    scale: torch.Tensor,
    score: torch.Tensor,
    *,
    shift: bool,
    to_original: bool,
    use_udp: bool,
    pixel_std: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch top-down decode: preds [N, K, 3], boxes [N, 6].

    The decoder's composition of small ops. On the card each op is its own
    kernel and rounds on its own, and ``scale / w`` multiplies by the float
    reciprocal of ``w``; the kernel matches that bit for bit.
    """
    coords, maxvals = argmax_shift_decode_plain(heatmap, shift)
    return preds_and_boxes(coords, maxvals, heatmap.shape[2:4], center, scale, score,
                           to_original=to_original, use_udp=use_udp, pixel_std=pixel_std)


def preds_and_boxes(
    coords: torch.Tensor,
    maxvals: torch.Tensor,
    heatmap_hw: Tuple[int, int],
    center: torch.Tensor,
    scale: torch.Tensor,
    score: torch.Tensor,
    *,
    to_original: bool,
    use_udp: bool,
    pixel_std: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder's last part in plain PyTorch: heatmap coords [N, K, 2] and
    maxvals [N, K] -> preds [N, K, 3] (in the original frame when
    ``to_original``) and boxes [N, 6]."""
    if to_original:
        coords = _transform_preds(coords, center, scale, heatmap_hw, use_udp, pixel_std)
    preds = torch.cat([coords[..., :2], maxvals[..., None]], dim=-1)
    area = torch.prod(scale * pixel_std, dim=1)
    boxes = torch.cat([center, scale, area[:, None], score[:, None]], dim=1)
    return preds, boxes


@functools.cache
def _kernel():
    fn = load_library("decode").lib.mp_heatmap_decode
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_heatmap(heatmap: torch.Tensor) -> None:
    if heatmap.dim() != 4 or heatmap.dtype != torch.float32:
        raise ValueError(
            f"want a float32 [N, K, H, W] heatmap, got {heatmap.dtype} {tuple(heatmap.shape)}")
    if heatmap.shape[2] * heatmap.shape[3] == 0:
        raise ValueError(f"heatmap rows are empty: {tuple(heatmap.shape)}")
    if heatmap.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode for device {heatmap.device}")


def _launch(
    heatmap: torch.Tensor,
    flags: int,
    xy: torch.Tensor,
    xy_stride: int,
    maxvals_ptr: int,
    maxvals_stride: int,
    crop_inputs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    boxes: Optional[torch.Tensor] = None,
    pixel_std: float = 0.0,
) -> None:
    """Launch the kernel on a contiguous CUDA heatmap with N * K > 0."""
    n, k, h, w = heatmap.shape
    if not heatmap.is_contiguous():
        raise ValueError("the decode kernel needs a contiguous NCHW heatmap")
    if n * k >= 2**31 or h * w >= _MAX_ROW:
        raise ValueError(f"heatmap too large for the kernel's int indices: {tuple(heatmap.shape)}")
    if heatmap.data_ptr() % 16 == 0 and (h * w) % 4 == 0:
        flags |= _VECTOR
    center, scale, score = (t.data_ptr() for t in crop_inputs) if crop_inputs else (None,) * 3
    with torch.cuda.device(heatmap.device):
        err = _kernel()(
            heatmap.data_ptr(), center, scale, score, xy.data_ptr(), xy_stride, maxvals_ptr,
            maxvals_stride, None if boxes is None else boxes.data_ptr(), n, k, h, w, flags,
            pixel_std, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed with CUDA error {err}")
    argmax_shift_decode.launches += 1


@torch.library.custom_op("mindpose::argmax_shift_decode", mutates_args=(),
                         device_types="cpu")
def _argmax_shift_decode_op(heatmap: torch.Tensor, shift: bool) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
    return argmax_shift_decode_plain(heatmap, shift)


@_argmax_shift_decode_op.register_kernel("cuda")
def _argmax_shift_decode_cuda(heatmap: torch.Tensor,
                              shift: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    n, k = heatmap.shape[:2]
    coords = torch.empty((n, k, 2), dtype=torch.float32, device=heatmap.device)
    maxvals = torch.empty((n, k), dtype=torch.float32, device=heatmap.device)
    if n * k > 0:
        _launch(heatmap, _SHIFT if shift else 0, coords, 2, maxvals.data_ptr(), 1)
    return coords, maxvals


@_argmax_shift_decode_op.register_fake
def _argmax_shift_decode_fake(heatmap: torch.Tensor,
                              shift: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    n, k = heatmap.shape[:2]
    return heatmap.new_empty((n, k, 2)), heatmap.new_empty((n, k))


@torch.library.custom_op("mindpose::decode_heatmap", mutates_args=(), device_types="cpu")
def _decode_heatmap_op(heatmap: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                       score: torch.Tensor, shift: bool, to_original: bool, use_udp: bool,
                       pixel_std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return decode_heatmap_plain(heatmap, center, scale, score, shift=shift,
                                to_original=to_original, use_udp=use_udp, pixel_std=pixel_std)


@_decode_heatmap_op.register_kernel("cuda")
def _decode_heatmap_cuda(heatmap: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                         score: torch.Tensor, shift: bool, to_original: bool, use_udp: bool,
                         pixel_std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    n, k = heatmap.shape[:2]
    if k == 0 and n > 0:
        raise ValueError("the decode kernel writes each crop's boxes row from its first joint, "
                         "and the heatmap has no joints")
    preds = torch.empty((n, k, 3), dtype=torch.float32, device=heatmap.device)
    boxes = torch.empty((n, 6), dtype=torch.float32, device=heatmap.device)
    if n > 0:
        flags = (_SHIFT if shift else 0) | (_TO_ORIGINAL if to_original else 0) | (
            _USE_UDP if use_udp else 0)
        # maxvals go to preds[..., 2], 8 bytes after each row's x
        _launch(heatmap, flags, preds, 3, preds.data_ptr() + 8, 3, (center, scale, score),
                boxes, float(pixel_std))
    return preds, boxes


@_decode_heatmap_op.register_fake
def _decode_heatmap_fake(heatmap: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                         score: torch.Tensor, shift: bool, to_original: bool, use_udp: bool,
                         pixel_std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    n, k = heatmap.shape[:2]
    return heatmap.new_empty((n, k, 3)), heatmap.new_empty((n, 6))


def argmax_shift_decode(
    heatmap: torch.Tensor, shift: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode an NCHW float32 heatmap [N, K, H, W].

    Returns coords [N, K, 2] (x, y, with the quarter-pixel shift when
    ``shift``) and maxvals [N, K]. ``argmax_shift_decode.launches`` counts
    the kernel's launches.
    """
    _check_heatmap(heatmap)
    return torch.ops.mindpose.argmax_shift_decode(heatmap, shift)


def decode_heatmap(
    heatmap: torch.Tensor,
    center: torch.Tensor,
    scale: torch.Tensor,
    score: torch.Tensor,
    *,
    shift: bool,
    to_original: bool,
    use_udp: bool,
    pixel_std: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-down decoder of NCHW float32 heatmaps, in one kernel launch on the card.

    Inputs: heatmap [N, K, H, W]; center [N, 2]; scale [N, 2]; score [N];
    all float32, contiguous, on one device. Returns preds [N, K, 3] (x, y,
    maxval; x and y in the original frame when ``to_original``) and boxes
    [N, 6] (cx, cy, sx, sy, area, score), as ``decode_heatmap_plain``.
    """
    _check_heatmap(heatmap)
    n = heatmap.shape[0]
    for name, t, shape in (("center", center, (n, 2)), ("scale", scale, (n, 2)),
                           ("score", score, (n,))):
        if t.device != heatmap.device:
            raise ValueError(f"{name} is on {t.device}, the heatmap on {heatmap.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"want a float32 {name} of shape {list(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("heatmap", heatmap), ("center", center), ("scale", scale), ("score", score)):
        if not t.is_contiguous():
            raise ValueError(f"the decode needs a contiguous {name}")
    return torch.ops.mindpose.decode_heatmap(heatmap, center, scale, score, shift, to_original,
                                             use_udp, float(pixel_std))


argmax_shift_decode.launches = 0
