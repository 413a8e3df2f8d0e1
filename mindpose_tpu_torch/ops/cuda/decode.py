"""Fused heatmap argmax + quarter-pixel shift: the Hopper kernel and its plain version.

Replaces the TPU kernel ``mindpose_tpu/ops/pallas/decode.py:argmax_shift_decode``
(body ``_decode_kernel``). The kernel is ``csrc/decode.cu``, built by nvcc at
first use and bound through ctypes; its source note gives its bound and design.

``argmax_shift_decode`` dispatches on the heatmap's device: a CPU tensor goes
to the plain PyTorch version (``argmax_coords`` + ``quarter_offset``); a CUDA
tensor launches the kernel, or raises. There is no fallback from the kernel to
the plain version.
"""
import ctypes
import functools
from typing import Tuple

import torch

from ..heatmap import argmax_coords, quarter_offset
from .build import load_library

__all__ = ["argmax_shift_decode", "argmax_shift_decode_plain"]


def argmax_shift_decode_plain(
    heatmap: torch.Tensor, shift: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode of an NCHW heatmap: coords [N, K, 2], maxvals [N, K]."""
    coords, maxvals, idx = argmax_coords(heatmap)
    if shift:
        coords = quarter_offset(heatmap, coords, idx)
    return coords, maxvals


@functools.cache
def _kernel():
    fn = load_library("decode").lib.mp_argmax_shift_decode
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def argmax_shift_decode(
    heatmap: torch.Tensor, shift: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode an NCHW float32 heatmap [N, K, H, W].

    Returns coords [N, K, 2] (x, y, with the quarter-pixel shift when
    ``shift``) and maxvals [N, K]. ``argmax_shift_decode.launches`` counts
    the kernel's launches.
    """
    if heatmap.dim() != 4 or heatmap.dtype != torch.float32:
        raise ValueError(
            f"want a float32 [N, K, H, W] heatmap, got {heatmap.dtype} {tuple(heatmap.shape)}")
    n, k, h, w = heatmap.shape
    if h * w == 0:
        raise ValueError(f"heatmap rows are empty: {tuple(heatmap.shape)}")
    if heatmap.device.type == "cpu":
        return argmax_shift_decode_plain(heatmap, shift)
    if heatmap.device.type != "cuda":
        raise ValueError(f"no decode for device {heatmap.device}")
    if not heatmap.is_contiguous():
        raise ValueError("the decode kernel needs a contiguous NCHW heatmap")
    if n * k >= 2**31 or h * w >= 2**31:
        raise ValueError(f"heatmap too large for the kernel's int indices: {tuple(heatmap.shape)}")
    coords = torch.empty((n, k, 2), dtype=torch.float32, device=heatmap.device)
    maxvals = torch.empty((n, k), dtype=torch.float32, device=heatmap.device)
    if n * k == 0:
        return coords, maxvals
    with torch.cuda.device(heatmap.device):
        err = _kernel()(
            heatmap.data_ptr(), coords.data_ptr(), maxvals.data_ptr(),
            n * k, h, w, int(bool(shift)), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"decode kernel launch failed with CUDA error {err}")
    argmax_shift_decode.launches += 1
    return coords, maxvals


argmax_shift_decode.launches = 0
