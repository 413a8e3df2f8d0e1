"""ctypes bridge to the host C++ evaluation kernels (``csrc/coco_native.cpp``).

Copy of ``mindpose_tpu/utils/native.py``: the OKS row of ``COCOeval``
(``compute_oks_row``), the pairwise OKS of OKS-NMS (``oks_iou_pairs``) and
RLE expansion (``decode_rle_native``), the host hot loops of evaluation, with
the same ``argtypes``. ``csrc/coco_native.cpp`` is a byte-for-byte copy of
the JAX package's source, built at first use with the JAX package's ``g++``
flags into ``build/mindpose_tpu_torch/`` (``ops/cuda/build.load_host_library``).

One difference: where the JAX package cannot build or load the library, it
logs and takes the numpy path. Here an enabled library that cannot build or
load raises with the compiler's output. The numpy paths run only when the
caller asks for them, with ``set_native_enabled(False)`` or
``MINDPOSE_NATIVE=0``; then each function returns None and its caller
computes the same numbers in numpy. tests/test_torch_native.py holds the
library bit for bit to the JAX package's and within 1e-9 of the numpy paths.
"""
import ctypes
import functools
import os
from typing import Optional

import numpy as np

from ..ops.cuda.build import load_host_library

__all__ = ["get_native", "native_available", "set_native_enabled", "compute_oks_row",
           "oks_iou_pairs", "decode_rle_native"]

SOURCE = "coco_native"
# MINDPOSE_NATIVE=0 selects the numpy paths (also used by the
# native-vs-numpy parity tests)
_enabled = os.environ.get("MINDPOSE_NATIVE", "1") != "0"


def set_native_enabled(flag: bool) -> None:
    """Turn the native path on or off at run time (the numpy paths when off)."""
    global _enabled
    _enabled = bool(flag)


@functools.cache
def _configured() -> ctypes.CDLL:
    lib = load_host_library(SOURCE).lib
    dp = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)

    lib.compute_oks_row.argtypes = [
        dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, dp, dp, dp,
    ]
    lib.compute_oks_row.restype = None
    lib.oks_iou_pairs.argtypes = [
        dp, dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, dp, dp,
        ctypes.c_double, dp,
    ]
    lib.oks_iou_pairs.restype = None
    lib.decode_rle.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p,
    ]
    lib.decode_rle.restype = ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library when enabled (built at first use; raises if it cannot
    build or load), None when the numpy paths were asked for."""
    if not _enabled:
        return None
    return _configured()


def native_available() -> bool:
    return _load() is not None


def get_native() -> Optional[ctypes.CDLL]:
    return _load()


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def compute_oks_row(
    gt: np.ndarray,
    dts: np.ndarray,
    gt_area: float,
    gt_bbox: Optional[np.ndarray],
    variances: np.ndarray,
) -> Optional[np.ndarray]:
    """Native OKS of one gt vs [D, K*3] detections; None when disabled."""
    lib = _load()
    if lib is None:
        return None
    gt = np.ascontiguousarray(gt, np.float64)
    dts = np.ascontiguousarray(dts, np.float64)
    variances = np.ascontiguousarray(variances, np.float64)
    num_kpts = len(variances)
    out = np.empty(len(dts), np.float64)
    bbox_ptr = (
        _dp(np.ascontiguousarray(gt_bbox, np.float64))
        if gt_bbox is not None
        else ctypes.POINTER(ctypes.c_double)()
    )
    lib.compute_oks_row(
        _dp(gt), _dp(dts), len(dts), num_kpts, float(gt_area), bbox_ptr,
        _dp(variances), _dp(out),
    )
    return out


def oks_iou_pairs(
    g: np.ndarray,
    d: np.ndarray,
    a_g: float,
    a_d: np.ndarray,
    variances: np.ndarray,
    vis_thr: Optional[float],
) -> Optional[np.ndarray]:
    """Native OKS of one instance vs [N, K*3] instances; None when disabled."""
    lib = _load()
    if lib is None:
        return None
    g = np.ascontiguousarray(g, np.float64)
    d = np.ascontiguousarray(d, np.float64)
    a_d = np.ascontiguousarray(a_d, np.float64)
    variances = np.ascontiguousarray(variances, np.float64)
    out = np.empty(len(d), np.float64)
    lib.oks_iou_pairs(
        _dp(g), _dp(d), len(d), len(variances), float(a_g), _dp(a_d),
        _dp(variances), -1.0 if vis_thr is None else float(vis_thr), _dp(out),
    )
    return out


def decode_rle_native(counts: np.ndarray, h: int, w: int) -> Optional[np.ndarray]:
    """Native RLE expansion into an HxW uint8 mask; None when disabled."""
    lib = _load()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, np.int64)
    out = np.zeros(h * w, np.uint8)
    rc = lib.decode_rle(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(counts), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise ValueError(f"RLE counts sum != h*w ({h}x{w})")
    return out.reshape(h, w)
