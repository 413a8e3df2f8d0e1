"""Tag grouping: the Hopper kernel of the fixed-capacity matcher.

Replaces ``mindpose_tpu/ops/grouping.py:match_by_tag_device`` (and its
``match_by_tag_batch``), which the JAX package runs under jit on an
accelerator; no Pallas kernel. The kernel is ``csrc/grouping.cu``, built by
nvcc at first use and bound through ctypes; its source note gives its bound
and design. Its plain version is ``ops/grouping.py`` (numpy on the host),
which it equals bit for bit.

``match_by_tag_batch`` takes CUDA tensors and launches the kernel once per
batch; it raises on a CPU tensor, and on sizes beyond the kernel's largest
column bound (G + M + 1 <= 256), and the caller that groups on the CPU
calls the plain version itself. ``match_by_tag_batch.launches`` counts the
launches.

``step_floor`` launches the probe of the kernel's bound: one warp running
the least chain of dependent steps that one LSAP iteration runs. Its time
per step, times an image's iteration count (``ops/grouping.py``'s
``match_by_tag_batch.steps``), is the least time the kernel could take.
"""
import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .build import load_library

__all__ = ["match_by_tag_batch", "step_floor"]

_MAX_JOINTS = 64  # the kernel's joint_order capacity (kMaxJoints)
_MAX_COLUMNS = 256  # the largest compiled bound on the LSAP's columns, G + M + 1
# flags of mp_match_by_tag (csrc/grouping.cu)
_ROUNDED_NORM, _IGNORE_TOO_MUCH = 1, 2


@functools.cache
def _library():
    lib = load_library("grouping").lib
    lib.mp_match_by_tag.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.mp_match_by_tag.restype = ctypes.c_int
    lib.mp_grouping_step_floor.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.mp_grouping_step_floor.restype = ctypes.c_int
    return lib


def match_by_tag_batch(
    val_k: torch.Tensor,
    tag_k: torch.Tensor,
    ind_k: torch.Tensor,
    joint_order: Sequence[int],
    vis_thr: float = 0.1,
    tag_thr: float = 1.0,
    use_rounded_norm: bool = True,
    ignore_too_much: bool = False,
    group_cap: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group a batch's per-joint top-K candidates into instances, in one launch.

    Inputs: val_k [N, K, M], tag_k [N, K, M, L], ind_k [N, K, M, 2], float32,
    contiguous, on one CUDA device. ``group_cap`` is the capacity G (0 -> M).
    Returns groups [N, G, K, 3 + L] float32 (x, y, score, tags) and valid
    [N, G] bool, on the device, as ``ops/grouping.match_by_tag_batch``.
    """
    if val_k.dim() != 3 or tag_k.dim() != 4 or ind_k.dim() != 4:
        raise ValueError(f"want val_k [N, K, M], tag_k [N, K, M, L], ind_k [N, K, M, 2], got "
                         f"{tuple(val_k.shape)}, {tuple(tag_k.shape)}, {tuple(ind_k.shape)}")
    n, k, m = val_k.shape
    l = tag_k.shape[3]
    if tuple(tag_k.shape[:3]) != (n, k, m) or tuple(ind_k.shape) != (n, k, m, 2) or l < 1:
        raise ValueError(f"shapes disagree: val_k {tuple(val_k.shape)}, tag_k "
                         f"{tuple(tag_k.shape)}, ind_k {tuple(ind_k.shape)}")
    g = int(group_cap) if group_cap else m
    if m < 1 or g < 1:
        raise ValueError(f"need candidates and groups: M={m}, G={g}")
    if g + m + 1 > _MAX_COLUMNS:
        raise ValueError(f"the grouping kernel takes G + M + 1 <= {_MAX_COLUMNS} columns, got "
                         f"G={g}, M={m}")
    for name, t in (("val_k", val_k), ("tag_k", tag_k), ("ind_k", ind_k)):
        if t.device.type != "cuda":
            raise ValueError(f"the grouping kernel takes CUDA tensors, and {name} is on "
                             f"{t.device}; on the CPU call ops/grouping.match_by_tag_batch")
        if t.device != val_k.device:
            raise ValueError(f"{name} is on {t.device}, val_k on {val_k.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"the grouping kernel needs a contiguous float32 {name}, got "
                             f"{t.dtype}")
    order = [int(j) for j in joint_order]
    if len(order) > _MAX_JOINTS or any(not 0 <= j < k for j in order):
        raise ValueError(f"joint_order must hold at most {_MAX_JOINTS} indices below {k}: "
                         f"{order}")
    groups = torch.empty((n, g, k, 3 + l), dtype=torch.float32, device=val_k.device)
    valid = torch.empty((n, g), dtype=torch.bool, device=val_k.device)
    if n == 0:
        return groups, valid
    flags = (_ROUNDED_NORM if use_rounded_norm else 0) | (_IGNORE_TOO_MUCH if ignore_too_much
                                                         else 0)
    with torch.cuda.device(val_k.device):
        err = _library().mp_match_by_tag(
            val_k.data_ptr(), tag_k.data_ptr(), ind_k.data_ptr(), groups.data_ptr(),
            valid.data_ptr(), n, k, m, l, g, (ctypes.c_int * max(len(order), 1))(*order),
            len(order), vis_thr, tag_thr, flags, torch.cuda.current_stream().cuda_stream)
    if err != 0:  # sizes whose state exceeds a block's shared memory fail here too
        raise RuntimeError(f"grouping kernel launch failed with CUDA error {err}")
    match_by_tag_batch.launches += 1
    return groups, valid


match_by_tag_batch.launches = 0


def step_floor(out: torch.Tensor, steps: int) -> None:
    """Launch the bound's probe: one warp, ``steps`` dependent links of a
    shared-memory load, a warp min, a ballot and a shuffle. ``out`` is an
    int32 CUDA tensor of 32 entries, which the probe writes."""
    if out.device.type != "cuda" or out.dtype != torch.int32 or out.numel() != 32:
        raise ValueError(f"the step-floor probe writes 32 int32 on a CUDA device, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    with torch.cuda.device(out.device):
        err = _library().mp_grouping_step_floor(int(steps), out.data_ptr(),
                                                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"step-floor probe launch failed with CUDA error {err}")
    step_floor.launches += 1


step_floor.launches = 0
