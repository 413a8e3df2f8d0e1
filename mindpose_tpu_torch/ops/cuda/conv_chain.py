"""Chain of 3x3 convs + ReLU on NHWC activations: the Hopper kernel and its plain version.

Replaces the TPU kernel ``mindpose_tpu/ops/pallas/conv_chain.py:fused_conv_chain``
(body ``_chain_kernel``), a measurement probe of whether keeping a chain of
C=32 convs on chip beats the library convolutions
(``tools/ablate_conv_chain.py`` asks the same of this kernel against cuDNN).
The kernel is ``csrc/conv_chain.cu``, built by nvcc at first use and bound
through ctypes; its source note gives its bound and design. The Pallas
version's ``strip`` (rows per MXU block) and its ``H % strip`` check have no
counterpart: the CUDA kernel tiles any height and width.

``fused_conv_chain`` dispatches on the activations' device: a CPU tensor goes
to the plain PyTorch version; a CUDA tensor launches the kernel, or raises.
There is no fallback from the kernel to the plain version.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

__all__ = ["fused_conv_chain", "conv_chain_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def conv_chain_plain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Counterpart of the JAX package's ``xla_conv_chain``, in ``x.dtype``.

    Per layer ``F.conv2d(padding=1)`` on the NCHW view of NHWC ``x``, then
    ReLU. x [B, H, W, C]; weights [L, 3, 3, C, C] HWIO. Returns [B, H, W, C].
    """
    y = x.permute(0, 3, 1, 2)
    for layer in range(weights.shape[0]):
        y = torch.relu(F.conv2d(y, weights[layer].permute(3, 2, 0, 1), padding=1))
    return y.permute(0, 2, 3, 1).contiguous()


@functools.cache
def _library():
    lib = load_library("conv_chain").lib
    lib.mp_fused_conv_chain.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.mp_fused_conv_chain.restype = ctypes.c_int
    lib.mp_conv_chain_smem_bytes.argtypes = [ctypes.c_int]
    lib.mp_conv_chain_smem_bytes.restype = ctypes.c_longlong
    return lib


def fused_conv_chain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """L x (3x3 SAME conv, stride 1, no bias, ReLU) over NHWC activations.

    x: [B, H, W, C], float32 or bfloat16, contiguous; weights: [L, 3, 3, C, C]
    HWIO of the same dtype and device, contiguous, L >= 1. Each layer sums in
    float32 and rounds to ``x.dtype`` after its ReLU. Returns [B, H, W, C] in
    ``x.dtype``. ``fused_conv_chain.launches`` counts the kernel's launches
    (one per call, however many layers).
    """
    if x.dim() != 4 or weights.dim() != 5:
        raise ValueError(f"want x [B, H, W, C] and weights [L, 3, 3, C, C], got "
                         f"{tuple(x.shape)} and {tuple(weights.shape)}")
    b, h, w, c = x.shape
    depth = weights.shape[0]
    if tuple(weights.shape[1:]) != (3, 3, c, c) or depth < 1:
        raise ValueError(f"weights {tuple(weights.shape)} do not fit x {tuple(x.shape)}: "
                         f"want [L >= 1, 3, 3, {c}, {c}]")
    if x.dtype not in _DTYPES or weights.dtype != x.dtype:
        raise ValueError(f"want float32 or bfloat16 x and weights of one dtype, got "
                         f"{x.dtype} and {weights.dtype}")
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("x and weights must be contiguous")
    if weights.device != x.device:
        raise ValueError(f"x is on {x.device} but weights are on {weights.device}")
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"no conv chain for device {x.device}")
    if x.numel() >= 2**31 or b >= 2**16:
        raise ValueError(f"x too large for the kernel's grid and indices: {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    smem = lib.mp_conv_chain_smem_bytes(c)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c} needs {smem} B of shared memory per block, over {_MAX_SMEM}")
    scratch = torch.empty_like(x) if depth > 1 else out
    with torch.cuda.device(x.device):
        err = lib.mp_fused_conv_chain(
            _DTYPES[x.dtype], x.data_ptr(), weights.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), b, h, w, c, depth, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv chain kernel launch failed with CUDA error {err}")
    fused_conv_chain.launches += 1
    return out


fused_conv_chain.launches = 0
