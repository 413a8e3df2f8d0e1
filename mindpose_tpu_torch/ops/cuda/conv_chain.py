"""Chain of 3x3 convs + ReLU on NHWC activations: the Hopper kernels and their plain version.

Replaces the TPU kernel ``mindpose_tpu/ops/pallas/conv_chain.py:fused_conv_chain``
(body ``_chain_kernel``), a measurement probe of whether keeping a chain of
C=32 convs on chip beats the library convolutions
(``tools/ablate_pallas_chain.py`` asks the same of this kernel against cuDNN).
The kernels are in ``csrc/conv_chain.cu``, built by nvcc at first use and
bound through ctypes; its source note gives their bounds and design. The
Pallas version's ``strip`` (rows per MXU block) and its ``H % strip`` check
have no counterpart: the CUDA kernels tile any height and width.

Routes, by dtype alone (``conv_chain_route``), one kernel each:
- bfloat16 with 1 <= C <= 64: the tensor-core kernel (``mma.sync`` implicit
  GEMM, TMA loads and stores), ``FUSED_LAYERS`` layers per launch; the
  kernel can fuse more on chip, which measured slower. A wider bf16 chain
  raises ``ValueError``;
- float32: the CUDA-core kernel, one layer per launch. On the tensor cores
  float32 would run as TF32, a different result.

``fused_conv_chain`` dispatches on the activations' device: a CPU tensor goes
to the plain PyTorch version; a CUDA tensor launches its route's kernel, or
raises. There is no fallback from one kernel to the other or to the plain
version.
"""
import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import load_library

__all__ = [
    "fused_conv_chain", "conv_chain_plain", "conv_chain_route", "split_layers", "smem_bytes",
    "FUSED_LAYERS",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448
_MAX_TC_CHANNELS = 64
# Layers the tensor-core kernel runs per launch: the best of g in {1, 2, 4}
# at each of the probe's three geometries on an H100 (PERF.md, Findings).
FUSED_LAYERS = 1


def conv_chain_plain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Counterpart of the JAX package's ``xla_conv_chain``, in ``x.dtype``.

    Per layer ``F.conv2d(padding=1)`` on the NCHW view of NHWC ``x``, then
    ReLU. x [B, H, W, C]; weights [L, 3, 3, C, C] HWIO. Returns [B, H, W, C].
    """
    y = x.permute(0, 3, 1, 2)
    for layer in range(weights.shape[0]):
        y = torch.relu(F.conv2d(y, weights[layer].permute(3, 2, 0, 1), padding=1))
    return y.permute(0, 2, 3, 1).contiguous()


def conv_chain_route(dtype: torch.dtype, channels: int) -> str:
    """The kernel that runs a chain of this dtype and width on a GPU:
    ``"tensor_core"`` (bfloat16, 1 <= C <= 64) or ``"cuda_core"`` (float32)."""
    if dtype == torch.float32:
        return "cuda_core"
    if dtype == torch.bfloat16:
        if 1 <= channels <= _MAX_TC_CHANNELS:
            return "tensor_core"
        raise ValueError(f"the tensor-core kernel takes bfloat16 chains of 1 <= C <= "
                         f"{_MAX_TC_CHANNELS}, got C={channels}")
    raise ValueError(f"want float32 or bfloat16, got {dtype}")


def split_layers(depth: int, group: int) -> tuple:
    """Layers per launch, in order: ``group`` each, the last launch the rest."""
    if depth < 1 or group < 1:
        raise ValueError(f"want depth >= 1 and group >= 1, got {depth} and {group}")
    return tuple(min(group, depth - first) for first in range(0, depth, group))


@functools.cache
def _library():
    lib = load_library("conv_chain").lib
    lib.mp_fused_conv_chain.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p])
    lib.mp_fused_conv_chain.restype = ctypes.c_int
    lib.mp_conv_chain_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.mp_conv_chain_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x: torch.Tensor, weights: torch.Tensor) -> str:
    """Validate a call; return its route."""
    if x.dim() != 4 or weights.dim() != 5:
        raise ValueError(f"want x [B, H, W, C] and weights [L, 3, 3, C, C], got "
                         f"{tuple(x.shape)} and {tuple(weights.shape)}")
    c = x.shape[3]
    if tuple(weights.shape[1:]) != (3, 3, c, c) or weights.shape[0] < 1:
        raise ValueError(f"weights {tuple(weights.shape)} do not fit x {tuple(x.shape)}: "
                         f"want [L >= 1, 3, 3, {c}, {c}]")
    if x.dtype not in _DTYPES or weights.dtype != x.dtype:
        raise ValueError(f"want float32 or bfloat16 x and weights of one dtype, got "
                         f"{x.dtype} and {weights.dtype}")
    route = conv_chain_route(x.dtype, c)
    if not (x.is_contiguous() and weights.is_contiguous()):
        raise ValueError("x and weights must be contiguous")
    if weights.device != x.device:
        raise ValueError(f"x is on {x.device} but weights are on {weights.device}")
    return route


def smem_bytes(dtype: torch.dtype, channels: int, group: int) -> int:
    """Shared memory one block of ``dtype``'s kernel needs at ``channels``
    running ``group`` layers per launch (the CUDA library's own figure, so it
    builds the kernels); -1 where that kernel takes no such group."""
    return _library().mp_conv_chain_smem_bytes(_DTYPES[dtype], channels, group)


def _launch(x: torch.Tensor, weights: torch.Tensor, groups: tuple) -> torch.Tensor:
    """Run the chain on the GPU in launches of ``groups`` layers each (all 1
    for float32). Checked inputs only: ``fused_conv_chain`` picks the groups;
    the probe calls this to measure other group sizes."""
    b, h, w, c = x.shape
    if x.numel() >= 2**31 or b >= 2**16:
        raise ValueError(f"x too large for the kernel's grid and indices: {tuple(x.shape)}")
    route = conv_chain_route(x.dtype, c)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    dtype = _DTYPES[x.dtype]
    smem = max(smem_bytes(x.dtype, c, g) for g in groups)
    if smem < 0 or smem > _MAX_SMEM:
        raise ValueError(f"C={c} in groups {groups} needs {smem} B of shared memory per block, "
                         f"over {_MAX_SMEM}")
    scratch = torch.empty_like(x) if len(groups) > 1 else out
    arr = (ctypes.c_int * len(groups))(*groups)
    with torch.cuda.device(x.device):
        err = lib.mp_fused_conv_chain(
            dtype, x.data_ptr(), weights.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            b, h, w, c, weights.shape[0], arr, len(groups),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv chain kernel launch failed with CUDA error {err}")
    fused_conv_chain.launches += 1
    if route == "tensor_core":
        fused_conv_chain.tensor_core_launches += 1
    return out


def fused_conv_chain(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """L x (3x3 SAME conv, stride 1, no bias, ReLU) over NHWC activations.

    x: [B, H, W, C], float32 or bfloat16 (then C <= 64), contiguous; weights:
    [L, 3, 3, C, C] HWIO of the same dtype and device, contiguous, L >= 1.
    Each layer sums in float32 and rounds to ``x.dtype`` after its ReLU.
    Returns [B, H, W, C] in ``x.dtype``. ``fused_conv_chain.launches`` counts
    the calls that launched a kernel (one per call, however many layers and
    launches); ``fused_conv_chain.tensor_core_launches`` those of them that
    went to the tensor-core kernel.
    """
    route = _check(x, weights)
    if x.device.type == "cpu":
        return conv_chain_plain(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"no conv chain for device {x.device}")
    group = FUSED_LAYERS if route == "tensor_core" else 1
    return _launch(x, weights, split_layers(weights.shape[0], group))


fused_conv_chain.launches = 0
fused_conv_chain.tensor_core_launches = 0
