"""Conv-chain shape sensitivity: is a chain of 3x3 convs slower at the bottom-up geometry?

Counterpart of ``tools/ablate_conv_chain.py`` (XLA's conv-chain shape
sensitivity; the Pallas go/no-go probe is ``ablate_pallas_chain.py``). A
chain of ``DEPTH`` 3x3 SAME convs with ReLU, cuDNN through ``F.conv2d`` on
NHWC inputs viewed NCHW (``torch.channels_last``), bf16, times the
top-down branch-0 geometry (B128 64x48) against the bottom-up one (B24
128x128) at equal total pixels, forward and forward+backward, at C=32 and
C=64, then the batch-folding variants at C=32 (inexact semantics: pure
shape probes). The JAX tool amortised a ~3 ms dispatch floor over the
chain; here each program is timed with CUDA events around back-to-back
calls after a warm call. Each timed program returns JAX's scalar: the
forward the chain's sum, the backward the squared norm of the gradients
with respect to the input and every kernel.

    python3 -m mindpose_tpu_torch.tools.ablate_conv_chain [--device cpu] [--iters 10]
"""
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .timing import device_parser, gnorm, nchw, resolve_device, time_program, uniform

__all__ = ["DEPTH", "ITERS", "SHAPES", "chain", "inputs", "fwd_program", "fwd_bwd_program",
           "run", "main"]

DEPTH = 8
ITERS = 10
# (tag, batch, height, width, channels, backward), in the JAX tool's order
SHAPES = [
    *[row for c in (32, 64) for row in (
        ("B128 64x48 (topdown geom)", 128, 64, 48, c, False),
        ("B24  128x128 (bottomup geom)", 24, 128, 128, c, False),
        ("B128 64x48 (topdown geom)", 128, 64, 48, c, True),
        ("B24  128x128 (bottomup geom)", 24, 128, 128, c, True))],
    ("B48  64x128 (H folded to batch)", 48, 64, 128, 32, True),
    ("B96  64x64  (HW folded)", 96, 64, 64, 32, True),
    ("B24  256x256 (bottomup 2x geom)", 24, 256, 256, 32, True),
    ("B384 32x24  (topdown /2 geom)", 384, 32, 24, 32, True),
]


def chain(x: torch.Tensor, ks: Sequence[torch.Tensor], relu: bool = True) -> torch.Tensor:
    """``len(ks)`` 3x3 SAME convs (OIHW kernels), each followed by ReLU."""
    for k in ks:
        x = F.conv2d(x, k, padding=1)
        if relu:
            x = F.relu(x)
    return x


def inputs(rng: np.random.RandomState, b: int, h: int, w: int, c: int, dtype: torch.dtype,
           device: torch.device, depth: int = DEPTH):
    """The JAX tool's draws: x [b, h, w, c] in [0, 1), then ``depth`` HWIO
    kernels times 0.1; returned NCHW (channels_last) and OIHW."""
    x = nchw(uniform(rng, (b, h, w, c), dtype, device))
    ks = [uniform(rng, (3, 3, c, c), dtype, device, 0.1).permute(3, 2, 0, 1)
          .contiguous(memory_format=torch.channels_last) for _ in range(depth)]
    return x, ks


def fwd_program(x: torch.Tensor, ks: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum(chain(x).float()): the JAX tool's forward program."""
    with torch.no_grad():
        return chain(x, ks).float().sum()


def fwd_bwd_program(x: torch.Tensor, ks: Sequence[torch.Tensor]) -> torch.Tensor:
    """The squared norm of d sum(chain(x)) / d(x, ks): the JAX tool's backward program."""
    x = x.detach().requires_grad_()
    ks = [k.detach().requires_grad_() for k in ks]
    loss = chain(x, ks).float().sum()
    return gnorm(torch.autograd.grad(loss, [x, *ks]))


def run(tag: str, b: int, h: int, w: int, c: int, bwd: bool, rng: np.random.RandomState,
        device: torch.device, iters: int = ITERS, dtype: torch.dtype = torch.bfloat16) -> Dict:
    x, ks = inputs(rng, b, h, w, c, dtype, device)
    ms, value = time_program(fwd_bwd_program if bwd else fwd_program, (x, ks), iters, device)
    gflop = 2 * b * h * w * 9 * c * c * DEPTH * (3 if bwd else 1) / 1e9
    row = {"tag": tag, "C": c, "mode": "fwd+bwd" if bwd else "fwd", "ms": ms,
           "tflops": gflop / ms, "value": value}
    print(f"{tag:34s} C={c:<4d} {'fwd+bwd' if bwd else 'fwd    '}"
          f" {ms:8.2f} ms  {gflop / ms:6.1f} TFLOP/s", flush=True)
    return row


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Conv-chain shape sensitivity (cuDNN): top-down vs bottom-up geometry.")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    return [run(tag, b, h, w, c, bwd, rng, device, args.iters)
            for tag, b, h, w, c, bwd in SHAPES]


if __name__ == "__main__":
    main()
