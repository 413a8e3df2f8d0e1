"""Does a conv chain's backward cost depend on the channel count or the memory layout?

Counterpart of ``tools/ablate_conv_layout.py``, which asked on the TPU
whether the slowdown of C=32 chains at 128-wide shapes came from the
channel count (lane padding) or the layout. The same shapes on the card:
JAX's NHWC is ``torch.channels_last`` here (the NHWC array viewed NCHW),
its NCHW a contiguous NCHW tensor with OIHW kernels; C=32 against C=64,
C=128 and C=256 (the s2d forms of the bottom-up branches), and the batch
at the slow shape. Each row times the chain's forward twice over
(``fwd2x``: the vdot of two forwards, as the JAX program writes it) and
its forward+backward, cuDNN through ``F.conv2d``, with CUDA events
around back-to-back calls after a warm call; each program returns JAX's
scalar.

    python3 -m mindpose_tpu_torch.tools.ablate_conv_layout [--device cpu] [--iters 10]
"""
from typing import Dict, List, Optional

import numpy as np
import torch

from .ablate_conv_chain import DEPTH, chain
from .ablate_conv_chain import inputs as chain_inputs
from .ablate_conv_bwd import grad_program
from .timing import device_parser, resolve_device, time_program, uniform

__all__ = ["ITERS", "SHAPES", "inputs", "fwd2x_program", "run", "main"]

ITERS = 10
# (tag, batch, height, width, channels, layout), in the JAX tool's order
SHAPES = [
    ("C32 NHWC B96 64x64", 96, 64, 64, 32, "NHWC"),
    ("C32 NHWC B24 128x128", 24, 128, 128, 32, "NHWC"),
    ("C32 NCHW B96 64x64", 96, 64, 64, 32, "NCHW"),
    ("C32 NCHW B24 128x128", 24, 128, 128, 32, "NCHW"),
    ("C128 NHWC B24 64x64", 24, 64, 64, 128, "NHWC"),
    ("C128 NHWC B6 128x128", 6, 128, 128, 128, "NHWC"),
    ("C64 NHWC B48 64x64", 48, 64, 64, 64, "NHWC"),
    ("C64 NHWC B12 128x128", 12, 128, 128, 64, "NHWC"),
    ("C32 NHWC B48 128x128", 48, 128, 128, 32, "NHWC"),
    ("C32 NHWC B96 128x128", 96, 128, 128, 32, "NHWC"),
    ("C64 NHWC B24 64x64 (branch1)", 24, 64, 64, 64, "NHWC"),
    ("C256 NHWC B24 32x32 (b1 s2d)", 24, 32, 32, 256, "NHWC"),
    ("C64 NHWC B24 128x128", 24, 128, 128, 64, "NHWC"),
    ("C256 NHWC B24 64x64", 24, 64, 64, 256, "NHWC"),
]


def inputs(rng: np.random.RandomState, b: int, h: int, w: int, c: int, layout: str,
           dtype: torch.dtype, device: torch.device, depth: int = DEPTH):
    """The JAX tool's draws in its layout: NHWC x with HWIO kernels, or NCHW x
    with OIHW kernels; returned as NCHW tensors of that memory layout."""
    if layout == "NHWC":
        return chain_inputs(rng, b, h, w, c, dtype, device, depth)
    x = uniform(rng, (b, c, h, w), dtype, device)
    ks = [uniform(rng, (c, c, 3, 3), dtype, device, 0.1) for _ in range(depth)]
    return x, ks


def fwd2x_program(x: torch.Tensor, ks: List[torch.Tensor]) -> torch.Tensor:
    """vdot(chain(x), chain(x)) in float32, two forwards."""
    with torch.no_grad():
        a = chain(x, ks).float().reshape(-1)
        b = chain(x, ks).float().reshape(-1)
        return torch.vdot(a, b)


def run(tag: str, b: int, h: int, w: int, c: int, rng: np.random.RandomState,
        device: torch.device, layout: str = "NHWC", dtype: torch.dtype = torch.bfloat16,
        iters: int = ITERS) -> Dict:
    x, ks = inputs(rng, b, h, w, c, layout, dtype, device)
    ms, value = time_program(grad_program("both"), (x, ks), iters, device)
    ms_f, value_f = time_program(fwd2x_program, (x, ks), iters, device)
    mpix = b * h * w / 1e6
    print(f"{tag:34s} fwd2x {ms_f:7.2f} ms  fwd+bwd {ms:7.2f} ms "
          f"{ms / mpix:7.3f} ms/Mpix", flush=True)
    return {"tag": tag, "fwd2x_ms": ms_f, "fwd_bwd_ms": ms, "ms_per_mpix": ms / mpix,
            "value": value, "fwd2x_value": value_f}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Conv-chain layout and channel-count dependence (cuDNN).")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    return [run(tag, b, h, w, c, rng, device, layout, iters=args.iters)
            for tag, b, h, w, c, layout in SHAPES]


if __name__ == "__main__":
    main()
