"""One 3x3 conv across equal-pixel shapes and widths: where does a wide shape cost more?

Counterpart of ``tools/ablate_conv_shape.py``, which asked on the TPU why
the HRNet backbone ran slower at B24 512x512 than at B128 256x192 (equal
pixels and FLOPs). On the card: one 3x3 SAME conv (cuDNN through
``F.conv2d``, NHWC inputs viewed NCHW, bf16) at the top-down and bottom-up
stage-1 shapes and their 2x, at C=32, 64 and 128, timed four ways: the
forward, forward+backward, and the forward with each backward half alone
(``fwd+dx``: dgrad; ``fwd+dw``: wgrad). CUDA events around back-to-back
calls after a warm call; each program returns JAX's scalar (the forward's
sum, the gradients' squared norm, half of one gradient's).

    python3 -m mindpose_tpu_torch.tools.ablate_conv_shape [--device cpu] [--iters 10]
"""
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .timing import device_parser, gnorm, nchw, resolve_device, time_program, uniform

__all__ = ["ITERS", "SHAPES", "conv", "fwd_program", "grad_program", "run", "main"]

ITERS = 10
# (tag, batch, height, width, channels), in the JAX tool's order
SHAPES = [
    *[row for c in (32, 64, 128) for row in (
        ("B128 64x48 (topdown s1)", 128, 64, 48, c),
        ("B24  128x128 (bottomup s1)", 24, 128, 128, c))],
    ("B128 128x96 (topdown 2x)", 128, 128, 96, 32),
    ("B24  256x256 (bottomup 2x)", 24, 256, 256, 32),
]


def conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, k, padding=1)


def fwd_program(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return conv(x, k).float().sum()


def grad_program(grad_of: str):
    """``both``: the squared norm of d sum(conv) / d(x, k); ``dx`` / ``dw``:
    half the squared norm of that one gradient."""

    def program(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        x = x.detach().requires_grad_(grad_of in ("both", "dx"))
        k = k.detach().requires_grad_(grad_of in ("both", "dw"))
        wrt = {"both": [x, k], "dx": [x], "dw": [k]}[grad_of]
        grads = torch.autograd.grad(conv(x, k).float().sum(), wrt)
        return gnorm(grads) if grad_of == "both" else gnorm(grads) * 0.5

    return program


def run(tag: str, b: int, h: int, w: int, c: int, rng: np.random.RandomState,
        device: torch.device, iters: int = ITERS, dtype: torch.dtype = torch.bfloat16) -> Dict:
    x = nchw(uniform(rng, (b, h, w, c), dtype, device))
    k = uniform(rng, (3, 3, c, c), dtype, device).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    row = {"tag": tag, "C": c}
    for name, program in (("fwd", fwd_program), ("fwd+bwd", grad_program("both")),
                          ("fwd+dx", grad_program("dx")), ("fwd+dw", grad_program("dw"))):
        row[name + "_ms"], row[name + "_value"] = time_program(program, (x, k), iters, device)
    print(f"{tag:28s} C={c:<4d} fwd {row['fwd_ms']:7.2f}  fwd+bwd {row['fwd+bwd_ms']:7.2f}"
          f"  fwd+dx {row['fwd+dx_ms']:7.2f}  fwd+dw {row['fwd+dw_ms']:7.2f}", flush=True)
    return row


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Single 3x3 conv shape sensitivity: fwd, dgrad, wgrad (cuDNN).")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    return [run(tag, b, h, w, c, rng, device, args.iters) for tag, b, h, w, c in SHAPES]


if __name__ == "__main__":
    main()
