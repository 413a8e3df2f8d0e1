"""Which half of a conv chain's backward is slow at wide shapes: dx or dw, W, dtype?

Counterpart of ``tools/ablate_conv_bwd.py``. ``ablate_conv_chain.py`` asks
whether the chain's backward slows at the bottom-up geometry; this tool
narrows it on the card: the gradient with respect to the input only
(``dx``) against the kernels only (``dw``), a sweep of W at constant
pixels (the rest folded into the batch), and float32 (TF32 off) against
bf16. The chain is ``ablate_conv_chain.chain`` at C=32, depth 8, cuDNN
through ``F.conv2d`` on NHWC inputs viewed NCHW. Timed with CUDA events
around back-to-back calls after a warm call (the JAX tool chained
dispatches and fetched one scalar); each program returns JAX's scalar,
the squared norm of the gradients it takes.

    python3 -m mindpose_tpu_torch.tools.ablate_conv_bwd [--device cpu] [--iters 10]
"""
from typing import Dict, List, Optional

import numpy as np
import torch

from .ablate_conv_chain import DEPTH, chain, inputs
from .timing import device_parser, gnorm, resolve_device, time_program

__all__ = ["C", "ITERS", "SHAPES", "grad_program", "run", "main"]

C = 32
ITERS = 10
BF16, F32 = torch.bfloat16, torch.float32
# (tag, batch, height, width, dtype, grad_of), in the JAX tool's order
SHAPES = [
    ("B24 128x128 bf16", 24, 128, 128, BF16, "dx"),
    ("B24 128x128 bf16", 24, 128, 128, BF16, "dw"),
    ("B128 64x48 bf16", 128, 64, 48, BF16, "dx"),
    ("B128 64x48 bf16", 128, 64, 48, BF16, "dw"),
    *[(f"B{b} {h}x{w} bf16", b, h, w, BF16, "both")
      for b, h, w in ((96, 64, 64), (48, 64, 128), (24, 64, 256),
                      (48, 128, 64), (24, 128, 128), (12, 128, 256))],
    ("B24 128x128 f32", 24, 128, 128, F32, "both"),
]


def grad_program(grad_of: str):
    """The squared norm of d sum(chain(x)) / d(x, ks), d x or d ks."""

    def program(x: torch.Tensor, ks: List[torch.Tensor]) -> torch.Tensor:
        x = x.detach().requires_grad_(grad_of in ("both", "dx"))
        ks = [k.detach().requires_grad_(grad_of in ("both", "dw")) for k in ks]
        wrt = {"both": [x, *ks], "dx": [x], "dw": ks}[grad_of]
        return gnorm(torch.autograd.grad(chain(x, ks).float().sum(), wrt))

    return program


def run(tag: str, b: int, h: int, w: int, rng: np.random.RandomState, device: torch.device,
        dtype: torch.dtype = BF16, grad_of: str = "both", iters: int = ITERS,
        c: int = C) -> Dict:
    x, ks = inputs(rng, b, h, w, c, dtype, device, DEPTH)
    # float32 as float32: cuDNN would otherwise run it in TF32 by PyTorch's default
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32 and dtype != F32
    try:
        ms, value = time_program(grad_program(grad_of), (x, ks), iters, device)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    mpix = b * h * w / 1e6
    print(f"{tag:36s} grad={grad_of:4s} {ms:8.2f} ms   {ms / mpix:6.3f} ms/Mpix", flush=True)
    return {"tag": tag, "grad": grad_of, "ms": ms, "ms_per_mpix": ms / mpix, "value": value}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Conv-chain backward: dx vs dw, W at constant pixels, bf16 vs float32.")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.RandomState(0)
    return [run(tag, b, h, w, rng, device, dtype, grad_of, args.iters)
            for tag, b, h, w, dtype, grad_of in SHAPES]


if __name__ == "__main__":
    main()
