"""Proxy ablation: would space-to-depth channel packing speed the HigherHRNet head's chain?

Counterpart of ``tools/ablate_s2d_head.py``. The head's refinement runs a
chain of 3x3 C=32 convs at 256x256, which on the TPU ran far below the
rate of C=128 chains; the JAX tool timed exact rewrites as proxies (same
pixels and parameters, random s2d kernels in place of scattered ones):

  plain      8x conv3x3 C32 @ 256x256        (1.00x FLOPs, the status quo)
  s2d_dense  8x conv3x3 C128 @ 128x128       (4.00x FLOPs, structural zeros)
  s2d_parity 8x [4 parity conv2x2 4C->C]     (1.78x FLOPs, minimal rewrite)
  *_conv     the same plus the s2d / inverse transposes at the chain's ends

and its rule was: ship whichever beats plain by the most wall-clock. The
same question on the card, cuDNN through ``F.conv2d`` on NHWC tensors
viewed NCHW (``torch.channels_last``), bf16. The port's models dropped the
s2d forms (exact rewrites for the TPU's lanes), so the tool keeps its own
copy of ``space_to_depth`` (``mindpose_tpu/models/backbones/s2d.py:49``).
Each chain is timed forward+backward with CUDA events around back-to-back
calls after a warm call (the JAX tool chained dispatches and fetched one
scalar); each program returns JAX's scalar, the squared norm of the
gradients with respect to the input and every kernel.

    python3 -m mindpose_tpu_torch.tools.ablate_s2d_head [--device cpu] [--batch 24] [--iters 10]
"""
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .timing import device_parser, gnorm, resolve_device, time_program, uniform

__all__ = ["B", "H", "W", "C", "DEPTH", "ITERS", "space_to_depth", "depth_to_space",
           "draw_inputs", "chain_plain", "chain_dense", "chain_parity", "chain_dense_conv",
           "chain_parity_conv", "loss_of", "CHAINS", "run", "main"]

B, H, W, C = 24, 256, 256, 32
DEPTH = 8
ITERS = 10


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC 2x2 space-to-depth with parity-major channel layout (di, dj, c)."""
    n, h, w, c = x.shape
    assert h % block == 0 and w % block == 0, (h, w)
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, block * block * c)


def depth_to_space(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    n, h, w, c4 = x.shape
    c = c4 // (block * block)
    x = x.reshape(n, h, w, block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * block, w * block, c)


def conv(x: torch.Tensor, k: torch.Tensor, pad=((1, 1), (1, 1))) -> torch.Tensor:
    """An NHWC input and an HWIO kernel, stride 1, padding ((top, bottom),
    (left, right)), as ``lax.conv_general_dilated`` takes them; NHWC out."""
    (top, bottom), (left, right) = pad
    xc = x.permute(0, 3, 1, 2)
    if (top, bottom) == (left, right) and top == bottom:
        y = F.conv2d(xc, k.permute(3, 2, 0, 1), padding=top)
    else:
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), k.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def chain_plain(x: torch.Tensor, ks: Sequence[torch.Tensor]) -> torch.Tensor:
    for k in ks:
        x = F.relu(conv(x, k))
    return x


chain_dense = chain_plain  # the same chain on s2d inputs and 4C kernels


def chain_parity(x: torch.Tensor, ks: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Per layer: 4 output-parity 2x2 convs with one-sided padding, concatenated
    as s2d channels (a proxy: the parity order does not matter for timing)."""
    for quad in ks:
        outs = []
        for i, (pa, pb) in enumerate(((1, 0), (0, 1))):
            for j, (qa, qb) in enumerate(((1, 0), (0, 1))):
                outs.append(conv(x, quad[i * 2 + j], ((pa, pb), (qa, qb))))
        x = F.relu(torch.cat(outs, dim=-1))
    return x


def chain_dense_conv(x: torch.Tensor, ks) -> torch.Tensor:
    return depth_to_space(chain_dense(space_to_depth(x), ks))


def chain_parity_conv(x: torch.Tensor, ks) -> torch.Tensor:
    return depth_to_space(chain_parity(space_to_depth(x), ks))


def _flat(ks) -> List[torch.Tensor]:
    return [k for item in ks for k in (item if isinstance(item, (list, tuple)) else [item])]


def _requiring_grad(ks):
    if isinstance(ks, (list, tuple)):
        return [_requiring_grad(k) for k in ks]
    return ks.detach().requires_grad_()


def loss_of(chain_fn: Callable) -> Callable:
    """The squared norm of d sum(chain_fn(x, ks)) / d(x, ks)."""

    def program(x: torch.Tensor, ks) -> torch.Tensor:
        x = x.detach().requires_grad_()
        ks = _requiring_grad(ks)
        loss = chain_fn(x, ks).float().sum()
        return gnorm(torch.autograd.grad(loss, [x, *_flat(ks)]))

    return program


def draw_inputs(rng: np.random.RandomState, b: int, h: int, w: int, c: int,
                dtype: torch.dtype, device: torch.device, depth: int = DEPTH) -> Dict:
    """The JAX tool's draws, in its order: the NHWC input, the 3x3 kernels, the
    s2d 3x3 kernels (4C), then four 2x2 parity kernels (4C -> C) per layer."""
    x = uniform(rng, (b, h, w, c), dtype, device)
    ks3 = [uniform(rng, (3, 3, c, c), dtype, device, 0.1) for _ in range(depth)]
    ks3_s2d = [uniform(rng, (3, 3, 4 * c, 4 * c), dtype, device, 0.1) for _ in range(depth)]
    ks2_par = [[uniform(rng, (2, 2, 4 * c, c), dtype, device, 0.1) for _ in range(4)]
               for _ in range(depth)]
    return {"x": x, "x_s2d": space_to_depth(x), "ks3": ks3, "ks3_s2d": ks3_s2d,
            "ks2_par": ks2_par}


# (tag, chain, input, kernels, FLOPs against plain), in the JAX tool's order
CHAINS = [
    ("plain 3x3 C32 256x256", chain_plain, "x", "ks3", 1.0),
    ("s2d dense 3x3 C128 128x128", chain_dense, "x_s2d", "ks3_s2d", 4.0),
    ("s2d parity 4x2x2 128x128", chain_parity, "x_s2d", "ks2_par", 16 / 9),
    ("s2d dense + convert ends", chain_dense_conv, "x", "ks3_s2d", 4.0),
    ("s2d parity + convert ends", chain_parity_conv, "x", "ks2_par", 16 / 9),
]


def run(rng: np.random.RandomState, device: torch.device, b: int = B, h: int = H, w: int = W,
        c: int = C, iters: int = ITERS, dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
    inputs = draw_inputs(rng, b, h, w, c, dtype, device)
    base_gflop = 2 * b * h * w * 9 * c * c * DEPTH * 3 / 1e9
    rows = []
    for tag, chain_fn, x, ks, flops_x in CHAINS:
        ms, value = time_program(loss_of(chain_fn), (inputs[x], inputs[ks]), iters, device)
        print(f"{tag:34s} {ms:8.2f} ms   {flops_x:4.2f}x FLOPs "
              f"({base_gflop * flops_x / ms:6.1f} TF/s achieved)", flush=True)
        rows.append({"tag": tag, "ms": ms, "flops_x": flops_x,
                     "tflops": base_gflop * flops_x / ms, "value": value})
    return rows


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Space-to-depth proxy chains for the HigherHRNet head (cuDNN).")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    return run(np.random.RandomState(0), device, b=args.batch, h=H, w=W, c=C, iters=args.iters)


if __name__ == "__main__":
    main()
