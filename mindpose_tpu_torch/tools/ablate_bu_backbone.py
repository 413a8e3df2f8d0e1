"""HRNet-W32 backbone forward+backward at equal pixel counts: does the shape set the cost?

Counterpart of ``tools/ablate_bu_backbone.py``, which asked on the TPU why
the bottom-up step (batch 24 at 512x512) spent far longer in the
backbone than the top-down one (batch 128 at 256x192): the same pixels,
weights and dtype. The same question on the card: the whole backbone's
forward+backward (gradients with respect to its parameters), bf16
autocast, at four equal-pixel shapes, with train-mode BatchNorm (batch
statistics; the running ones left as they are, as JAX discards them) and
in eval mode. (The JAX tool's docstring also names a stage-by-stage
split of the 512 case, which its code does not time;
``profile_parts.py --batch 24 --input 512x512`` gives that split.) XLA's
cost analysis (TFLOP, GB) has no counterpart. Timed with CUDA events
around back-to-back calls after a warm call; each program returns the
squared norm of its gradients (the JAX program returns the gradients).

    python3 -m mindpose_tpu_torch.tools.ablate_bu_backbone [--device cpu] [--iters 10]
"""
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..models.backbones.hrnet import HRNet, w_cfg
from ..models.common import frozen_statistics
from .ablate_step import autocast
from .timing import device_parser, gnorm, resolve_device, time_program

__all__ = ["ITERS", "WIDTH", "SHAPES", "backbone_program", "run", "main"]

ITERS = 10
WIDTH = 32
SHAPES = [(128, 256, 192), (96, 256, 256), (48, 512, 256), (24, 512, 512)]  # (B, H, W)


def backbone_program(net: nn.Module, train: bool, device: torch.device,
                     amp_level: str = "O2") -> Callable:
    """The squared norm of d sum(net(x)) / d parameters, BatchNorm in train
    mode (batch statistics) or eval mode (running ones)."""
    params = [p for p in net.parameters() if p.requires_grad]

    def program(x: torch.Tensor) -> torch.Tensor:
        net.train(train)
        with frozen_statistics(net), autocast(device, amp_level):
            out = net(x).float().sum()
        return gnorm(torch.autograd.grad(out, params))

    return program


def run(device: torch.device, iters: int = ITERS, amp_level: str = "O2",
        net: Optional[nn.Module] = None) -> List[Dict]:
    if net is None:
        torch.manual_seed(0)
        net = HRNet(w_cfg(WIDTH))
    net = net.to(device)
    rng = np.random.RandomState(0)
    rows = []
    print(f"{'shape':26s} {'ms':>8s} {'ms/Mpix':>8s}")
    for b, h, w in SHAPES:
        x = torch.from_numpy(rng.rand(b, h, w, 3).astype(np.float32)).to(device)
        x = x.permute(0, 3, 1, 2).contiguous()
        mpix = b * h * w / 1e6
        for train in (True, False):
            ms, value = time_program(backbone_program(net, train, device, amp_level), (x,),
                                     iters, device)
            tag = "train" if train else "eval "
            print(f"B{b:<4d}{h}x{w:<8} {tag}BN {ms:8.2f} {ms / mpix:8.3f}", flush=True)
            rows.append({"shape": [b, h, w], "bn": tag.strip(), "ms": ms,
                         "ms_per_mpix": ms / mpix, "value": value})
    return rows


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("HRNet-W32 backbone fwd+bwd at equal pixel counts.")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    return run(resolve_device(args.device), args.iters)


if __name__ == "__main__":
    main()
