"""Per-component timing of the HRNet-W32 train step: which part takes the time?

Counterpart of ``tools/profile_parts.py``. Each architectural piece (the
stem, stage 1's four bottlenecks, stages 2-4 with their exchange units,
the head's 1x1 conv) is timed alone as forward+backward (train-mode
BatchNorm, gradients with respect to its parameters and its input) at
the bench batch, then the whole backbone, so that optimisation effort
lands where the time is. As in the JAX tool, a stage's transition is
approximated by one 3x3 conv per branch (strided for the lower ones).
bf16 autocast, as the JAX tool's bf16 modules. The JAX tool chained N
dispatches and fetched one value; here CUDA events around back-to-back
calls after a warm call. Each program returns the squared norm of its
gradients (the JAX program returns the gradients themselves).

    python3 -m mindpose_tpu_torch.tools.profile_parts [--batch 128] [--iters 20] \\
        [--width 32] [--input 256x192] [--device cpu]
"""
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.backbones.hrnet import HRModule, HRNet, w_cfg
from ..models.backbones.resnet import Bottleneck
from ..models.common import BatchNorm2d, conv3x3, frozen_statistics
from .ablate_step import autocast
from .timing import device_parser, gnorm, resolve_device, time_program

__all__ = ["Stem", "Stage1", "StageN", "Head", "parts", "fwd_bwd_program", "time_fwd_bwd",
           "main"]


class Stem(nn.Module):
    """Two 3x3 stride-2 convs, each with BatchNorm and ReLU."""

    def __init__(self) -> None:
        super().__init__()
        self.conv1, self.bn1 = conv3x3(3, 64, 2), BatchNorm2d(64)
        self.conv2, self.bn2 = conv3x3(64, 64, 2), BatchNorm2d(64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class Stage1(nn.Module):
    """Four bottlenecks at 64 channels (the first with a downsample)."""

    def __init__(self) -> None:
        super().__init__()
        self.blocks = nn.Sequential(Bottleneck(64, 64, downsample=True),
                                    *[Bottleneck(256, 64) for _ in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class StageN(nn.Module):
    """One 3x3 conv + BN + ReLU per branch from the highest-resolution input
    (strided from the previous branch for the lower ones: the transition's
    cost, approximated), then ``n_modules`` exchange units of 4 basic blocks
    per branch; returns the highest-resolution branch. The last unit fuses
    into that branch alone: its other fusions feed no output, and XLA drops
    them from the JAX program as dead code."""

    def __init__(self, n_modules: int, n_branches: int, channels: Sequence[int]) -> None:
        super().__init__()
        cins = [channels[0], *channels[:-1]]
        self.transitions = nn.ModuleList(
            nn.Sequential(conv3x3(cin, c, 1 if i == 0 else 2), BatchNorm2d(c), nn.ReLU())
            for i, (cin, c) in enumerate(zip(cins, channels)))
        self.modules_ = nn.Sequential(*[
            HRModule(num_branches=n_branches, block="BASIC", num_blocks=(4,) * n_branches,
                     in_channels=tuple(channels), num_channels=tuple(channels),
                     multi_scale_output=m < n_modules - 1)
            for m in range(n_modules)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = []
        for i, t in enumerate(self.transitions):
            xs.append(t(x if i == 0 else xs[-1]))
        return self.modules_(xs)[0]


class Head(nn.Module):
    """The head's 1x1 conv to 17 joints (with bias)."""

    def __init__(self, width: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(width, 17, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def parts(width: int, ih: int, iw: int) -> List[Tuple[str, Callable[[], nn.Module], tuple]]:
    """(label, module factory, input shape NHWC without the batch), in the JAX tool's order."""
    sh, sw = ih // 4, iw // 4  # the stem's output: branch 0's resolution
    w = width
    return [
        (f"stem ({ih}x{iw}x3 -> /4)", Stem, (ih, iw, 3)),
        (f"stage1 (4 bottleneck@{sh}x{sw})", Stage1, (sh, sw, 64)),
        ("stage2 (1 mod, 2 br)", lambda: StageN(1, 2, (w, w * 2)), (sh, sw, w)),
        ("stage3 (4 mod, 3 br)", lambda: StageN(4, 3, (w, w * 2, w * 4)), (sh, sw, w)),
        ("stage4 (3 mod, 4 br)", lambda: StageN(3, 4, (w, w * 2, w * 4, w * 8)), (sh, sw, w)),
        (f"head (1x1 conv {w}->17)", lambda: Head(w), (sh, sw, w)),
    ]


def fwd_bwd_program(module: nn.Module, device: torch.device, amp_level: str = "O2"):
    """The squared norm of d sum(module(x)) / d(parameters, x), train-mode
    BatchNorm leaving its running statistics (JAX discards the new ones)."""

    def program(x: torch.Tensor) -> torch.Tensor:
        module.train()
        x = x.detach().requires_grad_()
        params = [p for p in module.parameters() if p.requires_grad]
        with frozen_statistics(module), autocast(device, amp_level):
            out = module(x).float().sum()
        # a stage's lower branches end in fusions its output does not use
        return gnorm(torch.autograd.grad(out, [*params, x], allow_unused=True))

    return program


def time_fwd_bwd(module: nn.Module, x_shape: Sequence[int], iters: int, device: torch.device,
                 amp_level: str = "O2") -> Tuple[float, float]:
    """(ms, scalar) of ``module``'s forward+backward on ``RandomState(0).rand(*x_shape)`` (NHWC)."""
    x = np.random.RandomState(0).rand(*x_shape).astype(np.float32)
    x = torch.from_numpy(x).to(device).permute(0, 3, 1, 2).contiguous()
    return time_program(fwd_bwd_program(module.to(device), device, amp_level), (x,), iters,
                        device)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Per-component timing of the HRNet-W32 train step.")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--input", default="256x192",
                   help="input HxW (e.g. 512x512 for the bottom-up shape)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch
    ih, iw = (int(v) for v in args.input.split("x"))
    torch.manual_seed(0)
    rows = []
    for label, make, shape in parts(args.width, ih, iw):
        ms, value = time_fwd_bwd(make(), (b, *shape), args.iters, device)
        rows.append({"part": label, "ms": ms, "value": value})
        print(f"{label:28s} {ms:8.2f} ms", flush=True)
    total = sum(r["ms"] for r in rows)
    print(f"{'SUM of parts':28s} {total:8.2f} ms")
    ms, value = time_fwd_bwd(HRNet(w_cfg(args.width)), (b, ih, iw, 3), args.iters, device)
    print(f"{'full backbone fwd+bwd':28s} {ms:8.2f} ms")
    rows.append({"part": "SUM of parts", "ms": total, "value": None})
    rows.append({"part": "full backbone fwd+bwd", "ms": ms, "value": value})
    return rows


if __name__ == "__main__":
    main()
