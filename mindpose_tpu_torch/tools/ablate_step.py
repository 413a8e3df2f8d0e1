"""Where the HRNet-W32 train step's time goes: variants of the real step at batch 128.

Counterpart of ``tools/ablate_step.py``: the full step of
``hrnet_w32_tpu.yaml``'s net and loss (HRNet-W32 + ``hrnet_head``,
``joint_mse`` with target weights, adamw at 1e-3 with weight decay 0.05,
bf16: O2 autocast here) against the same step without the optimizer,
forward only, with BatchNorm in eval mode (no batch statistics), and
the forward alone in eval mode. The JAX tool chained dispatches and
fetched one scalar; each variant here is timed with CUDA events around
back-to-back calls after a warm call, and returns JAX's scalar: the
loss's sum (forward programs), the output's sum (the eval forward), the
squared norm of the parameters' gradient (``gnorm``, where the JAX
programs return the gradient tree itself), or the full step's loss sum.
Train-mode programs leave the running statistics as they are (JAX
discards them), and the full step trains its own copy of the net, so
every program starts from the same weights, as JAX's do.

    python3 -m mindpose_tpu_torch.tools.ablate_step [--device cpu] [--iters 20]
"""
import copy
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import create_loss, create_network, create_network_with_loss
from ..models.common import frozen_statistics
from ..optim import create_optimizer
from ..parallel import build_train_step
from .timing import device_parser, gnorm, resolve_device, time_program

__all__ = ["B", "BACKBONE", "HEAD", "IMAGE", "HEATMAP", "ITERS", "build", "make_inputs",
           "autocast", "programs", "run", "main"]

B = 128
BACKBONE, HEAD = "hrnet_w32", "hrnet_head"
IMAGE = (256, 192)  # H, W
HEATMAP = (64, 48)
K = 17
ITERS = 20


def autocast(device: torch.device, amp_level: str):
    """bf16 autocast for any level but O0, as the JAX package builds a bf16 net."""
    if amp_level == "O0":
        return torch.autocast(device.type, enabled=False)
    return torch.autocast(device.type, dtype=torch.bfloat16)


def build(device: torch.device, backbone: str = None, head: str = None):
    """(net, loss, net with loss) on ``device``, torch seed 0."""
    torch.manual_seed(0)
    net = create_network(backbone or BACKBONE, head or HEAD).to(device)
    loss = create_loss("joint_mse", use_target_weight=True)
    return net, loss, create_network_with_loss(net, loss, has_extra_inputs=True)


def make_inputs(rng: np.random.RandomState, b: int, image: Tuple[int, int],
                heatmap: Tuple[int, int], device: torch.device):
    """The JAX tool's draws: x [B, H, W, 3] and y [B, h, w, 17] in [0, 1), w ones;
    returned NCHW / NKHW, float32."""
    x = rng.rand(b, *image, 3).astype(np.float32)
    y = rng.rand(b, *heatmap, K).astype(np.float32)
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(device),
            torch.from_numpy(y).permute(0, 3, 1, 2).contiguous().to(device),
            torch.ones(b, K, device=device))


def _params(net: nn.Module) -> List[torch.Tensor]:
    return [p for p in net.parameters() if p.requires_grad]


def programs(net: nn.Module, loss, nwl: nn.Module, device: torch.device,
             amp_level: str = "O2") -> Dict[str, Callable]:
    """The JAX tool's timed programs over (x, y, w), by name, each returning
    its scalar. ``full`` trains a copy of the net (adamw, lr 1e-3, weight
    decay 0.05), from the net's weights at the time of this call."""
    step_net = copy.deepcopy(net)
    step_nwl = create_network_with_loss(step_net, loss, has_extra_inputs=True)
    optimizer = create_optimizer(step_net, "adamw", learning_rate=1e-3, weight_decay=0.05)
    step = build_train_step(step_nwl, optimizer, amp_level=amp_level)

    def full(x, y, w):
        return step(x, y, w).sum()

    def fwd(x, y, w):
        net.train()
        with torch.no_grad(), frozen_statistics(net), autocast(device, amp_level):
            return nwl(x, y, w).sum()

    def fwdbwd(x, y, w):
        net.train()
        with frozen_statistics(net), autocast(device, amp_level):
            out = nwl(x, y, w).sum()
        return gnorm(torch.autograd.grad(out, _params(net)))

    def fwdbwd_eval(x, y, w):
        net.eval()
        with autocast(device, amp_level):
            hm = net(x)
        out = loss(hm.float(), y, w).sum()
        return gnorm(torch.autograd.grad(out, _params(net)))

    def fwd_eval(x, y, w):
        net.eval()
        with torch.no_grad(), autocast(device, amp_level):
            return net(x).float().sum()

    return {"full": full, "fwd": fwd, "fwdbwd": fwdbwd, "fwdbwd_eval": fwdbwd_eval,
            "fwd_eval": fwd_eval}


LABELS = {
    "full": "full step (fwd+bwd+opt)",
    "fwd": "fwd only (train BN)",
    "fwdbwd": "fwd+bwd (no opt)",
    "fwdbwd_eval": "fwd+bwd (eval BN, no stats)",
    "fwd_eval": "fwd only (eval BN)",
}


def run(device: torch.device, b: int = B, iters: int = ITERS, amp_level: str = "O2",
        built=None) -> List[Dict]:
    net, loss, nwl = built or build(device)
    inputs = make_inputs(np.random.RandomState(0), b, IMAGE, HEATMAP, device)
    rows = []
    for name, program in programs(net, loss, nwl, device, amp_level).items():
        ms, value = time_program(program, inputs, iters, device)
        print(f"{LABELS[name]:28s} {ms:8.2f} ms", flush=True)
        rows.append({"variant": name, "label": LABELS[name], "ms": ms, "value": value})
    return rows


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Ablation timing of the HRNet-W32 train step (batch 128).")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    return run(resolve_device(args.device), B, args.iters)


if __name__ == "__main__":
    main()
