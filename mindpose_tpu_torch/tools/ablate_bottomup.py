"""Where the HigherHRNet-W32 512x512 train step's time goes (batch 24).

Counterpart of ``tools/ablate_bottomup.py``: the bottom-up step decomposed
the way ``ablate_step.py`` decomposes the top-down one. The full step
(adam at 1e-3, bf16: O2 autocast here), forward only, forward+backward
without the optimizer, forward+backward with BatchNorm in eval mode, then
the bottom-up parts: the backbone alone, the head alone (on fixed stage-4
features), the loss alone with respect to bf16 predictions (all of
``ae_multi_loss``, its MSE part, its AE part, and the MSE part with
exact-size per-level targets in place of the padded [S, 256, 256] ones),
and the optimizer alone. ``--variant opt`` builds the JAX tool's shipped
configuration (``branch0_s2d``, fused BatchNorm, the head's
``s2d_refine``) and ``base`` the plain one; the port's nets run those
exact TPU rewrites as plain convolutions, so both variants build the
same net here. XLA's cost analysis has no counterpart. Each program is
timed with CUDA events around back-to-back calls after a warm call (the
JAX tool chained dispatches and fetched one scalar) and returns JAX's
scalar: the loss's sum, or the squared norm of the gradient it takes
(``gnorm``), or of the parameters after one adam update of all-ones
gradients; train-mode programs leave the running statistics as they are,
and the full step and the optimizer run on copies, so every program
starts from the same weights.

    python3 -m mindpose_tpu_torch.tools.ablate_bottomup [--device cpu] [--batch 24] \\
        [--variant opt] [--iters 10]
"""
import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models import create_loss, create_network, create_network_with_loss
from ..models.common import frozen_statistics
from ..models.loss.ae import AELoss
from ..models.loss.mse import JointsMSELossWithMask
from ..optim import create_optimizer
from ..parallel import build_train_step
from .ablate_step import autocast
from .timing import device_parser, gnorm, resolve_device, time_program

__all__ = ["B", "K", "M", "IMAGE", "SIZES", "BACKBONE", "ITERS", "build_net",
           "build_loss", "make_inputs", "net_programs", "loss_programs", "opt_program",
           "run", "main"]

B = 24
K, M = 17, 30
IMAGE = 512
SIZES = ((128, 128), (256, 256))  # (w, h) of the two heatmap levels
BACKBONE = "hrnet_w32"
ITERS = 10
VARIANTS = ("opt", "base")


def build_net(device: torch.device, variant: str = "opt", backbone: str = BACKBONE):
    """HigherHRNet-W32 (``hrnet_w32`` + ``higher_hrnet_head``), torch seed 0."""
    opt = variant == "opt"
    torch.manual_seed(0)
    return create_network(
        backbone, "higher_hrnet_head",
        backbone_args={"branch0_s2d": True, "bn_grad_stats": "fused"} if opt else {},
        head_args={"with_ae_loss": (True, False), "s2d_refine": opt}).to(device)


def build_loss(sizes: Sequence[Tuple[int, int]] = SIZES):
    return create_loss("ae_multi_loss", num_joints=K, num_stages=2,
                       stage_sizes=[list(s) for s in sizes], mse_loss_factor=[1.0, 1.0],
                       ae_loss_factor=[0.001, 0.001], with_mse_loss=[True, True],
                       with_ae_loss=[True, False])


def _nchw(a: np.ndarray, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(a).to(device).permute(0, 3, 1, 2).contiguous().to(dtype)


def make_inputs(rng: np.random.RandomState, b: int, image: int, sizes, device: torch.device,
                channels: int = 32, pred_dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """The JAX tool's draws, in its order, in the port's layouts: image NCHW,
    target [B, S, K, Hmax, Wmax], mask, tag_ind [B, S, M, K, 2], the head's
    features NCHW (``channels``: the backbone's output width), the bf16
    predictions NCHW, and the exact-size targets."""
    (w0, h0), (w1, h1) = sizes
    x = rng.rand(b, image, image, 3).astype(np.float32)
    target = rng.rand(b, 2, h1, w1, K).astype(np.float32)
    tag_ind = np.zeros((b, 2, M, K, 2), np.int32)
    tag_ind[..., 0] = rng.randint(0, h0 * w0, (b, 2, M, K))
    tag_ind[..., 1] = rng.randint(0, 2, (b, 2, M, K))
    feat = rng.rand(b, h0, w0, channels).astype(np.float32)
    pred0 = rng.rand(b, h0, w0, 2 * K).astype(np.float32)
    pred1 = rng.rand(b, h1, w1, K).astype(np.float32)
    t = torch.from_numpy(target).to(device).permute(0, 1, 4, 2, 3).contiguous()
    return {
        "x": _nchw(x, device),
        "target": t,
        "mask": torch.ones(b, 2, h1, w1, device=device),
        "tag_ind": torch.from_numpy(tag_ind).to(device),
        "feat": _nchw(feat, device),
        "pred0": _nchw(pred0, device, pred_dtype),
        "pred1": _nchw(pred1, device, pred_dtype),
        "t0_exact": t[:, 0, :, :h0, :w0].contiguous(),
        "t1_exact": t[:, 1].contiguous(),
        "m0_exact": torch.ones(b, h0, w0, device=device),
        "m1_exact": torch.ones(b, h1, w1, device=device),
    }


def _params(module: nn.Module) -> List[torch.Tensor]:
    return [p for p in module.parameters() if p.requires_grad]


def _grad_norm_wrt(out: torch.Tensor, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return gnorm(torch.autograd.grad(out, list(tensors)))


def net_programs(net: nn.Module, loss, device: torch.device, amp_level: str = "O2",
                 backbone: Optional[nn.Module] = None,
                 head: Optional[nn.Module] = None) -> Dict[str, Tuple[Callable, Tuple[str, ...]]]:
    """The programs that run the net, by name: (program, the input names it
    takes). ``backbone`` and ``head`` (default: the net's) are the modules the
    JAX tool initialises apart for its backbone-only and head-only rows."""
    backbone = backbone if backbone is not None else net.backbone
    head = head if head is not None else net.head
    nwl = create_network_with_loss(net, loss, has_extra_inputs=True)
    step_net = copy.deepcopy(net)
    optimizer = create_optimizer(step_net, "adam", learning_rate=1e-3)
    step = build_train_step(create_network_with_loss(step_net, loss, has_extra_inputs=True),
                            optimizer, amp_level=amp_level)
    batch = ("x", "target", "mask", "tag_ind")

    def full(x, target, mask, tag_ind):
        return step(x, target, mask, tag_ind).sum()

    def fwd(x, target, mask, tag_ind):
        net.train()
        with torch.no_grad(), frozen_statistics(net), autocast(device, amp_level):
            return nwl(x, target, mask, tag_ind).sum()

    def fwdbwd(x, target, mask, tag_ind):
        net.train()
        with frozen_statistics(net), autocast(device, amp_level):
            out = nwl(x, target, mask, tag_ind).sum()
        return _grad_norm_wrt(out, _params(net))

    def fwdbwd_eval(x, target, mask, tag_ind):
        net.eval()
        with autocast(device, amp_level):
            out = loss(net(x), target, mask, tag_ind).sum()
        return _grad_norm_wrt(out, _params(net))

    def bb_fwdbwd(x):
        backbone.train()
        with frozen_statistics(backbone), autocast(device, amp_level):
            out = backbone(x).float().sum()
        return _grad_norm_wrt(out, _params(backbone))

    def head_fwdbwd(feat):
        head.train()
        with frozen_statistics(head), autocast(device, amp_level):
            out = sum(o.float().sum() for o in head(feat))
        return _grad_norm_wrt(out, _params(head))

    return {"full": (full, batch), "fwd": (fwd, batch), "fwdbwd": (fwdbwd, batch),
            "fwdbwd_eval": (fwdbwd_eval, batch), "bb_fwdbwd": (bb_fwdbwd, ("x",)),
            "head_fwdbwd": (head_fwdbwd, ("feat",))}


def loss_programs(loss, sizes=SIZES) -> Dict[str, Tuple[Callable, Tuple[str, ...]]]:
    """The loss-only programs (gradients with respect to the predictions), by name."""
    (w0, h0), _ = sizes
    mse_c, ae_c = JointsMSELossWithMask(), AELoss()

    def leaves(*preds):
        return [p.detach().requires_grad_() for p in preds]

    def loss_fwdbwd(pred0, pred1, target, mask, tag_ind):
        p0, p1 = leaves(pred0, pred1)
        return _grad_norm_wrt(loss([p0, p1], target, mask, tag_ind).sum(), [p0, p1])

    def mse_fwdbwd(pred0, pred1, target, mask):
        p0, p1 = leaves(pred0, pred1)
        out = (mse_c(p0[:, :K], target[:, 0, :, :h0, :w0], mask[:, 0, :h0, :w0]).sum()
               + mse_c(p1, target[:, 1], mask[:, 1]).sum())
        return _grad_norm_wrt(out, [p0, p1])

    def ae_fwdbwd(pred0, tag_ind):
        (p0,) = leaves(pred0)
        push, pull = ae_c(p0[:, K:], tag_ind[:, 0]) * 0.001
        return _grad_norm_wrt(push + pull, [p0])

    def mse_exact_fwdbwd(pred0, pred1, t0_exact, t1_exact, m0_exact, m1_exact):
        p0, p1 = leaves(pred0, pred1)
        out = (mse_c(p0[:, :K], t0_exact, m0_exact).sum()
               + mse_c(p1, t1_exact, m1_exact).sum())
        return _grad_norm_wrt(out, [p0, p1])

    return {
        "loss_fwdbwd": (loss_fwdbwd, ("pred0", "pred1", "target", "mask", "tag_ind")),
        "mse_fwdbwd": (mse_fwdbwd, ("pred0", "pred1", "target", "mask")),
        "ae_fwdbwd": (ae_fwdbwd, ("pred0", "tag_ind")),
        "mse_exact_fwdbwd": (mse_exact_fwdbwd, ("pred0", "pred1", "t0_exact", "t1_exact",
                                                "m0_exact", "m1_exact")),
    }


def opt_program(net: nn.Module) -> Callable[[], torch.Tensor]:
    """One adam step (lr 1e-3) of all-ones gradients on a copy of the net's
    parameters; the squared norm of the parameters after it."""
    copied = copy.deepcopy(net)
    params = _params(copied)
    optimizer = create_optimizer(copied, "adam", learning_rate=1e-3)
    ones = [torch.ones_like(p) for p in params]

    def opt_only():
        for p, g in zip(params, ones):
            p.grad = g
        optimizer.step()
        return gnorm(p.detach() for p in params)

    return opt_only


LABELS = {
    "full": "full step (fwd+bwd+opt)",
    "fwd": "fwd only (train BN)",
    "fwdbwd": "fwd+bwd (no opt)",
    "fwdbwd_eval": "fwd+bwd (eval BN)",
    "bb_fwdbwd": "backbone only fwd+bwd",
    "head_fwdbwd": "head only fwd+bwd",
    "loss_fwdbwd": "loss only fwd+bwd (full)",
    "mse_fwdbwd": "  mse part only",
    "ae_fwdbwd": "  ae part only",
    "mse_exact_fwdbwd": "  mse, exact-size targets",
    "opt_only": "optimizer only (adam)",
}


def run(device: torch.device, b: int = B, variant: str = "opt", iters: int = ITERS,
        amp_level: str = "O2") -> List[Dict]:
    net = build_net(device, variant, BACKBONE)
    loss = build_loss(SIZES)
    inputs = make_inputs(np.random.RandomState(0), b, IMAGE, SIZES, device,
                         net.backbone.out_channels)
    programs = {**net_programs(net, loss, device, amp_level), **loss_programs(loss, SIZES),
                "opt_only": (opt_program(net), ())}
    rows = []
    for name, (program, names) in programs.items():
        ms, value = time_program(program, [inputs[n] for n in names], iters, device)
        extra = f"  ({b / ms * 1000:6.1f} img/s)" if name == "full" else ""
        print(f"{LABELS[name]:30s} {ms:8.2f} ms{extra}", flush=True)
        rows.append({"variant": name, "label": LABELS[name], "ms": ms, "value": value})
    return rows


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    p = device_parser("Ablation timing of the HigherHRNet-W32 512x512 train step.")
    p.add_argument("--batch", type=int, default=B)
    p.add_argument("--variant", default="opt", choices=VARIANTS,
                   help="opt: the s2d / fused-BN configuration; base: the plain one "
                        "(the same net in the port)")
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    return run(resolve_device(args.device), args.batch, args.variant, args.iters)


if __name__ == "__main__":
    main()
