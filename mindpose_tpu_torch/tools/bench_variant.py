"""Quick train-step throughput comparison across model/config variants.

Counterpart of ``tools/bench_variant.py``: the flagship step (adamw at 1e-3
with weight decay 0.05, bf16 autocast: O2) of a backbone and head at batch
``--batch``, for each HRNet ``backbone_setting`` variant of ``VARIANTS``.
The JAX package's TPU rewrites (``stem_s2d``, ``branch0_s2d``,
``bn_grad_stats: fused``) change no result, and the port builds the plain
layers for them, so ``s2d``, ``b0s2d``, ``bnfused`` and their combinations
time the same net as ``base``; ``bn4``, ``bn8``, ``s2d_bn4`` (subsampled
BatchNorm statistics) and ``bnfrozen`` were measured to diverge, and the
port's HRNet refuses them (``NotImplementedError``). A SimCC head trains on
``kl_discret`` with bin-label targets, as ``configs/simcc``; any other head
on ``joint_mse`` heatmaps. Timed as the JAX tool: 3 warm steps, then
``iters`` steps by the host's clock with one ``torch.cuda.synchronize``.

    python3 -m mindpose_tpu_torch.tools.bench_variant --variants base,s2d \\
        [--backbone hrnet_w32] [--head hrnet_head] [--head-args JSON] \\
        [--batch 128] [--accum 1] [--iters 20] [--device cpu]
"""
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import create_loss, create_network, create_network_with_loss
from ..optim import create_optimizer
from ..parallel import build_train_step
from .timing import device_parser, resolve_device, sync

__all__ = ["VARIANTS", "AMP_LEVEL", "bench", "main"]

AMP_LEVEL = "O2"  # the JAX tool's bf16 net
VARIANTS = {
    "base": {},
    "s2d": {"stem_s2d": True},
    "bn4": {"bn_stats_frac": 0.25},
    "bn8": {"bn_stats_frac": 0.125},
    "s2d_bn4": {"stem_s2d": True, "bn_stats_frac": 0.25},
    "bnfused": {"bn_grad_stats": "fused"},
    "bnfrozen": {"bn_grad_stats": "frozen"},
    "b0s2d": {"branch0_s2d": True},
    "b0s2d_bnfused": {"branch0_s2d": True, "bn_grad_stats": "fused"},
}



def bench(backbone_args, B=128, iters=20, backbone="hrnet_w32", head="hrnet_head",
          head_args=None, accum=1, device: Optional[torch.device] = None) -> Tuple[float, float]:
    """(ms per step, images per second) of the variant's train step."""
    device = resolve_device(device)
    torch.manual_seed(0)
    with torch.device(device):  # initialised where it trains
        net = create_network(backbone, head, backbone_args=backbone_args,
                             head_args=head_args or {}).to(device)
    rng = np.random.RandomState(0)
    if head == "simcc_head":
        # bin-label targets, KL loss (configs/simcc)
        ratio = (head_args or {}).get("split_ratio", 2.0)
        bins = int(192 * ratio) + int(256 * ratio)
        loss = create_loss("kl_discret", use_target_weight=True)
        y = rng.rand(B, 17, bins).astype(np.float32)
        y /= y.sum(-1, keepdims=True)
        y = torch.from_numpy(y)
    else:
        loss = create_loss("joint_mse", use_target_weight=True)
        y = torch.from_numpy(rng.rand(B, 64, 48, 17).astype(np.float32)).permute(0, 3, 1, 2)
    nwl = create_network_with_loss(net, loss, has_extra_inputs=True)
    optimizer = create_optimizer(net, "adamw", learning_rate=1e-3, weight_decay=0.05)
    step = build_train_step(nwl, optimizer, accum_steps=accum, amp_level=AMP_LEVEL)
    x = torch.from_numpy(rng.rand(B, 256, 192, 3).astype(np.float32)).permute(0, 3, 1, 2)
    x, y = x.contiguous().to(device), y.contiguous().to(device)
    w = torch.ones(B, 17, device=device)
    for _ in range(3):
        step(x, y, w)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(x, y, w)
    sync(device)
    dt = (time.perf_counter() - t0) / iters
    return dt * 1000, B / dt


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = device_parser(__doc__.split("\n", 1)[0])
    ap.add_argument("--variants", default="base,s2d",
                    help="hrnet backbone_setting variants")
    ap.add_argument("--backbone", default="hrnet_w32")
    ap.add_argument("--head", default="hrnet_head")
    ap.add_argument("--head-args", default="",
                    help='JSON, e.g. {"num_deconv_layers": 2, ...}')
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    head_args = json.loads(args.head_args) if args.head_args else {}
    rows = []
    for name in args.variants.split(","):
        backbone_args = VARIANTS[name] if args.backbone.startswith("hrnet") else {}
        ms, ips = bench(backbone_args, B=args.batch, iters=args.iters, backbone=args.backbone,
                        head=args.head, head_args=head_args, accum=args.accum, device=device)
        accum_note = f" (accum {args.accum})" if args.accum > 1 else ""
        print(f"{args.backbone}/{name:8s} {ms:7.2f} ms/step   "
              f"{ips:8.1f} img/s{accum_note}", flush=True)
        rows.append({"variant": name, "ms": ms, "images_per_sec": ips})
    return rows


if __name__ == "__main__":
    main()
