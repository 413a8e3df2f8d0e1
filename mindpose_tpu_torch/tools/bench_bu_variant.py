"""Bottom-up (HigherHRNet-W32 512x512) train-step variant comparison.

Counterpart of ``tools/bench_bu_variant.py``: ``bench.bench_bottomup_step``'s
exact step with backbone and head variants. ``remat`` recomputes each
exchange unit in the backward (``torch.utils.checkpoint``); the JAX
package's exact TPU rewrites (``bn_grad_stats: fused``, ``branch0_s2d``,
``stem_s2d`` and the head's ``s2d_refine``, the ``s2d*`` variants) build
the plain layers here, so they time the same net as ``base``; ``bnfrozen``
stops the backbone's BatchNorm statistics' gradients
(``models/common.BatchNorm2d``), an experiment knob measured to diverge in
training.

    python3 -m mindpose_tpu_torch.tools.bench_bu_variant --variants base,bnfused \\
        [--batch 24] [--iters 10] [--device cpu]
"""
from typing import Dict, List, Optional

from . import bench
from .timing import device_parser, resolve_device

__all__ = ["VARIANTS", "main"]

# (backbone_args, head_args) per variant; s2d refers to the head's
# space-to-depth refinement stage
VARIANTS = {
    "base": ({}, {"s2d_refine": False}),
    "bnfused": ({"bn_grad_stats": "fused"}, {"s2d_refine": False}),
    "bnfrozen": ({"bn_grad_stats": "frozen"}, {"s2d_refine": False}),
    "remat": ({"remat": True}, {"s2d_refine": False}),
    "s2d": ({}, {}),
    "s2d_bnfused": ({"bn_grad_stats": "fused"}, {}),
    "s2d_b0": ({"branch0_s2d": True}, {}),
    "s2d_b0_bnfused": ({"branch0_s2d": True, "bn_grad_stats": "fused"}, {}),
    "s2d_b0_stem": ({"branch0_s2d": True, "stem_s2d": True,
                     "bn_grad_stats": "fused"}, {}),
}


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = device_parser(__doc__.split("\n", 1)[0])
    ap.add_argument("--variants", default="base,bnfused")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for name in args.variants.split(","):
        bargs, hargs = VARIANTS[name]
        r = bench.bench_bottomup_step(
            batch_per_chip=args.batch, iters=args.iters,
            backbone_args=bargs, head_args=hargs, device=device)
        print(f"higher_hrnet/{name:14s} "
              f"{r['higher_hrnet_step_time_ms']:8.2f} ms/step   "
              f"{r['higher_hrnet_train_images_per_sec_per_chip']:7.1f} img/s/chip",
              flush=True)
        rows.append({"variant": name, **r})
    return rows


if __name__ == "__main__":
    main()
