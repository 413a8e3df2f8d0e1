"""A converted pretrained backbone's warm start against training from scratch, equal steps.

Counterpart of ``tools/exp_warmstart.py``. The published recipes start
from ImageNet-pretrained backbones (``backbone_pretrained: true``); no
published checkpoint can be fetched here, so the experiment proves the
mechanism end to end through the real conversion path instead:

  1. pretrain a backbone on synthetic domain A (another render seed),
  2. export it with ``models/convert_source.export_backbone_state`` ->
     ``utils/ms_ckpt.write_ms_checkpoint`` (a MindSpore-wire ``.ckpt``, as a
     published one is),
  3. convert it with ``python3 -m mindpose_tpu_torch.tools.convert_ckpt``
     (the CLI a user would run, in a process of its own),
  4. train on domain B from scratch and from the converted backbone at equal
     steps, paired seeds, and compare the held-out AP trajectories.

A user with the real ``hrnet_w32_imagenet.ckpt`` runs steps 3-4. Training
and evaluation are ``ablate_accuracy``'s ``train_arm`` and
``eval_checkpoint`` (the ``plain`` arm), on the GPU unless ``--device``
says otherwise.

    python3 -m mindpose_tpu_torch.tools.exp_warmstart --epochs 60 --pretrain-epochs 60 \\
        --out docs/experiments/warmstart.json [--device cpu]
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..models.convert_source import export_backbone_state
from ..utils.ms_ckpt import write_ms_checkpoint
from .ablate_accuracy import eval_checkpoint, make_data, train_arm
from .make_synthetic_coco import generate_split
from .timing import resolve_device

__all__ = ["REPO", "build_pretrained_ckpt", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_pretrained_ckpt(root: str, arch: str, head: str, epochs: int, batch_size: int,
                          train_images: int = 160,
                          device: Optional[torch.device] = None) -> str:
    """Pretrain on domain A, export through the real .ckpt + converter path;
    returns the converted file (``<root>/<arch>_domain_a.pth``)."""
    dom_a = os.path.join(root, "domain_a")
    generate_split(os.path.join(dom_a, "train"), train_images, seed=50, people_per_img=3)
    data_a = {"train": (os.path.join(dom_a, "train", "images"),
                        os.path.join(dom_a, "train", "annotations.json"))}
    logging.info("pretraining %s on domain A (%d epochs)...", arch, epochs)
    net = train_arm("plain", 100, data_a, epochs, batch_size, arch, head, device=device)

    exported = export_backbone_state(arch, net.backbone.state_dict(), naming="mindspore")
    ckpt = os.path.join(root, f"{arch}_domain_a.ckpt")
    write_ms_checkpoint(ckpt, exported)
    logging.info("wrote MindSpore-wire checkpoint %s (%d tensors)", ckpt, len(exported))

    converted = os.path.join(root, f"{arch}_domain_a.pth")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-m", "mindpose_tpu_torch.tools.convert_ckpt",
         "--src", ckpt, "--arch", arch, "--out", converted, "--check"],
        env=env, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"convert_ckpt failed:\n{r.stderr[-2000:]}")
    logging.info("converted via tools/convert_ckpt.py -> %s", converted)
    return converted


def main(argv: Optional[List[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="hrnet_w32")
    p.add_argument("--head", default="hrnet_head")
    p.add_argument("--epochs", type=int, default=60, help="domain-B training epochs per arm")
    p.add_argument("--pretrain-epochs", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seeds", default="0,1")
    p.add_argument("--eval-every", type=int, default=15)
    p.add_argument("--train-images", type=int, default=160)
    p.add_argument("--val-images", type=int, default=240)
    p.add_argument("--data-root", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="where the tool runs (default: the current CUDA device)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    root = args.data_root or tempfile.mkdtemp(prefix="warmstart_")
    converted = os.path.join(root, f"{args.arch}_domain_a.pth")
    if not os.path.exists(converted):
        converted = build_pretrained_ckpt(root, args.arch, args.head, args.pretrain_epochs,
                                          args.batch_size, args.train_images, device)

    dom_b = os.path.join(root, "domain_b")
    data_b = make_data(dom_b, args.train_images, args.val_images, 3)

    runs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        for init, path in (("scratch", ""), ("converted", converted)):
            traj = {}

            def at_milestone(epoch, net, _traj=traj, _init=init, _seed=seed):
                if epoch % args.eval_every == 0 or epoch == args.epochs:
                    r = eval_checkpoint(net, data_b, {"shift_coordinate": False},
                                        device=device)
                    _traj[epoch] = float(r["AP"])
                    logging.info("[%s seed=%d] ep%d AP=%.4f", _init, _seed, epoch,
                                 _traj[epoch])

            train_arm("plain", seed, data_b, args.epochs, args.batch_size, args.arch,
                      args.head, pretrained_path=path, milestone_eval=at_milestone,
                      device=device)
            rec = {"init": init, "seed": seed, "trajectory": traj,
                   "final_AP": traj.get(args.epochs)}
            runs.append(rec)
            print(json.dumps(rec), flush=True)

    by_init = {}
    for r in runs:
        by_init.setdefault(r["init"], []).append(r["final_AP"])
    deltas = [c - s for c, s in zip(by_init.get("converted", []), by_init.get("scratch", []))]
    summary = {
        k: {"mean": round(float(np.mean(v)), 4),
            "std": round(float(np.std(v)), 4), "aps": v}
        for k, v in by_init.items()
    }
    if deltas:
        summary["paired_delta_converted_minus_scratch"] = {
            "mean": round(float(np.mean(deltas)), 4),
            "per_seed": [round(d, 4) for d in deltas],
        }
    report = {"protocol": vars(args), "runs": runs, "summary": summary}
    print(json.dumps({"summary": summary}, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        logging.info("wrote %s", args.out)
    return report


if __name__ == "__main__":
    main()
