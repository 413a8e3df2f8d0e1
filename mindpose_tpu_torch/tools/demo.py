"""Demo CLI: run pose prediction on images and draw skeletons.

Counterpart of ``tools/demo.py``. Top-down configs: each ``--boxes x,y,w,h``
is a person box, and without ``--boxes`` the whole image is one box; the
``TopDownPredictor`` crops, runs the net and decodes (on the card through
the decode kernel, one launch per 32 boxes). Bottom-up configs
(``pipeline_method: bottomup``) need no boxes: the ``BottomUpPredictor``
finds every person (on the card through the grouping kernel, one launch
per image). Each image is written to ``--output-dir`` under its own name,
with the skeleton's edges in green and the joints above ``--vis-thr`` in
red, as the JAX tool draws them.

The checkpoint is the port's own or the JAX package's flax msgpack file;
without ``--ckpt`` the net's initial weights (torch seed 0) are drawn, with
a warning. It runs on the current CUDA device unless ``--device`` says
otherwise, and raises without CUDA.

Usage:
    python3 -m mindpose_tpu_torch.tools.demo --config <cfg.yaml> --ckpt <ckpt> \\
        --image-dir <dir> [--boxes x,y,w,h ...] [--output-dir ./demo_out] [--device cpu]
"""
import glob
import logging
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..config import parse_args
from ..engine import BottomUpPredictor, TopDownPredictor
from ..models import create_network_from_config
from ..utils.checkpoint import load_net_state_dict
from .skeleton import resolve_skeleton

__all__ = ["build_predictor", "parse_boxes", "draw", "main", "SEED"]

SEED = 0  # the torch seed of the initial weights drawn without --ckpt


def build_predictor(args: Any, device: Optional[torch.device] = None):
    """The config's predictor, ``TopDownPredictor`` or (``pipeline_method:
    bottomup``) ``BottomUpPredictor``, with ``args.ckpt``'s weights (or seeded
    initial ones) on ``device`` (default: the current CUDA device)."""
    if getattr(args, "ckpt", None):
        with torch.device("meta"):
            skeleton = create_network_from_config(args)
        net_state = load_net_state_dict(args.ckpt, skeleton)
    else:
        logging.warning("no --ckpt: drawing the net's initial weights (torch seed %d)", SEED)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            net_state = create_network_from_config(args).state_dict()
    if getattr(args, "pipeline_method", "topdown") == "bottomup":
        return BottomUpPredictor.from_config(args, net_state, device=device)
    return TopDownPredictor.from_config(args, net_state, device=device)


def parse_boxes(boxes: Optional[Sequence[str]], width: int, height: int) -> np.ndarray:
    """``--boxes`` as xywh rows, or the whole image as one box."""
    if boxes:
        return np.array([[float(v) for v in b.split(",")] for b in boxes], np.float32)
    return np.array([[0, 0, width, height]], np.float32)


def draw(frame: np.ndarray, people: np.ndarray, vis_thr: float, skeleton) -> None:
    """Draw each person's edges (green) and visible joints (red) on a BGR frame."""
    import cv2

    for person in people:
        for a, b in skeleton:
            if max(a, b) < len(person) and person[a, 2] > vis_thr and person[b, 2] > vis_thr:
                cv2.line(frame, (int(person[a, 0]), int(person[a, 1])),
                         (int(person[b, 0]), int(person[b, 1])), (0, 255, 0), 2)
        # bottom-up preds carry tag columns beyond (x, y, score)
        for x, y, s in person[:, :3]:
            if s > vis_thr:
                cv2.circle(frame, (int(x), int(y)), 3, (0, 0, 255), -1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import cv2

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv, description="pose demo", extra_args=[
        {"names": ["--image-dir"], "type": str, "required": True},
        {"names": ["--boxes"], "type": str, "nargs": "*", "default": None},
        {"names": ["--output-dir"], "type": str, "default": "./demo_out"},
        {"names": ["--vis-thr"], "type": float, "default": 0.2},
        {"names": ["--device"], "default": None,
         "help": "where the model runs (default: the current CUDA device)"},
    ])
    skeleton = resolve_skeleton(args)
    os.makedirs(args.output_dir, exist_ok=True)
    predictor = build_predictor(args, args.device)
    bottomup = isinstance(predictor, BottomUpPredictor)

    for path in sorted(glob.glob(os.path.join(args.image_dir, "*"))):
        if os.path.splitext(path)[1].lower() not in (".jpg", ".jpeg", ".png"):
            continue
        bgr = cv2.imread(path)
        img = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if bottomup:
            preds, _scores = predictor(img)
        else:
            preds = predictor(img, parse_boxes(args.boxes, img.shape[1], img.shape[0]))
        draw(bgr, preds, args.vis_thr, skeleton)
        out = os.path.join(args.output_dir, os.path.basename(path))
        cv2.imwrite(out, bgr)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
