"""Video pose demo: per-frame prediction + One-Euro temporal smoothing.

Counterpart of ``tools/demo_video.py``. Top-down configs: ``--boxes`` fixes
the person crops for every frame (default: one whole-frame box).
Bottom-up configs (``pipeline_method: bottomup``) find every person per
frame; instances are matched to the previous frame by center distance
(Hungarian, ``_associate``) so that smoothing follows the same person, and
the filter resets when the instance count changes. Frames are read and
written with cv2 (``mp4v``); the predictor runs on the card as in
``tools/demo.py``, which also gives the drawing.

Usage:
    python3 -m mindpose_tpu_torch.tools.demo_video --config <cfg.yaml> --ckpt <ckpt> \\
        --video in.mp4 [--output out.mp4] [--boxes x,y,w,h ...] [--no-smooth] \\
        [--max-frames N] [--device cpu]
"""
import logging
from typing import Optional, Sequence

import numpy as np

from ..config import parse_args
from ..engine import BottomUpPredictor
from ..utils.smoothing import OneEuroFilter
from .demo import build_predictor, draw, parse_boxes
from .skeleton import resolve_skeleton

__all__ = ["main"]


def _associate(people, prev_centers):
    """Reorder instances to match the previous frame's person centers.

    The One-Euro state is keyed by array position, but bottom-up grouping
    order is not a stable identity — two people whose scores cross would
    otherwise have their trajectories low-passed into each other. Hungarian
    assignment on center distance makes position a stable identity while
    the instance count is unchanged (a count change resets the filter).
    """
    if prev_centers is None or len(prev_centers) != len(people) \
            or len(people) < 2:
        return people
    from scipy.optimize import linear_sum_assignment

    centers = people[:, :, :2].mean(axis=1)
    cost = np.linalg.norm(centers[:, None] - prev_centers[None], axis=-1)
    rows, cols = linear_sum_assignment(cost)
    order = np.empty(len(people), int)
    order[cols] = rows
    return people[order]


def main(argv: Optional[Sequence[str]] = None) -> None:
    import cv2

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv, description="video pose demo", extra_args=[
        {"names": ["--video"], "type": str, "required": True},
        {"names": ["--output"], "type": str, "default": "./demo_video_out.mp4"},
        {"names": ["--boxes"], "type": str, "nargs": "*", "default": None},
        {"names": ["--vis-thr"], "type": float, "default": 0.2},
        {"names": ["--no-smooth"], "action": "store_true"},
        {"names": ["--min-cutoff"], "type": float, "default": 1.0},
        {"names": ["--beta"], "type": float, "default": 0.007},
        {"names": ["--max-frames"], "type": int, "default": 0},
        {"names": ["--device"], "default": None,
         "help": "where the model runs (default: the current CUDA device)"},
    ])
    skeleton = resolve_skeleton(args)
    predictor = build_predictor(args, args.device)
    bottomup = isinstance(predictor, BottomUpPredictor)

    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise FileNotFoundError(args.video)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(args.output, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    boxes = None if bottomup else parse_boxes(args.boxes, width, height)

    smoother = None
    prev_centers = None
    if not args.no_smooth:
        smoother = OneEuroFilter(freq=fps, min_cutoff=args.min_cutoff, beta=args.beta)

    frames = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if bottomup:
                people, _scores = predictor(rgb)
                people = np.asarray([p[:, :3] for p in people]) if len(people) \
                    else np.zeros((0, args.num_joints, 3))
            else:
                people = np.asarray(predictor(rgb, boxes))
            if smoother is not None:
                if not people.size:
                    # detection gap: drop track state so re-detections start a
                    # fresh track instead of associating against stale centers
                    prev_centers = None
                    smoother.reset()
                else:
                    # smooth coordinates only; a shape change (new or lost
                    # person) resets the filter through its shape check
                    if bottomup:
                        people = _associate(people, prev_centers)
                        prev_centers = people[:, :, :2].mean(axis=1)
                    people = people.copy()
                    people[..., :2] = smoother(people[..., :2])
            draw(frame, people, args.vis_thr, skeleton)
            writer.write(frame)
            frames += 1
            if args.max_frames and frames >= args.max_frames:
                break
    finally:
        cap.release()
        writer.release()
    logging.info("wrote %s (%d frames @ %.1f fps)", args.output, frames, fps)


if __name__ == "__main__":
    main()
