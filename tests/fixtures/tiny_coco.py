"""Seeded synthetic COCO keypoint data of the evaluation fixture (numpy and cv2 only).

Each frame holds two persons, one in each half: a filled rectangle with a
coloured disc at each of its 17 joints, on a noisy background with
distractor discs. Left/right joints share a colour and sit at mirrored
positions in the box, so a horizontal flip maps a person onto a valid
person (flip augmentation and flip TTA stay label-consistent). Images are
PNG, so every libpng decodes the same bytes.

``tests/make_torch_eval_fixture.py`` trains the fixture checkpoint on the
train split; the tests and ``chip_smoke.py`` evaluate it on the val split.

Usage: ``write_split(root, num_images, seed)`` -> (image_root, annotation_path).
"""
import json
import os

import cv2
import numpy as np

PERSON_CATEGORY = {
    "id": 1,
    "name": "person",
    "supercategory": "person",
    "keypoints": [
        "nose", "left_eye", "right_eye", "left_ear", "right_ear",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hip", "right_hip",
        "left_knee", "right_knee", "left_ankle", "right_ankle",
    ],
    "skeleton": [],
}
FRAME_HW = (160, 224)
BOX_WH = (56, 112)  # at scale 1; each person is drawn at a scale in [0.8, 1.2]
TRAIN_IMAGES, TRAIN_SEED = 96, 0
VAL_IMAGES, VAL_SEED = 16, 1

# box-relative (x, y) of the nose and of each left joint; the right joint of
# a pair sits at (1 - x, y)
_LEFT = {0: (0.50, 0.06), 1: (0.42, 0.04), 3: (0.33, 0.07), 5: (0.28, 0.22),
         7: (0.18, 0.38), 9: (0.12, 0.54), 11: (0.36, 0.56), 13: (0.34, 0.75),
         15: (0.33, 0.93)}


def _joint_xy(k: int):
    if k == 0:
        return _LEFT[0]
    left = (k - 1) // 2 * 2 + 1
    x, y = _LEFT[left]
    return (x, y) if k == left else (1.0 - x, y)


def _joint_color(k: int):
    kc = k if k == 0 else (k - 1) // 2 * 2 + 1  # a pair shares its colour
    return (int(50 + 12 * kc) % 256, int(250 - 13 * kc) % 256, int(40 + 37 * kc) % 256)


def write_split(root: str, num_images: int, seed: int):
    """Write ``num_images`` frames and their annotations under ``root``."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    h, w = FRAME_HW
    images, annotations = [], []
    for img_id in range(1, num_images + 1):
        img = rng.randint(0, 70, size=(h, w, 3), dtype=np.uint8)
        for _ in range(4):  # distractors
            cv2.circle(img, (int(rng.randint(0, w)), int(rng.randint(0, h))),
                       int(rng.randint(3, 10)),
                       tuple(int(c) for c in rng.randint(0, 255, 3)), -1)
        for half in range(2):
            scale = rng.uniform(0.8, 1.2)
            bw, bh = int(BOX_WH[0] * scale), int(BOX_WH[1] * scale)
            x0 = int(half * w // 2 + rng.randint(2, w // 2 - bw - 2))
            y0 = int(rng.randint(2, h - bh - 2))
            cv2.rectangle(img, (x0, y0), (x0 + bw, y0 + bh), (170, 140, 110), -1)
            kpts = []
            for k in range(17):
                gx, gy = _joint_xy(k)
                kx = x0 + (gx + rng.uniform(-0.03, 0.03)) * bw
                ky = y0 + (gy + rng.uniform(-0.03, 0.03)) * bh
                cv2.circle(img, (int(kx), int(ky)), 3, _joint_color(k), -1)
                kpts.extend([float(kx), float(ky), 2])
            annotations.append({
                "id": len(annotations) + 1, "image_id": img_id, "category_id": 1,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
                "keypoints": kpts, "num_keypoints": 17,
            })
        fname = f"{img_id:012d}.png"
        cv2.imwrite(os.path.join(img_dir, fname), img)
        images.append({"id": img_id, "file_name": fname, "height": h, "width": w})
    ann_path = os.path.join(root, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [PERSON_CATEGORY]}, f)
    return img_dir, ann_path


def write_val(root: str):
    """The fixture's val split under ``root``: (image_root, annotation_path)."""
    return write_split(root, VAL_IMAGES, VAL_SEED)
