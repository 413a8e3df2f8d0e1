"""Seeded synthetic MPII keypoint data (numpy and cv2 only).

``mpii_records`` draws records of MPII's json export (16 joints, MPII's
center and scale, the head joints 8 and 9 always labeled so that PCKh is
defined) as ``tests/data/test_mpii_convert.py`` draws them. ``write_split``
converts them to COCO format with ``tools/convert_mpii.convert`` and paints
each person's box and labeled joints into frames of the converter's
estimated size: a joint is a disc whose colour its flip partner shares, as
the synthetic COCO frames have them. ``chip_smoke.py`` and the port's MPII
tests train and evaluate configs/mpii/hrnet_w32_mpii_tpu.yaml on it.

Usage: ``write_split(root, num_images, seed, people)`` -> (image_root, annotation_path).
"""
import importlib.util
import json
import os

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_spec = importlib.util.spec_from_file_location(
    "convert_mpii", os.path.join(ROOT, "tools", "convert_mpii.py"))
convert_mpii = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(convert_mpii)
NUM_JOINTS = convert_mpii.MPII_NUM_JOINTS
TRAIN_SEED, VAL_SEED = 0, 1


def mpii_records(rng: np.random.RandomState, num_images: int = 2, people: int = 2) -> list:
    """MPII json records: ``people`` persons in each of ``num_images`` images."""
    records = []
    for i in range(num_images):
        for _ in range(people):
            center = rng.uniform(150, 400, 2)
            scale = rng.uniform(1.0, 2.5)
            joints = center + rng.uniform(-80, 80, (NUM_JOINTS, 2))
            vis = (rng.rand(NUM_JOINTS) > 0.2).astype(float)
            # head joints always labeled so PCKh is defined
            vis[8] = vis[9] = 1.0
            records.append(
                {
                    "image": f"{i:09d}.jpg",
                    "center": center.tolist(),
                    "scale": float(scale),
                    "joints": joints.tolist(),
                    "joints_vis": vis.tolist(),
                }
            )
    return records


def _joint_color(k: int):
    partner = dict(p for pair in convert_mpii.MPII_FLIP_PAIRS for p in (pair, pair[::-1]))
    kc = min(k, partner.get(k, k))  # a flip pair shares its colour
    return int(50 + 12 * kc) % 256, int(250 - 13 * kc) % 256, int(40 + 37 * kc) % 256


def write_split(root: str, num_images: int, seed: int, people: int = 2):
    """Write ``num_images`` frames of ``people`` persons and their COCO-format
    annotations under ``root``; returns (image_root, annotation_path)."""
    rng = np.random.RandomState(seed)
    dataset = convert_mpii.convert(mpii_records(rng, num_images, people))
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    by_image = {}
    for ann in dataset["annotations"]:
        by_image.setdefault(ann["image_id"], []).append(ann)
    for image in dataset["images"]:
        h, w = image["height"], image["width"]
        img = rng.randint(0, 70, size=(h, w, 3), dtype=np.uint8)
        for ann in by_image[image["id"]]:
            x0, y0, bw, bh = ann["bbox"]
            cv2.rectangle(img, (int(x0 + 0.2 * bw), int(y0 + 0.1 * bh)),
                          (int(x0 + 0.8 * bw), int(y0 + 0.9 * bh)), (170, 140, 110), -1)
        for ann in by_image[image["id"]]:
            radius = max(3, int(ann["bbox"][2] / 60))
            for k, (x, y, v) in enumerate(np.asarray(ann["keypoints"]).reshape(-1, 3)):
                if v > 0:
                    cv2.circle(img, (int(x), int(y)), radius, _joint_color(k), -1)
        cv2.imwrite(os.path.join(img_dir, image["file_name"]), img)
    ann_path = os.path.join(root, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump(dataset, f)
    return img_dir, ann_path
