"""Generate a synthetic COCO-keypoints benchmark (no real data required).

Copy of the JAX package's ``tools/make_synthetic_coco.py`` (numpy and cv2
only). Renders multi-person scenes of textured rectangles with per-joint
circular markers (colors symmetric within left/right flip pairs so flip
augmentation stays label-consistent), with varied scales/positions and
distractor blobs. tests/test_torch_tools.py holds its files equal to the
original's.

Usage:
    python3 -m mindpose_tpu_torch.tools.make_synthetic_coco --out /tmp/syncoco \
        [--train-images 160] [--val-images 40] [--people 2] [--layout grid|person]
"""
import argparse
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


def _joint_color(k: int):
    # canonical pair index: left/right share a color (flip-consistent)
    kc = k if k == 0 else (k - 1) // 2 * 2 + 1
    return (
        int(50 + 12 * kc) % 256,
        int(250 - 13 * kc) % 256,
        int(40 + 37 * kc) % 256,
    )


# "grid" is the historical layout (joint k at column k%4, row k//4): its
# colors are flip-pair symmetric but its POSITIONS are not, so horizontal
# flip augmentation / TTA would create contradictory labels. "person"
# places every left/right pair at mirrored box-relative positions
# (gx_right = 1 - gx_left, same gy), making flip aug AND hflip TTA
# label-consistent — use it for any benchmark that exercises the
# reference's published flip recipe.
_PERSON_GRID_LEFT = {
    0: (0.50, 0.06),   # nose (self-paired)
    1: (0.42, 0.04),   # eyes
    3: (0.33, 0.07),   # ears
    5: (0.30, 0.22),   # shoulders
    7: (0.21, 0.38),   # elbows
    9: (0.17, 0.54),   # wrists
    11: (0.37, 0.56),  # hips
    13: (0.36, 0.75),  # knees
    15: (0.35, 0.93),  # ankles
}


def _joint_grid(k: int, layout: str):
    if layout == "grid":
        return 0.15 + 0.23 * (k % 4), 0.08 + 0.21 * (k // 4)
    if k == 0:
        return _PERSON_GRID_LEFT[0]
    left = (k - 1) // 2 * 2 + 1
    gx, gy = _PERSON_GRID_LEFT[left]
    return (gx, gy) if k == left else (1.0 - gx, gy)


def generate_split(root: str, num_images: int, seed: int,
                   people_per_img: int = 2, layout: str = "grid") -> None:
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        h, w = 360, 480
        img = rng.randint(0, 70, size=(h, w, 3), dtype=np.uint8)
        for _ in range(6):  # distractors
            cv2.circle(
                img, (rng.randint(0, w), rng.randint(0, h)),
                rng.randint(5, 20),
                tuple(int(c) for c in rng.randint(0, 255, 3)), -1,
            )
        for _ in range(people_per_img):
            scale = rng.uniform(0.7, 1.6)
            bw, bh = int(90 * scale), int(170 * scale)
            x0 = rng.randint(5, max(6, w - bw - 5))
            y0 = rng.randint(5, max(6, h - bh - 5))
            cv2.rectangle(img, (x0, y0), (x0 + bw, y0 + bh), (170, 140, 110), -1)
            kpts = []
            for k in range(17):
                bx, by = _joint_grid(k, layout)
                gx = bx + rng.uniform(-0.04, 0.04)
                gy = by + rng.uniform(-0.04, 0.04)
                kx, ky = x0 + gx * bw, y0 + gy * bh
                cv2.circle(
                    img, (int(kx), int(ky)), max(3, int(4 * scale)),
                    _joint_color(k), -1,
                )
                kpts.extend([float(kx), float(ky), 2])
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": 1,
                "bbox": [float(x0), float(y0), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
                "keypoints": kpts, "num_keypoints": 17,
                "segmentation": [
                    [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]
                ],
            })
            ann_id += 1
        fname = f"{img_id:012d}.jpg"
        cv2.imwrite(os.path.join(root, "images", fname), img)
        images.append({"id": img_id, "file_name": fname, "height": h, "width": w})
    ann = {
        "images": images,
        "annotations": annotations,
        "categories": [PERSON_CATEGORY],
    }
    with open(os.path.join(root, "annotations.json"), "w") as f:
        json.dump(ann, f)
    print(f"{root}: {num_images} images, {len(annotations)} annotations")


def main() -> None:
    p = argparse.ArgumentParser(description="synthetic COCO keypoints")
    p.add_argument("--out", required=True)
    p.add_argument("--train-images", type=int, default=160)
    p.add_argument("--val-images", type=int, default=40)
    p.add_argument("--people", type=int, default=2,
                   help="persons per frame (bottom-up benchmarks want 3+)")
    p.add_argument("--layout", default="grid", choices=["grid", "person"],
                   help="joint layout: 'grid' (historical, flip-asymmetric "
                        "positions) or 'person' (flip-pair mirrored — valid "
                        "under flip augmentation and hflip TTA)")
    args = p.parse_args()
    generate_split(os.path.join(args.out, "train"), args.train_images, seed=0,
                   people_per_img=args.people, layout=args.layout)
    generate_split(os.path.join(args.out, "val"), args.val_images, seed=1,
                   people_per_img=args.people, layout=args.layout)


if __name__ == "__main__":
    main()
