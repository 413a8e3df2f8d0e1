"""Convert MPII keypoint annotations to COCO format for this framework.

Copy of the JAX package's ``tools/convert_mpii.py`` (numpy, and cv2 with
``--img-root``); tests/test_torch_tools.py holds its output equal to the
original's.

The MPII benchmark ships 16-joint annotations as a MATLAB struct; the
widely-mirrored JSON export of it is a list of records::

    {"image": "015601864.jpg", "center": [594.0, 257.0], "scale": 3.021,
     "joints": [[x, y] * 16], "joints_vis": [0/1 * 16]}

(center/scale in MPII convention: scale = person height / 200 px, and the
released annotations place center.y slightly above the person — the
standard correction shifts it down by 15 * scale before use).

This tool emits a COCO-style keypoint JSON the existing stack consumes
unchanged (``coco_topdown`` dataset + ``topdown_keypoint`` PCKh evaluator)
— a deliberate design choice: one annotation schema in the framework, with
per-benchmark converters at the edge, rather than a dataset class per
format.

Usage:
    python3 -m mindpose_tpu_torch.tools.convert_mpii --input mpii_train.json \
        --output mpii_train_coco.json [--img-root images/]

Passing --img-root reads real image sizes from disk; otherwise sizes are
estimated from the annotation extents (sufficient for training/eval, which
only use bbox geometry).
"""
import argparse
import json
import os
from collections import defaultdict

import numpy as np

MPII_NUM_JOINTS = 16
# r_ankle..r_hip | l_hip..l_ankle | pelvis thorax upper_neck head_top |
# r_wrist..r_shoulder | l_shoulder..l_wrist
MPII_JOINT_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "pelvis", "thorax", "upper_neck", "head_top",
    "right_wrist", "right_elbow", "right_shoulder", "left_shoulder",
    "left_elbow", "left_wrist",
]
MPII_FLIP_PAIRS = [[0, 5], [1, 4], [2, 3], [10, 15], [11, 14], [12, 13]]
# PCKh norm joints: head segment = (head_top, upper_neck)
MPII_HEAD_PAIR = (9, 8)
PIXEL_STD = 200.0
CENTER_Y_SHIFT = 15.0  # standard MPII center correction, in scale units


def convert(records, img_root=None, apply_center_shift=True):
    """MPII json records -> COCO dataset dict."""
    images, annotations = [], []
    name_to_id = {}
    sizes = defaultdict(lambda: [0.0, 0.0])  # fallback extent per image

    for rec in records:
        name = rec["image"]
        joints = np.asarray(rec["joints"], np.float64).reshape(-1, 2)
        # estimated canvas must cover the scale*200 person box too (not just
        # the joints): downstream _sanitize_bbox clips boxes to the image, so
        # an undersized estimate would silently shift every crop's
        # center/scale off the MPII protocol
        center = np.asarray(rec["center"], np.float64)
        scale = float(np.asarray(rec["scale"]).reshape(-1)[0])
        if apply_center_shift:
            center = center + [0.0, CENTER_Y_SHIFT * scale]
        half = scale * PIXEL_STD / 2
        sizes[name][0] = max(sizes[name][0], float(joints[:, 0].max()) + 50,
                             center[0] + half + 1)
        sizes[name][1] = max(sizes[name][1], float(joints[:, 1].max()) + 50,
                             center[1] + half + 1)

    for ann_id, rec in enumerate(records, start=1):
        name = rec["image"]
        if name not in name_to_id:
            image_id = len(name_to_id) + 1
            name_to_id[name] = image_id
            if img_root:
                import cv2

                img = cv2.imread(os.path.join(img_root, name))
                if img is None:
                    raise FileNotFoundError(os.path.join(img_root, name))
                height, width = img.shape[:2]
            else:
                width, height = (int(np.ceil(v)) for v in sizes[name])
            images.append(
                {"id": image_id, "file_name": name,
                 "width": width, "height": height}
            )

        center = np.asarray(rec["center"], np.float64)
        scale = float(np.asarray(rec["scale"]).reshape(-1)[0])
        if apply_center_shift:
            center = center + [0.0, CENTER_Y_SHIFT * scale]
        side = scale * PIXEL_STD
        x0 = center[0] - side / 2
        y0 = center[1] - side / 2

        joints = np.asarray(rec["joints"], np.float64).reshape(-1, 2)
        vis = np.asarray(rec["joints_vis"], np.float64).reshape(-1)
        kpts = np.zeros((MPII_NUM_JOINTS, 3))
        kpts[: len(joints), :2] = joints
        # COCO v: 0 unlabeled, 2 labeled+visible (MPII vis is binary)
        kpts[: len(vis), 2] = np.where(vis > 0, 2.0, 0.0)
        # MPII marks invisible-but-annotated joints vis=0 with coords set;
        # treat coords == (0, 0) or negative as truly unlabeled
        unlabeled = (joints <= 0).all(axis=1)
        kpts[: len(joints), 2][unlabeled] = 0.0

        annotations.append(
            {
                "id": ann_id,
                "image_id": name_to_id[name],
                "category_id": 1,
                "bbox": [x0, y0, side, side],
                "area": side * side,
                "iscrowd": 0,
                "keypoints": kpts.reshape(-1).tolist(),
                "num_keypoints": int((kpts[:, 2] > 0).sum()),
            }
        )

    categories = [
        {
            "id": 1,
            "name": "person",
            "keypoints": MPII_JOINT_NAMES,
            "skeleton": [],
        }
    ]
    return {"images": images, "annotations": annotations,
            "categories": categories}


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", required=True, help="MPII json")
    parser.add_argument("--output", required=True, help="COCO json to write")
    parser.add_argument("--img-root", default=None,
                        help="image dir for real width/height")
    parser.add_argument("--no-center-shift", action="store_true",
                        help="skip the standard +15*scale center.y shift")
    args = parser.parse_args()

    with open(args.input) as f:
        records = json.load(f)
    dataset = convert(records, img_root=args.img_root,
                      apply_center_shift=not args.no_center_shift)
    with open(args.output, "w") as f:
        json.dump(dataset, f)
    print(
        f"wrote {args.output}: {len(dataset['images'])} images, "
        f"{len(dataset['annotations'])} annotations"
    )


if __name__ == "__main__":
    main()
