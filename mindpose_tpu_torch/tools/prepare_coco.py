"""Dataset bootstrap: download + extract COCO2017 keypoints with a rank-0
file-signal barrier.

Copy of the JAX package's ``tools/prepare_coco.py``: in a multi-host job,
only rank 0 downloads and extracts; the others wait on a completion marker,
then all proceed to training. The rank is torchrun's ``RANK``, or 0, where
the original asks ``jax.process_index()``. ``--dry-run`` prints the plan and
the expected layout and touches no network; tests/test_torch_tools.py holds
that plan equal to the original's.

Usage:
    python3 -m mindpose_tpu_torch.tools.prepare_coco --data-dir data/coco \
        [--detection-results] [--dry-run]
"""
import argparse
import os
import time

from ..utils.download import DownLoad

_URLS = {
    "train_images": "http://images.cocodataset.org/zips/train2017.zip",
    "val_images": "http://images.cocodataset.org/zips/val2017.zip",
    "annotations": "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
}
_DET_RESULTS_URL = (
    "https://download.openmmlab.com/mmpose/datasets/"
    "COCO_val2017_detections_AP_H_56_person.json"
)


def _rank() -> int:
    """This process's rank: torchrun's ``RANK``, or 0 outside a launch."""
    return int(os.environ.get("RANK", "0"))


def main() -> None:
    parser = argparse.ArgumentParser(description="prepare COCO2017 keypoints")
    parser.add_argument("--data-dir", default="data/coco")
    parser.add_argument(
        "--detection-results", action="store_true",
        help="also fetch the person detection results used for val",
    )
    parser.add_argument("--timeout", type=float, default=3600.0)
    parser.add_argument(
        "--dry-run", action="store_true",
        help="print the download/extract plan and the expected final layout "
        "without touching the network (for zero-egress smoke tests)",
    )
    args = parser.parse_args()

    if args.dry_run:
        print(f"data dir: {os.path.abspath(args.data_dir)}")
        for name, url in _URLS.items():
            sub = "images" if "images" in name else "."
            print(f"  would download+extract {name}: {url} -> {sub}/")
        if args.detection_results:
            print(f"  would download {_DET_RESULTS_URL} -> "
                  "person_detection_results/")
        print("expected final layout:")
        for p in (
            "images/train2017/  (118287 jpgs)",
            "images/val2017/  (5000 jpgs)",
            "annotations/person_keypoints_train2017.json",
            "annotations/person_keypoints_val2017.json",
            "person_detection_results/COCO_val2017_detections_AP_H_56_person.json",
            ".prepare_done  (rank-0 barrier marker)",
        ):
            exists = os.path.exists(
                os.path.join(args.data_dir, p.split()[0].rstrip("/")))
            print(f"  {'[have]' if exists else '[need]'} {p}")
        return

    os.makedirs(args.data_dir, exist_ok=True)
    marker = os.path.join(args.data_dir, ".prepare_done")

    if _rank() == 0:
        dl = DownLoad()
        for name, url in _URLS.items():
            print(f"downloading {name} ...")
            dl.download_and_extract_archive(
                url, download_path=args.data_dir,
                extract_path=os.path.join(args.data_dir, "images")
                if "images" in name else args.data_dir,
            )
        if args.detection_results:
            dl.download_url(
                _DET_RESULTS_URL,
                path=os.path.join(args.data_dir, "person_detection_results"),
            )
        with open(marker, "w") as f:
            f.write("done")
        print("prepare complete")
    else:
        # file-signal barrier
        start = time.time()
        while not os.path.exists(marker):
            if time.time() - start > args.timeout:
                raise TimeoutError("rank-0 data preparation did not finish")
            time.sleep(5)
        print("rank-0 preparation observed; proceeding")


if __name__ == "__main__":
    main()
