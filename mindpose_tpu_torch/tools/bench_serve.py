"""Serving latency benchmark: TopDownPredictor end-to-end per-request time.

Counterpart of ``tools/bench_serve.py``. The training benchmarks time the
step; serving cares about the wall clock from (raw image + person boxes)
to keypoints: the host's crop geometry, the device's crop, forward and
decode (on the card the decode kernel, one launch per chunk of at most
``batch`` boxes, for the heatmap families), and the fetch of the result.
This tool measures that for each family preset across request sizes
(boxes per image): per request, the median, 90th and 99th percentiles and
the boxes per second at the median. The port's predictor serves in
float32, the configs' precision (the JAX tool built bf16 nets), or with
int8 weights (``--quantize int8``); the weights are random, from torch
seed 0.

    python3 -m mindpose_tpu_torch.tools.bench_serve --models resnet50,hrnet_w32,vit_b,rle,simcc \\
        --batch-sizes 1,8,32 [--iters 30] [--quantize int8] [--out report.json] [--device cpu]
"""
import json
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine.predictor import TopDownPredictor
from ..models import create_network
from .timing import device_parser, resolve_device

__all__ = ["DATASET_SETTING", "PRESETS", "build_predictor", "draw_boxes", "bench_model", "main"]

DATASET_SETTING = {
    "image_size": [192, 256],
    "heatmap_size": [48, 64],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
    "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]],
    "upper_body_ids": list(range(11)),
}

# family presets: backbone, head (+args), decoder (+args)
PRESETS = {
    "resnet50": dict(backbone="resnet50", head="simple_baseline_head",
                     decoder="topdown_heatmap",
                     decoder_args={"shift_coordinate": True}),
    "hrnet_w32": dict(backbone="hrnet_w32", head="hrnet_head",
                      decoder="topdown_heatmap",
                      decoder_args={"shift_coordinate": True}),
    "vit_b": dict(backbone="vit_b", head="simple_baseline_head",
                  decoder="topdown_heatmap",
                  decoder_args={"shift_coordinate": True}),
    "simcc": dict(backbone="resnet50", head="simcc_head",
                  head_args={"input_size": [192, 256], "split_ratio": 2.0},
                  decoder="simcc",
                  decoder_args={"input_size": [192, 256],
                                "split_ratio": 2.0, "sigma": 6.0}),
    "rle": dict(backbone="resnet50", head="rle_head",
                decoder="regression",
                decoder_args={"input_size": [192, 256]}),
}


def build_predictor(preset: dict, batch_size: int, quantize: str = "",
                    device: Optional[torch.device] = None) -> TopDownPredictor:
    """The preset's net with random weights (torch seed 0, drawn on ``device``)
    behind a predictor."""
    device = resolve_device(device)
    torch.manual_seed(0)
    with torch.device(device):
        net = create_network(
            backbone_name=preset["backbone"],
            head_name=preset["head"],
            num_joints=17,
            head_args=preset.get("head_args"),
        )
    return TopDownPredictor(
        net,
        dataset_setting=DATASET_SETTING,
        decoder_setting=preset.get("decoder_args"),
        decoder_name=preset["decoder"],
        batch_size=batch_size,
        quantize=quantize,
        device=device,
    )


def draw_boxes(rng: np.random.RandomState, n: int, h: int, w: int) -> np.ndarray:
    """``n`` xywh boxes in an ``h`` x ``w`` image, drawn as the JAX tool draws them."""
    return np.stack([
        np.array([rng.uniform(0, w / 2), rng.uniform(0, h / 2),
                  rng.uniform(80, w / 2), rng.uniform(120, h / 2)],
                 np.float32)
        for _ in range(n)
    ])


def bench_model(name: str, batch_sizes: Sequence[int], iters: int, image: np.ndarray,
                rng: np.random.RandomState, quantize: str = "",
                device: Optional[torch.device] = None) -> dict:
    device = resolve_device(device)
    out = {}
    for bs in batch_sizes:
        predictor = build_predictor(PRESETS[name], batch_size=bs, quantize=quantize,
                                    device=device)
        h, w = image.shape[:2]
        boxes = draw_boxes(rng, bs, h, w)
        preds = predictor(image, boxes)  # warm call
        assert preds.shape == (bs, 17, 3)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            predictor(image, boxes)  # returns numpy: the result is fetched
            times.append(time.perf_counter() - t0)
        ms = np.asarray(times) * 1000
        out[f"batch{bs}"] = {
            "p50_ms": round(float(np.percentile(ms, 50)), 2),
            "p90_ms": round(float(np.percentile(ms, 90)), 2),
            "p99_ms": round(float(np.percentile(ms, 99)), 2),
            "boxes_per_sec": round(bs / float(np.median(times)), 1),
        }
        del predictor
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    p = device_parser(__doc__.split("\n", 1)[0])
    p.add_argument("--models", default="resnet50,hrnet_w32,vit_b,rle,simcc")
    p.add_argument("--batch-sizes", default="1,8,32")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--image-hw", default="480,640")
    p.add_argument("--quantize", default="",
                   help="weight quantization mode ('' or 'int8')")
    p.add_argument("--out", default="", help="write the JSON report here")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.RandomState(0)
    h, w = (int(x) for x in args.image_hw.split(","))
    image = rng.randint(0, 255, (h, w, 3), np.uint8)
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]

    report = {
        "backend": "gpu" if device.type == "cuda" else device.type,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "image_hw": [h, w],
        "iters": args.iters,
        "quantize": args.quantize,
        "note": "per-request wall clock of the port's TopDownPredictor: host crop "
                "geometry + device crop, forward and decode + fetch of the result; "
                "float32 weights, or int8 with --quantize int8",
        "models": {},
    }
    for name in args.models.split(","):
        name = name.strip()
        report["models"][name] = bench_model(
            name, batch_sizes, args.iters, image, rng,
            quantize=args.quantize, device=device)
        print(name, json.dumps(report["models"][name]), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
