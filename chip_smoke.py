#!/usr/bin/env python3
"""Drive the PyTorch port's top-down HRNet-W32 serving path once on one CUDA GPU.

Usage (from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and exits nonzero, printing
no result, when there is no CUDA device or when any phase fails:

1. the GPU's name and power limit (nvidia-smi);
2. build every kernel of the path from csrc/ (nvcc, sm_90a);
3. each kernel against its plain PyTorch version on the GPU, bitwise, on
   random heatmaps at the path's shapes and on planted cases; both timed;
4. the slice: HRNet-W32 + hrnet_head at full width (random weights from a
   numpy seed) behind ``TopDownPredictor`` with hrnet_w32_tpu.yaml's
   settings, answering requests of 1, 5 and 40 boxes; the kernels' launch
   counts show that the path went through them;
5. the 5-box request on the GPU, in the full float32 the predictor serves
   in, against the same port on the CPU.

The line before the last is the GPU's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch import nn

from mindpose_tpu_torch.data.transform import box_to_center_scale
from mindpose_tpu_torch.engine import TopDownPredictor
from mindpose_tpu_torch.models import create_network
from mindpose_tpu_torch.ops.cuda.build import load_library
from mindpose_tpu_torch.ops.cuda.decode import argmax_shift_decode, argmax_shift_decode_plain

# configs/hrnet/hrnet_w32_tpu.yaml, the keys the serving path reads
# (tests/test_torch_host_copies.py holds this literal equal to the yaml)
HRNET_W32 = {
    "num_joints": 17,
    "backbone_name": "hrnet_w32",
    "backbone_setting": {},
    "head_name": "hrnet_head",
    "head_setting": {},
    "decoder_name": "topdown_heatmap",
    "decoder_setting": {"shift_coordinate": False},
    "dataset_setting": {
        "image_size": [192, 256],
        "heatmap_size": [48, 64],
        "pixel_std": 200.0,
        "scale_padding": 1.25,
        "det_bbox_thr": 0.0,
        "flip_pairs": [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14], [15, 16]],
        "upper_body_ids": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
    },
    "normalize_mean": [0.485, 0.456, 0.406],
    "normalize_std": [0.229, 0.224, 0.225],
}
BATCH_SIZE = 32
SEED = 0
# GPU float32 (TF32 off) against CPU float32: the sums of ~100 conv layers run
# in other orders, so heatmaps agree to a tolerance relative to their largest
# value, not bitwise (float32 against float64 on the CPU differs by ~1e-6 of it
# for a 2-block-per-branch HRNet-W32)
HEATMAP_RTOL = 2e-5
REPEATS = 20  # timed runs of each request


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, queued: bool, iters: int = 100, repeats: int = 7) -> float:
    """Median over ``repeats`` of the time per call of ``iters`` calls (CUDA events).

    ``queued``: the calls wait behind a ~50 ms busy-wait on the GPU, so the
    host has queued them all before the first runs, and the events time the
    device alone. Otherwise the calls run back to back as a caller issues
    them, and the time includes the host's cost of issuing each call.
    """
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def decode_cases(rng: np.random.RandomState):
    """(name, NCHW heatmap) pairs: the path's shapes, then planted cases."""
    yield "random 32x17x64x48", rng.randn(32, 17, 64, 48)
    yield "random 128x17x64x48", rng.randn(128, 17, 64, 48)
    yield "exact ties", rng.randint(0, 3, (32, 17, 64, 48))
    const = np.ones((4, 17, 64, 48)) * np.arange(17)[None, :, None, None]
    const[0, 0] = -np.inf
    yield "constant rows", const
    border = rng.uniform(0.0, 0.5, (2, 17, 64, 48))
    spots = [(0, 0), (0, 47), (63, 0), (63, 47), (0, 20), (63, 7), (30, 0), (12, 47),
             (1, 1), (62, 46), (1, 46), (62, 1), (0, 1), (1, 0), (63, 46), (62, 47), (32, 24)]
    for k, (y, x) in enumerate(spots):
        border[:, k, y, x] = 1.0
    yield "maxima on every border", border
    nan = rng.randn(2, 17, 64, 48)
    nan[0, 0, 5, 7] = nan[0, 0, 9, 1] = nan[1, 3, 0, 0] = nan[1, 4] = np.nan
    # NaN maxima whose right or lower tap is NaN too, and an interior maximum
    # with -inf on every side: with shift the coordinate comes out NaN
    nan[0, 5, 10, 10] = nan[0, 5, 10, 11] = np.nan
    nan[0, 6, 20, 20] = nan[0, 6, 21, 20] = np.nan
    nan[1, 7] = -np.inf
    nan[1, 7, 30, 30] = 1.0
    yield "rows holding NaN, NaN and -inf taps", nan
    for shape in [(2, 3, 1, 1), (2, 3, 1, 5), (2, 3, 5, 1), (3, 2, 2, 2), (1, 17, 3, 3)]:
        yield f"tiny {shape}", rng.randn(*shape)


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """NaN where the other is NaN, and every other value equal bit for bit."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        a.nan_to_num().view(torch.int32), b.nan_to_num().view(torch.int32))


def check_decode(device: torch.device) -> dict:
    """Phase 3: the decode kernel equals its plain version bitwise; both timed."""
    rng = np.random.RandomState(SEED)
    max_err = 0.0
    for name, hm in decode_cases(rng):
        x = torch.from_numpy(np.ascontiguousarray(hm, np.float32)).to(device)
        for shift in (False, True):
            kc, km = argmax_shift_decode(x, shift)
            pc, pm = argmax_shift_decode_plain(x, shift)
            torch.cuda.synchronize()
            equal = bitwise_equal(kc, pc) and bitwise_equal(km, pm)
            for k, p in ((kc, pc), (km, pm)):
                finite = k.isfinite() & p.isfinite()
                max_err = max(max_err, float(torch.where(finite, k - p, 0.0).abs().max()))
            print(f"decode {name} shift={shift}: bitwise equal {equal}")
            if not equal:
                raise AssertionError(f"decode kernel differs from the plain version on {name}")
    times = {}
    for n in (32, 128):
        x = torch.from_numpy(rng.randn(n, 17, 64, 48).astype(np.float32)).to(device)
        for shift in (False, True):
            for queued in (True, False):
                kernel = time_ms(lambda: argmax_shift_decode(x, shift), queued)
                plain = time_ms(lambda: argmax_shift_decode_plain(x, shift), queued)
                times[(n, shift, queued)] = (kernel, plain)
                what = "device time" if queued else "per call, back to back"
                print(f"decode [{n},17,64,48] shift={shift} {what}: "
                      f"kernel {kernel:.5f} ms, plain {plain:.5f} ms")
    shift = HRNET_W32["decoder_setting"]["shift_coordinate"]
    kernel_ms, plain_ms = times[(BATCH_SIZE, shift, True)]
    return {"max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}


def random_weights_(net: nn.Module, device: torch.device) -> None:
    """Weights from a numpy seed; BN statistics from one batch of random crops.

    Convs (the head's too) are He-normal, so heatmaps come out O(1) with
    distinct peaks instead of the near-zero maps of the head's own init. A
    random net in eval mode with unit running statistics would grow its
    activations block by block, so the running statistics are set to the
    batch statistics of one train-mode pass (momentum 1).
    """
    rng = np.random.RandomState(SEED)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 4:
                w = rng.standard_normal(p.shape) * np.sqrt(2.0 / p[0].numel())
            elif name.endswith("weight"):
                w = rng.uniform(0.5, 1.5, p.shape)
            else:
                w = 0.1 * rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(w.astype(np.float32)))
        net.to(device)
        bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
        for m in bns:
            m.momentum = 1.0
        net.train()
        net(torch.from_numpy(rng.standard_normal((8, 3, 256, 192)).astype(np.float32)).to(device))
        for m in bns:
            m.momentum = 0.1
    net.eval()


def make_requests(rng: np.random.RandomState):
    """A synthetic 480x640 RGB image and requests of 1, 5 and 40 xywh boxes inside it."""
    image = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)

    def boxes(m):
        wh = rng.uniform([40, 80], [300, 400], (m, 2))
        xy = rng.uniform(0, 1, (m, 2)) * ([640, 480] - wh)
        return np.concatenate([xy, wh], axis=1).astype(np.float32)

    return image, [boxes(1), boxes(5), boxes(40)]


def check_preds(preds: np.ndarray, boxes: np.ndarray) -> None:
    """[M, 17, 3], finite, and each keypoint inside its box's padded crop window."""
    m = len(boxes)
    if preds.shape != (m, 17, 3):
        raise AssertionError(f"preds shape {preds.shape}, want {(m, 17, 3)}")
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite keypoints")
    ds = HRNET_W32["dataset_setting"]
    cs = [box_to_center_scale(b, ds["image_size"], ds["pixel_std"], ds["scale_padding"])
          for b in boxes]
    centers = np.stack([c for c, _ in cs])
    half = np.stack([s for _, s in cs]) * ds["pixel_std"] / 2
    lo, hi = centers - half, centers + half
    xy = preds[..., :2]
    if not ((xy >= lo[:, None]).all() and (xy <= hi[:, None]).all()):
        raise AssertionError("keypoints outside their crop windows")


def serve(predictor: TopDownPredictor, image, requests) -> dict:
    """Phase 4: answer the requests; count the kernel's launches on that run."""
    predictor(image, requests[0])  # warm-up: cuDNN and the kernel's first launch
    torch.cuda.synchronize()
    argmax_shift_decode.launches = 0
    latencies = []
    for boxes in requests:
        start = time.perf_counter()
        preds = predictor(image, boxes)
        latencies.append((time.perf_counter() - start) * 1e3)
        check_preds(preds, boxes)
    launches = argmax_shift_decode.launches
    chunks = sum(-(-len(b) // BATCH_SIZE) for b in requests)
    for boxes, ms in zip(requests, latencies):
        print(f"request {len(boxes)} boxes: {ms:.3f} ms (first call after warm-up)")
    print(f"decode kernel launches on the main path: {launches} (chunks: {chunks})")
    if launches != chunks:
        raise AssertionError(f"decode kernel launched {launches} times for {chunks} chunks")
    for boxes in requests:
        runs = []
        for _ in range(REPEATS):
            start = time.perf_counter()
            predictor(image, boxes)
            runs.append((time.perf_counter() - start) * 1e3)
        print(f"request {len(boxes)} boxes over {REPEATS} runs: median "
              f"{statistics.median(runs):.3f} ms, min {min(runs):.3f}, max {max(runs):.3f}; "
              f"{len(boxes) * REPEATS / (sum(runs) / 1e3):.1f} crops/s")
    return {"launches": launches}


def compare_with_cpu(net: nn.Module, predictor: TopDownPredictor, image, boxes) -> None:
    """Phase 5: the same request through the port on the GPU and on the CPU.

    The heatmaps are compared at the precision the predictor serves in: its
    calls have left TF32 off.
    """
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    print(f"card-vs-CPU: after serving, cudnn.allow_tf32, cuda.matmul.allow_tf32 = {tf32}")
    if any(tf32):
        raise AssertionError("the predictor did not serve in full float32")
    cpu_net = copy.deepcopy(net).cpu()
    cpu_predictor = TopDownPredictor(
        cpu_net, HRNET_W32["dataset_setting"], HRNET_W32["decoder_setting"],
        HRNET_W32["normalize_mean"], HRNET_W32["normalize_std"], batch_size=BATCH_SIZE,
        device=torch.device("cpu"))
    with torch.inference_mode():
        x_gpu, _, _ = predictor.preprocess(image, boxes)
        x_cpu, _, _ = cpu_predictor.preprocess(image, boxes)
        crop_err = float((x_gpu.cpu() - x_cpu).abs().max())
        heat_gpu = net(x_gpu).cpu()
        heat_cpu = cpu_net(x_cpu)
    heat_err = float((heat_gpu - heat_cpu).abs().max())
    tol = HEATMAP_RTOL * float(heat_cpu.abs().max())
    print(f"card-vs-CPU crops: max |diff| {crop_err:.3e}; heatmaps: max |diff| {heat_err:.3e}, "
          f"tolerance {tol:.3e} ({HEATMAP_RTOL} x max |heatmap|)")
    if heat_err > tol:
        raise AssertionError("GPU and CPU heatmaps disagree beyond the tolerance")

    preds_gpu = predictor(image, boxes)
    preds_cpu = cpu_predictor(image, boxes)
    top2 = torch.topk(heat_cpu.flatten(2), 2, dim=2).values
    # a peak that leads by more than both maps' error can not change place
    qualified = ((top2[..., 0] - top2[..., 1]) > 2 * tol).numpy()
    same = (preds_gpu[..., :2] == preds_cpu[..., :2]).all(-1)
    print(f"card-vs-CPU keypoints: {int(qualified.sum())} of {qualified.size} joints have a "
          f"top-2 gap > {2 * tol:.3e}; {int(same[qualified].sum())} of them agree exactly")
    if not same[qualified].all():
        raise AssertionError("keypoints differ where the heatmap peak is clear")
    score_err = float(np.abs(preds_gpu[..., 2] - preds_cpu[..., 2]).max())
    if score_err > tol:
        raise AssertionError(f"scores differ by {score_err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    built = load_library("decode")
    print(f"built {built.path.name} in {built.build_seconds:.2f} s")
    print(built.log.strip())

    decode = check_decode(device)

    net = create_network(HRNET_W32["backbone_name"], HRNET_W32["head_name"],
                         num_joints=HRNET_W32["num_joints"],
                         backbone_args=HRNET_W32["backbone_setting"],
                         head_args=HRNET_W32["head_setting"])
    random_weights_(net, device)
    predictor = TopDownPredictor(
        net, HRNET_W32["dataset_setting"], HRNET_W32["decoder_setting"],
        HRNET_W32["normalize_mean"], HRNET_W32["normalize_std"], batch_size=BATCH_SIZE,
        decoder_name=HRNET_W32["decoder_name"], device=device)
    # PyTorch's default, set here so that the run shows the predictor turns it off
    torch.backends.cudnn.allow_tf32 = True
    image, requests = make_requests(np.random.RandomState(SEED))
    served = serve(predictor, image, requests)

    compare_with_cpu(net, predictor, image, requests[1])

    kernels = [{
        "name": "argmax_shift_decode",
        "route": "cuda",
        "source": "mindpose_tpu_torch/csrc/decode.cu",
        "replaces": "mindpose_tpu/ops/pallas/decode.py:27",
        "launches": served["launches"],
        "max_abs_err": decode["max_abs_err"],
        "ms": decode["ms"],
        "plain_ms": decode["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
