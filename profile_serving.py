#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one CUDA GPU.

Usage (from the root of a checkout, on the machine chip_smoke.py runs on):

    python3 profile_serving.py [--config configs/udp/resnet50_udp_tpu.yaml] [--trace-dir DIR]

It builds the same full-width HRNet-W32 predictor, weights and requests (1, 5
and 40 boxes) as chip_smoke.py, or with ``--config`` the predictor of a
top-down recipe (``TopDownPredictor.from_config``, random weights from the
same numpy seed), and prints, for each request:
- the request latency over 20 runs (median, min, max), host clock, and its
  median when each call runs on a new thread (as a ThreadingHTTPServer
  handler calls it: PyTorch keeps cuDNN's convolution plans per thread);
- the median split of a request into preprocess / forward / decode / copy to
  host, with a device synchronisation between the phases;
- under torch.profiler, over 5 requests: the device's busy share of the wall
  time, the device operations per request, and the kernels that take most
  device time (one Chrome trace per request size in DIR, if given);
and, for one 32-crop chunk, the forward's device time with cuDNN's TF32 on and
off (CUDA events). The predictor itself serves with TF32 off.
"""
import argparse
import os
import statistics
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

REPEATS = 20


def split_ms(predictor, image, boxes):
    """(preprocess, forward, decode, to host) of one request, ms, synchronised between."""
    net, decoder, n = predictor.net, predictor._eval_net.decoder, cs.BATCH_SIZE
    t0 = time.perf_counter()
    with torch.inference_mode():
        x, centers, scales = predictor.preprocess(image, boxes)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        heats = [net(x[i:i + n]) for i in range(0, len(boxes), n)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores = torch.ones(len(boxes), device=x.device)
        preds = [decoder(h, centers[i * n:(i + 1) * n], scales[i * n:(i + 1) * n],
                         scores[i * n:(i + 1) * n])[0] for i, h in enumerate(heats)]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        torch.cat(preds).cpu()
        t4 = time.perf_counter()
    return [(b - a) * 1e3 for a, b in ((t0, t1), (t1, t2), (t2, t3), (t3, t4))]


def device_share(predictor, image, boxes, trace_dir):
    """Busy share and the top kernels of 5 requests under torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(5):
            predictor(image, boxes)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"{len(boxes)} boxes x5 under the profiler: wall {wall_us:.0f} us, device busy "
          f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
          f"{len(kernels) / 5:.0f} device operations per request")
    by_name = {}
    for e in kernels:
        us_n = by_name.setdefault(e.name, [0.0, 0])
        us_n[0] += e.time_range.elapsed_us()
        us_n[1] += 1
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"   {us / 5:10.1f} us/request  x{n / 5:.0f}  {name[:110]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"serve_{len(boxes)}boxes.json"))


def fresh_thread_ms(predictor, image, boxes) -> float:
    """Median request latency when each call runs on a new thread, as a
    ThreadingHTTPServer handler would call it."""
    runs = []
    for _ in range(REPEATS):
        out = []
        t = threading.Thread(target=lambda: out.append(timed_ms(predictor, image, boxes)))
        t.start()
        t.join()
        runs.append(out[0])
    return statistics.median(runs)


def timed_ms(predictor, image, boxes) -> float:
    start = time.perf_counter()
    predictor(image, boxes)
    return (time.perf_counter() - start) * 1e3


def forward_ms(net, x, tf32: bool) -> float:
    torch.backends.cudnn.allow_tf32 = tf32
    with torch.inference_mode():
        return cs.time_ms(lambda: net(x), queued=False, iters=10, repeats=5)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="",
                        help="a top-down recipe to serve (default: HRNet-W32 as chip_smoke.py)")
    parser.add_argument("--trace-dir", default="", help="write Chrome traces here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    device = torch.device("cuda", 0)
    print(f"gpu: {cs.gpu_name_and_power()}; torch {torch.__version__}")
    if args.config:
        recipe = cs.serve_entry.parse_serve_args(["--config", args.config])
        net = cs.create_network_from_config(recipe)
        cs.random_weights_(net, device)
        predictor = cs.TopDownPredictor.from_config(recipe, net.state_dict(),
                                                    batch_size=cs.BATCH_SIZE, device=device)
        net = predictor.net
        print(f"serving {args.config}: {recipe.backbone_name} + {recipe.head_name}, decoder "
              f"{recipe.decoder_setting}")
    else:
        h = cs.HRNET_W32
        net = cs.create_network(h["backbone_name"], h["head_name"], num_joints=h["num_joints"])
        cs.random_weights_(net, device)
        predictor = cs.TopDownPredictor(
            net, h["dataset_setting"], h["decoder_setting"], h["normalize_mean"],
            h["normalize_std"], batch_size=cs.BATCH_SIZE, device=device)
    image, requests = cs.make_requests(np.random.RandomState(cs.SEED))

    for boxes in requests:
        for _ in range(3):
            predictor(image, boxes)  # warm-up; also turns TF32 off
        runs = []
        for _ in range(REPEATS):
            start = time.perf_counter()
            predictor(image, boxes)
            runs.append((time.perf_counter() - start) * 1e3)
        parts = [split_ms(predictor, image, boxes) for _ in range(REPEATS)]
        med = [statistics.median(p[i] for p in parts) for i in range(4)]
        print(f"{len(boxes)} boxes: request median {statistics.median(runs):.3f} ms "
              f"(min {min(runs):.3f}, max {max(runs):.3f}, {REPEATS} runs); split medians: "
              f"preprocess {med[0]:.3f}, forward {med[1]:.3f}, decode {med[2]:.3f}, "
              f"to host {med[3]:.3f} ms; each call on a new thread: median "
              f"{fresh_thread_ms(predictor, image, boxes):.3f} ms")

    for boxes in (requests[0], requests[2]):
        device_share(predictor, image, boxes, args.trace_dir)

    x, _, _ = predictor.preprocess(image, requests[2][:cs.BATCH_SIZE])
    on, off = forward_ms(net, x, True), forward_ms(net, x, False)
    print(f"forward of one 32-crop chunk, back to back: TF32 {on:.3f} ms, float32 {off:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
