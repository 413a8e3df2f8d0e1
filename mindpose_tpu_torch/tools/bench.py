"""Benchmark: HRNet-W32 256x192 training throughput and decode latency on the GPU.

Counterpart of the JAX package's ``bench.py``. Extras: a sustained
end-to-end number (the real loader into the train step, the encode-mode
device pipeline; ``tools/bench_e2e.py``) and the bottom-up family's train
step (HigherHRNet-W32 at 512x512).

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

``vs_baseline`` is 1.0: the only published throughput the repo holds is a
TPU figure, which is no target for this card. Each loop is timed by the
host's clock (``time.perf_counter``) around the loop, with one
``torch.cuda.synchronize`` at its end, the best of 3 repeats: end-to-end
numbers that include the host's issue of each call; each part's seconds go
to standard error. Under ``torchrun`` each
rank trains ``batch_per_chip`` records through DDP (the step of the train
entry) and ``n_devices`` is the world size; rank 0 prints.

    python3 -m mindpose_tpu_torch.tools.bench [--device cpu]
    torchrun --nproc_per_node=N -m mindpose_tpu_torch.tools.bench
"""
import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models import create_decoder, create_loss, create_network, create_network_with_loss
from ..ops.cuda.decode import argmax_shift_decode
from ..optim import create_optimizer
from ..parallel import build_train_step, init_distributed, is_main_process
from . import bench_e2e
from .timing import device_parser, resolve_device, sync

__all__ = ["METRIC", "UNIT", "AMP_LEVEL", "bench_train_step", "bench_decode",
           "bench_e2e_encode", "bench_bottomup_step", "main"]

METRIC = "hrnet_w32_256x192_train_throughput"
UNIT = "images/sec/chip"
AMP_LEVEL = "O2"  # bf16 autocast: the JAX benchmark's bf16 net

# A hung run (a wedged card, a collective that never completes) would leave
# no output at all; the watchdog prints the error line and exits instead.
_WATCHDOG_S = float(os.environ.get("BENCH_WATCHDOG_S", 2400))


def _error_line(error: str) -> str:
    return json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
                       "extra": {"error": error}})


def _arm_watchdog() -> threading.Timer:
    def fire():
        print(_error_line(f"watchdog: no result after {_WATCHDOG_S:.0f}s"), flush=True)
        os._exit(2)

    t = threading.Timer(_WATCHDOG_S, fire)
    t.daemon = True
    t.start()
    return t



def _world() -> tuple:
    """(rank, world size): the process group's, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    """This rank's rows of a global batch: the JAX benchmark's ``shard_batch``."""
    per = a.shape[0] // world
    return a[rank * per:(rank + 1) * per]


def _nchw(a: np.ndarray, device: torch.device, order=(0, 3, 1, 2)) -> torch.Tensor:
    return torch.from_numpy(a).permute(*order).contiguous().to(device)


def _time_steps(step, arrays, warmup: int, iters: int, device: torch.device) -> float:
    """The best of 3 loops of ``iters`` steps after ``warmup`` steps, in seconds."""
    for _ in range(warmup):
        step(*arrays)
    sync(device)
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*arrays)
        sync(device)
        dts.append(time.perf_counter() - t0)
    return min(dts)


def bench_train_step(batch_per_chip: int = 128, iters: int = 20,
                     device: Optional[torch.device] = None) -> dict:
    """The flagship recipe's step (HRNet-W32 + ``hrnet_head``, ``joint_mse``
    with target weights, adamw at 1e-3 with weight decay 0.05, O2) on the
    JAX benchmark's draws: the global batch from ``RandomState(0)``, this
    rank's rows of it."""
    device = resolve_device(device)
    rank, n_dev = _world()
    batch = batch_per_chip * n_dev

    torch.manual_seed(0)
    with torch.device(device):  # initialised where it trains
        net = create_network("hrnet_w32", "hrnet_head").to(device)
    loss = create_loss("joint_mse", use_target_weight=True)
    nwl = create_network_with_loss(net, loss, has_extra_inputs=True)
    optimizer = create_optimizer(net, "adamw", learning_rate=1e-3, weight_decay=0.05)
    step_fn = build_train_step(nwl, optimizer, amp_level=AMP_LEVEL)

    rng = np.random.RandomState(0)
    x = rng.rand(batch, 256, 192, 3).astype(np.float32)
    y = rng.rand(batch, 64, 48, 17).astype(np.float32)
    w = np.ones((batch, 17), np.float32)
    arrays = [_nchw(_shard(x, rank, n_dev), device), _nchw(_shard(y, rank, n_dev), device),
              torch.from_numpy(_shard(w, rank, n_dev)).to(device)]

    dt = _time_steps(step_fn, arrays, 3, iters, device)
    images_per_sec = batch * iters / dt
    return {
        "train_images_per_sec": images_per_sec,
        "train_images_per_sec_per_chip": images_per_sec / n_dev,
        "step_time_ms": dt / iters * 1000,
        "batch_per_chip": batch_per_chip,
        "n_devices": n_dev,
    }


def bench_decode(batch: int = 128, iters: int = 50,
                 device: Optional[torch.device] = None) -> dict:
    """The ``topdown_heatmap`` decoder with the quarter-pixel shift on
    [batch, 17, 64, 48] heatmaps: on the card one launch of the decode kernel
    per call (``decode_kernel_launches`` counts them in this function).
    ``decode_p50_ms``: the median of single calls, each synchronized;
    ``decode_amortized_ms``: 100 calls back to back, one synchronize, per
    call; the median of 5 such loops (``decode_amortized_spread_ms``)."""
    device = resolve_device(device)
    launches = argmax_shift_decode.launches
    decoder = create_decoder("topdown_heatmap", shift_coordinate=True)
    rng = np.random.RandomState(0)
    hm = _nchw(rng.rand(batch, 64, 48, 17).astype(np.float32), device)
    center = torch.full((batch, 2), 100.0, device=device)
    scale = torch.ones(batch, 2, device=device)
    score = torch.ones(batch, device=device)
    args = (hm, center, scale, score)

    decoder(*args)
    sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        decoder(*args)
        sync(device)
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times) * 1000)
    amorts = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(100):
            decoder(*args)
        sync(device)
        amorts.append((time.perf_counter() - t0) / 100 * 1000)
    return {
        "decode_p50_ms": p50,
        "decode_amortized_ms": float(np.median(amorts)),
        "decode_amortized_spread_ms": [round(a, 3) for a in amorts],
        "decode_batch": batch,
        "decode_kernel_launches": argmax_shift_decode.launches - launches,
    }


def bench_e2e_encode(num_images: int = 96, epochs: int = 4,
                     device: Optional[torch.device] = None) -> dict:
    """Sustained loader->step throughput, encode-mode device pipeline."""
    with tempfile.TemporaryDirectory(prefix="bench_e2e_") as root:
        img_root, ann = bench_e2e.make_synth_coco(root, num_images)
        r = bench_e2e.measure_e2e("encode", img_root, ann, batch_size=128, epochs=epochs,
                                  num_workers=4, decode_cache_mb=2048, device=device)
    out = {"e2e_images_per_sec": r["e2e_images_per_sec"],
           "e2e_mode": "encode",
           "e2e_records_per_epoch": r["records_per_epoch"],
           "e2e_epoch_rates": r["epoch_rates"]}
    for k in ("e2e_mb_per_batch", "e2e_wire_mb_per_s", "link_mb_per_s",
              "link_mb_per_s_pre_post", "e2e_link_utilization"):
        if k in r:
            out[k] = r[k]
    return out


def bench_bottomup_step(batch_per_chip: int = 24, iters: int = 10,
                        backbone_args: Optional[dict] = None,
                        head_args: Optional[dict] = None,
                        device: Optional[torch.device] = None) -> dict:
    """HigherHRNet-W32 512x512 train-step throughput (the bottom-up family).

    The recipe's step (configs/higher_hrnet/higher_hrnet_w32_tpu.yaml: heatmaps
    of 128 and 256, ``ae_multi_loss`` with masks and tag indices, adam at
    1e-3, O2) on the JAX benchmark's draws. ``backbone_args`` and
    ``head_args`` let ``bench_bu_variant.py`` time variants of the same
    step; the JAX default's TPU rewrites (``branch0_s2d``, fused BatchNorm,
    the head's ``s2d_refine``) build the plain layers here.
    """
    device = resolve_device(device)
    rank, n_dev = _world()
    batch = batch_per_chip * n_dev
    K, M = 17, 30

    if backbone_args is None:
        backbone_args = {"branch0_s2d": True, "bn_grad_stats": "fused"}
    torch.manual_seed(0)
    with torch.device(device):
        net = create_network(
            "hrnet_w32", "higher_hrnet_head", backbone_args=backbone_args,
            head_args={"with_ae_loss": (True, False), **(head_args or {})}).to(device)
    loss = create_loss(
        "ae_multi_loss", num_joints=K, num_stages=2,
        stage_sizes=[[128, 128], [256, 256]],
        mse_loss_factor=[1.0, 1.0], ae_loss_factor=[0.001, 0.001],
        with_mse_loss=[True, True], with_ae_loss=[True, False],
    )
    nwl = create_network_with_loss(net, loss, has_extra_inputs=True)
    optimizer = create_optimizer(net, "adam", learning_rate=1e-3)
    step_fn = build_train_step(nwl, optimizer, amp_level=AMP_LEVEL)

    rng = np.random.RandomState(0)
    tag_ind = np.zeros((batch, 2, M, K, 2), np.int32)
    tag_ind[..., 0] = rng.randint(0, 128 * 128, (batch, 2, M, K))
    tag_ind[..., 1] = rng.randint(0, 2, (batch, 2, M, K))  # valid flag
    image = rng.rand(batch, 512, 512, 3).astype(np.float32)
    target = rng.rand(batch, 2, 256, 256, K).astype(np.float32)
    mask = np.ones((batch, 2, 256, 256), np.float32)
    arrays = [_nchw(_shard(image, rank, n_dev), device),
              _nchw(_shard(target, rank, n_dev), device, (0, 1, 4, 2, 3)),
              torch.from_numpy(_shard(mask, rank, n_dev)).to(device),
              torch.from_numpy(_shard(tag_ind, rank, n_dev)).to(device)]

    dt = _time_steps(step_fn, arrays, 2, iters, device)
    ips = batch * iters / dt
    return {
        "higher_hrnet_train_images_per_sec_per_chip": ips / n_dev,
        "higher_hrnet_step_time_ms": dt / iters * 1000,
        "higher_hrnet_batch_per_chip": batch_per_chip,
    }


def _timed(fn, **kwargs) -> dict:
    """``fn(**kwargs)``, its seconds logged (standard error)."""
    start = time.perf_counter()
    out = fn(**kwargs)
    logging.info("bench: %s took %.1f s", fn.__name__, time.perf_counter() - start)
    return out


def _run(device_arg: Optional[str]) -> Dict:
    try:
        init_distributed(device=device_arg or "cuda")  # a group only under a launcher
        device = resolve_device(device_arg)
        # decode first: the train step leaves large buffers and queued work
        # behind it that would inflate the small decode's latency
        decode_stats = _timed(bench_decode, device=device)
        train_stats = _timed(bench_train_step, device=device)
    except Exception as e:
        print(_error_line(repr(e)[:300]), flush=True)
        raise
    try:
        e2e_stats = _timed(bench_e2e_encode, device=device)
    except Exception as e:  # e2e is an extra, never fail the headline bench
        e2e_stats = {"e2e_error": repr(e)[:200]}
    try:
        bu_stats = _timed(bench_bottomup_step, device=device)
    except Exception as e:  # extras never fail the headline bench
        bu_stats = {"higher_hrnet_error": repr(e)[:200]}

    value = train_stats["train_images_per_sec_per_chip"]
    report = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": UNIT,
        "vs_baseline": 1.0,
        "extra": {**train_stats, **decode_stats, **bu_stats, **e2e_stats},
    }
    if is_main_process():
        print(json.dumps(report), flush=True)
    return report


def main(argv: Optional[List[str]] = None) -> Dict:
    p = device_parser(__doc__.split("\n", 1)[0])
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    watchdog = _arm_watchdog()
    started_group = not dist.is_initialized()
    try:
        return _run(args.device)
    finally:
        watchdog.cancel()
        if started_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
