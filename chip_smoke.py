#!/usr/bin/env python3
"""Drive the PyTorch port's top-down paths (HRNet-W32, SimpleBaseline) once on one CUDA GPU.

Usage (from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and exits nonzero, printing
no result, when there is no CUDA device or when any phase fails:

1. the GPU's name and power limit (nvidia-smi);
2. build every kernel of the path from csrc/ (nvcc, sm_90a);
3. the decode kernel, through both its wrappers, against their plain
   PyTorch versions on the GPU, bitwise, on random heatmaps at the path's
   shapes (also from an unaligned base) and on planted cases, shift off and
   on, the whole decoder with its back-projection off, on and on with UDP;
   then timed: the kernel warm and cold in L2, its launch floor,
   ``torch.max(dim=1)`` as the library call, the decoder per chunk through
   the kernel against the plain composition, and the device operations of
   one decoder call under torch.profiler (must be 1);
4. the slice: HRNet-W32 + hrnet_head at full width (random weights from a
   numpy seed) behind ``TopDownPredictor`` with hrnet_w32_tpu.yaml's
   settings, answering requests of 1, 5 and 40 boxes; the kernels' launch
   counts show that the path went through them;
5. the 5-box request on the GPU, in the full float32 the predictor serves
   in, against the same port on the CPU;
6. the conv chain's two kernels against their plain version (cuDNN) on the
   GPU, within stated bounds: float32 (CUDA cores) at depths 1-8; bf16
   (tensor cores) at depths 1-8 and C 4-64, each chain also bit for bit
   equal whatever number of layers a launch fuses; bf16 at depth 1 within
   one ulp;
7. the conv chain's own entry point, the go/no-go probe
   (``tools/ablate_conv_chain.py``), at its three bf16 geometries: both
   device times, and the launch counts on that run, all on the tensor cores;
8. evaluation through the eval entry (``tools/eval.evaluate``): the
   serving net's weights saved as a port checkpoint and loaded back bit for
   bit, then evaluated with the recipe's settings (O2, batch 128, GT boxes,
   OKS-NMS) on synthetic COCO from ``tools/make_synthetic_coco.py`` (648
   frames, 2,592 crops), TTA off (a first pass and 3 warm ones, with the
   warm rates' spread) and on: records, batches, inferencer and evaluator
   times, crops/s, one decode launch per batch, the 10 COCO stats; the
   JAX-trained fixture checkpoint (tests/fixtures/) read by the port's
   msgpack reader, whose AP on the GPU is above 0 and within 0.005 of the
   CPU's at O0 and within 0.02 at O2, and its crops at O2 on the GPU against
   the CPU; the host loader alone and the forward and decode of one batch;
   and the first 32 crops on the GPU against the CPU at O0, TTA off and on;
9. the train step of hrnet_w32_tpu.yaml (adamw, warmup multi-step schedule,
   O2) on HRNet-W32 at full width, batch 128 of synthetic crops: 3 warm-up
   and 20 timed steps, img/s, step times, peak memory, finite losses;
10. the net learning one fixed batch with its joints painted in, over 30
    steps at constant lr: the loss falls below a fraction of its first value
    and of an all-zero prediction's, and the backbone moves;
11. one full-width train step at batch 2 on the GPU against the port on the
    CPU, in float64 (loss, gradients, BatchNorm running statistics to 1e-8)
    and in float32 (gradients against the CPU's float64);
12. training through the train entry (``tools/train.train``) on
    hrnet_w32_tpu.yaml as parsed from the file (full-width HRNet-W32, O2,
    batch 128, adamw, host targets, evaluating every ``val_interval`` epochs) on
    synthetic COCO from ``tools/make_synthetic_coco.py``; the overrides are
    the data paths, ``num_epochs``, ``warmup``, ``val_interval`` and
    ``ckpt_save_dir``. First the train loader alone with 8 threads and with
    the process pool (crops/s); then per epoch the img/s with the loader
    feeding the step, the step's median and the wait on the loader, beside
    phase 9's img/s. It holds: every loss finite, the last epoch's mean
    loss below the first's, the last evaluation's AP above 0, one decode
    launch per val batch per evaluation, the best and last checkpoints
    written, the last one's 10 COCO stats through the eval entry equal to
    the callback's within 1e-4, and a one-epoch resume from it starting at
    its step count (its batches through ``DevicePrefetcher``);
13. training configs/udp/resnet50_udp_tpu.yaml (ResNet-50 +
    simple_baseline_head at full width, O2, batch 128, adamw, host UDP
    targets), then configs/simple_baseline/resnet50_tpu.yaml, through the
    train entry on phase 12's data for 6 epochs of 10 steps each,
    evaluating once after the last, overridden as phase 12: img/s with the
    loader, the step's median, peak memory; each holds finite losses, the
    last epoch's below the first's, AP above 0 and one decode launch per
    val batch;
14. each run's last checkpoint through the eval entry (the callback's 10
    stats within 1e-4), the UDP one with ``dark_udp_refine`` off and on,
    one decode launch per eval batch in all; on one real eval heatmap the
    DARK decoder's device operations (torch.profiler) and device time per
    32-crop chunk, and the DARK decoder on the card against its CPU run
    (keypoints within 1e-3 px, scores bitwise);
15. the same checkpoint through the serving entry (``tools/serve.py``:
    ``build_service`` behind ``build_http_server`` on 127.0.0.1 at an
    ephemeral port): ``GET /healthz``, ``POST /predict`` with 1, 5 and 40
    boxes over real HTTP, one decode launch per 32-crop chunk, latency over
    20 runs each; the 5-box answer against the same service on the CPU;
    then resnet101_tpu.yaml and resnet152_tpu.yaml with random weights from
    a numpy seed through the same entry, a 40-box request each; every
    server shut down and no thread of the phase left.

Every process the run starts ends before it does: the script adopts each
one whose parent ends first (a child subreaper), stops the process pool's
forkserver and resource tracker after phase 12, and fails if any process it
started is still there after phase 15.

The line before the last is the GPU's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import base64
import copy
import ctypes
import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import cv2
import numpy as np
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile, record_function

from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.data.loader import DataLoader, stop_worker_servers
from mindpose_tpu_torch.data.device_pipeline import (
    build_topdown_preprocess,
    strip_host_target_transform,
)
from mindpose_tpu_torch.data.transform import box_to_center_scale
from mindpose_tpu_torch.engine import TopDownPredictor, build_http_server, create_inferencer
from mindpose_tpu_torch.models import (
    create_decoder,
    create_eval_network,
    create_loss,
    create_network,
    create_network_from_config,
    create_network_with_loss,
)
from mindpose_tpu_torch.ops.cuda.build import load_library
from mindpose_tpu_torch.ops.cuda.conv_chain import (
    _launch as conv_chain_launch,
    conv_chain_plain,
    FUSED_LAYERS,
    fused_conv_chain,
    smem_bytes,
    split_layers,
)
from mindpose_tpu_torch.ops.cuda.decode import (
    argmax_shift_decode,
    argmax_shift_decode_plain,
    decode_heatmap,
    decode_heatmap_plain,
)
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import accum_loss_and_grads, build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import ablate_conv_chain as probe
from mindpose_tpu_torch.tools import serve as serve_entry
from mindpose_tpu_torch.tools import train as train_entry
from mindpose_tpu_torch.tools.eval import evaluate
from mindpose_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_net_state_dict,
    restore_train_state,
    save_checkpoint,
)
from tests.fixtures.eval_checks import CKPT, RECORD, decode_margin, register_port_backbone

# configs/hrnet/hrnet_w32_tpu.yaml, the keys the serving and train paths read
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
    # the evaluation keys (val_root, val_label and ckpt are set by the run)
    "num_parallel_workers": 8,
    "dataset_format": "coco_topdown",
    "val_use_gt_bbox": True,
    "pipeline_method": "topdown",
    "val_transforms": ["topdown_box_to_center_scale", "topdown_affine"],
    "in_channels": 3,
    "neck_name": "",
    "inference_method": "topdown_heatmap",
    "eval_method": "topdown",
    "eval_metric": ["AP"],
    "eval_setting": {
        "has_heatmap_output": True,
        "hflip_tta": False,
        "shift_heatmap": False,
        "vis_thr": 0.2,
        "oks_thr": 0.9,
        "use_nms": True,
        "soft_nms": False,
        "sigmas": [0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072, 0.062, 0.062,
                   0.107, 0.107, 0.087, 0.087, 0.089, 0.089],
    },
    # the training keys
    "batch_size": 128,
    "train_transforms": [
        "topdown_box_to_center_scale",
        {"topdown_horizontal_random_flip": {"flip_prob": 0.5}},
        {"topdown_halfbody_transform": {"prob_half_body": 0.3, "scale_padding": 1.5}},
        {"topdown_randomscale_rotation": {"rot_factor": 40, "scale_factor": 0.5, "rot_prob": 0.6}},
        "topdown_affine",
        {"topdown_generate_target": {"sigma": 2.0}},
    ],
    "loss": "joint_mse",
    "loss_with_extra_input": True,
    "loss_setting": {"use_target_weight": True},
    "amp_level": "O2",
    "scheduler": "warmup_multi_step_decay",
    "num_epochs": 210,
    "lr": 0.001,
    "warmup": 500,
    "lr_scheduler_setting": {"milestones": [170, 200]},
    "optimizer": "adamw",
    "weight_decay": 0.05,
    "filter_bias_and_bn": True,
    "optimizer_setting": {},
}
# COCO train2017's 149,813 person instances in batches of 128: the schedule's epoch
STEPS_PER_EPOCH = 1170
BATCH_SIZE = 32
SEED = 0
# GPU float32 (TF32 off) against CPU float32: the sums of ~100 conv layers run
# in other orders, so heatmaps agree to a tolerance relative to their largest
# value, not bitwise (float32 against float64 on the CPU differs by ~1e-6 of it
# for a 2-block-per-branch HRNet-W32)
HEATMAP_RTOL = 2e-5
REPEATS = 20  # timed runs of each request
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, 3.35 TB/s (NVIDIA's data sheet)
MAX_SMEM_PER_BLOCK = 232448  # Hopper, 227 KB
KERNEL_SOURCES = ("decode", "conv_chain")
# the decoder's back-projection settings held bitwise to the plain version
DECODE_MODES = (("to_original off", {"to_original": False, "use_udp": False}),
                ("to_original on", {"to_original": True, "use_udp": False}),
                ("to_original on, UDP", {"to_original": True, "use_udp": True}))
COLD_HEATMAPS = 16  # heatmaps the cold-L2 timing rotates over (> 50 MB at 32 crops)
PLAIN_ITERS = 20  # queued calls per timing of a plain composition (tens of kernels each)
PROBE_ITERS = 5  # chains per timing in the probe (each is 1-100 ms)
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 20
LOSS_FALL_STEPS = 30
MARK_SIZE = 11  # pixels a side of a joint's mark in phase 10's crops
# Phase 10's bounds after 30 steps, set from an exploratory run on the H100:
# with the backbone learning the loss read 0.774 of the first step's and
# 0.939 of the all-zero prediction's; with the backbone frozen (the head
# alone learning) 0.856 and 1.038; on unmarked crops 0.999 of the zero
# prediction's. The backbone moved ~0.1 of its norm against 1.5e-3 from
# the decay alone.
LOSS_FALL_RATIO = 0.85
LOSS_ZERO_RATIO = 0.97
BACKBONE_MOVE_FACTOR = 10.0
TRAIN_CPU_BATCH = 2
# GPU float32 (TF32 off) train step against the CPU's, full width, batch 2:
# the same float32 arithmetic summed in other orders. The forward is well
# conditioned (the serving heatmaps agree to ~3e-6 of their largest value):
# the loss to rtol 1e-5, each running statistic to 1e-4 of its tensor's
# largest |entry| (BatchNorm over as few as 96 values per channel in the
# 1/32-scale branch). Gradients: see compare_train_with_cpu.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_STATS_RTOL = 1e-4
TRAIN_GRAD_FACTOR = 2.0
# The same step in float64 on both: float64 rounding (1.1e-16) carried
# through the net's depth forward and back; measured at worst 1.6e-10 of a
# gradient tensor's largest entry. The bound leaves 60x room and lies a
# million times below the float32 gradient's error, so a fault in any one
# tensor of the GPU's backward down to 1e-8 of its scale shows.
TRAIN_F64_RTOL = 1e-8
# Phase 8: synthetic COCO val frames (tools/make_synthetic_coco.py) with 4
# persons each, 2,592 crops: 20 full batches of 128 and a ragged one of 32,
# so that a pass lasts seconds and its rate can be compared across passes
EVAL_IMAGES = 648
EVAL_PEOPLE = 4
EVAL_WARM_REPEATS = 3  # warm passes of the recipe, TTA off: the rate's spread
EVAL_CPU_CROPS = 32  # crops of the first eval batch run on the GPU and on the CPU
# the card's decoder multiplies by the float reciprocal of the heatmap width
# where the CPU divides (csrc/decode.cu), so a clear joint's coordinates in
# the original frame may differ by a few float32 ulps (~3e-5 px at 500 px)
EVAL_XY_ATOL = 1e-3
FIXTURE_AP_ATOL = 0.005  # the fixture's AP at O0 on the GPU against the CPU's
# At O2 the GPU's bf16 autocast and the CPU's round the convolutions and
# BatchNorm apart, as JAX's bf16 and the CPU's autocast do: on the fixture
# those two give APs 0.0078 apart (tests/test_torch_eval.py holds them
# within 0.02; on an H100 the GPU's AP and its host CPU's were equal). So at O2 the fixture's AP on the GPU is held within 0.02 of
# the CPU's, and, as there, the scores of its first batch within 0.02 of
# the largest heatmap value, the joints whose decode is clear of that within
# EVAL_XY_ATOL, and at least 80% of all joints so
FIXTURE_O2_AP_ATOL = 0.02
O2_SCORE_RTOL, O2_AGREE = 0.02, 0.8
# Phase 12: synthetic COCO train frames (2 persons each: 1,280 records, 10
# steps of 128 per epoch) and val frames (128 crops, one eval batch); 12
# epochs of the recipe, warmup cut from 500 steps to 20 (the yaml's would
# leave the rate near 0 for the whole run), evaluation every 4 epochs
ENTRY_TRAIN_IMAGES = 640
ENTRY_VAL_IMAGES = 64
ENTRY_PEOPLE = 2
ENTRY_EPOCHS = 12
ENTRY_WARMUP = 20
ENTRY_VAL_INTERVAL = 4
ENTRY_RESUME_WARMUP = 5  # the one-epoch resume's schedule has 10 steps in all
ENTRY_RESUME_PREFETCH = 2  # batches the resume's DevicePrefetcher keeps in flight
ENTRY_STATS_ATOL = 1e-4  # the last checkpoint through the eval entry against the callback
RECIPE_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "hrnet",
                           "hrnet_w32_tpu.yaml")
# Phases 13-15: the SimpleBaseline recipes. Phase 13 trains the UDP recipe and
# the plain one on phase 12's data for 6 epochs of 10 steps each, evaluating
# once, after the last
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
UDP_YAML = os.path.join(CONFIGS, "udp", "resnet50_udp_tpu.yaml")
SB_YAML = os.path.join(CONFIGS, "simple_baseline", "resnet50_tpu.yaml")
SB_DEEPER = {arch: os.path.join(CONFIGS, "simple_baseline", f"{arch}_tpu.yaml")
             for arch in ("resnet101", "resnet152")}
SB_EPOCHS = 6


PR_SET_CHILD_SUBREAPER = 36  # prctl option, <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the parent of every process it starts, at any depth,
    whose own parent ends first, so that ``check_no_processes_left`` sees it."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER) failed")


def check_no_processes_left() -> None:
    """Reap the adopted processes that have ended; raise if any child is left."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            break
        if pid == 0:
            break
    me = str(os.getpid())
    left = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                name, fields = f.read().rsplit(")", 1)
        except OSError:
            continue
        if fields.split()[1] == me:
            left.append(f"{pid} ({name.split('(', 1)[1]})")
    if left:
        raise AssertionError(f"processes started by this run are still running: {left}")
    print("processes left running: none")


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


def on_device(hm: np.ndarray, device: torch.device, offset: int = 0) -> torch.Tensor:
    """``hm`` as float32 on ``device``; with ``offset``, a contiguous view that
    many floats into a larger buffer, so not 16 B aligned (the scalar loads)."""
    flat = torch.from_numpy(np.ascontiguousarray(hm, np.float32).ravel()).to(device)
    buf = torch.zeros(flat.numel() + offset, device=device)
    buf[offset:] = flat
    return buf[offset:].view(hm.shape)


def crop_inputs(rng: np.random.RandomState, n: int, device: torch.device):
    """Centers (0-2000 px), scales (0.2-3.0) and box scores of ``n`` crops."""
    arrays = (rng.uniform(0, 2000, (n, 2)), rng.uniform(0.2, 3.0, (n, 2)), rng.uniform(0, 1, n))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


def check_decode_bitwise(device: torch.device) -> float:
    """Phase 3: each wrapper of the decode kernel equals its plain version
    bitwise, on every case, shift off and on, and, for the whole decoder,
    with the back-projection off, on, and on with UDP. Returns the largest
    |kernel - plain| over the finite outputs (0 when all are equal)."""
    max_err = 0.0
    rng = np.random.RandomState(SEED)
    crop_rng = np.random.RandomState(SEED + 5)
    pixel_std = HRNET_W32["dataset_setting"]["pixel_std"]
    for name, hm in decode_cases(rng):
        # the path's chunk also from an unaligned base, through the scalar loads
        for offset in ((0, 1) if name == f"random {BATCH_SIZE}x17x64x48" else (0,)):
            x = on_device(hm, device, offset)
            label = name + (" at an unaligned base" if offset else "")
            crops = crop_inputs(crop_rng, x.shape[0], device)
            for shift in (False, True):
                runs = [("argmax_shift_decode", argmax_shift_decode(x, shift),
                         argmax_shift_decode_plain(x, shift))]
                for mode, kw in DECODE_MODES:
                    kw = dict(kw, shift=shift, pixel_std=pixel_std)
                    runs.append((f"decode_heatmap {mode}", decode_heatmap(x, *crops, **kw),
                                 decode_heatmap_plain(x, *crops, **kw)))
                torch.cuda.synchronize()
                for what, got, want in runs:
                    equal = all(bitwise_equal(g, w) for g, w in zip(got, want))
                    for g, w in zip(got, want):
                        finite = g.isfinite() & w.isfinite()
                        max_err = max(max_err, float(torch.where(finite, g - w, 0.0).abs().max()))
                    print(f"decode {label} shift={shift} {what}: bitwise equal {equal}")
                    if not equal:
                        for i, (g, w) in enumerate(zip(got, want)):
                            bad = (g != w) & ~(g.isnan() & w.isnan())
                            print(f"  output {i}: {int(bad.sum())} of {g.numel()} differ, first "
                                  f"at {bad.nonzero()[:3].tolist()}: kernel {g[bad][:3].tolist()}, "
                                  f"plain {w[bad][:3].tolist()}")
                        raise AssertionError(f"decode kernel ({what}) differs from the plain "
                                             f"version on {label}, shift={shift}")
    return max_err


def cycling(fn, inputs):
    """A call of ``fn`` on the next of ``inputs`` in turn."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))


def device_ops(fn) -> list:
    """Names of the device operations (kernels, copies) of one call of ``fn``,
    from torch.profiler: the second of two calls in one trace, 10 ms apart.
    A profiler trace that is not the process's first may miss the device
    operations at its start (on the H100: 53 of the DARK decoder's 78, the decode
    kernel among the missing). The cut lies 5 ms before the host enters the
    second call, so an offset between the host's and the device's
    timelines below that moves no operation across it."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
        with record_function("chip_smoke.measured_call"):  # the mark below
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    mark = "chip_smoke.measured_call"
    cut = next(e.time_range.start for e in events if e.name == mark) - 5000
    # the profiler also lays the marker's range on the device's timeline
    return [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.start >= cut and e.name != mark]


def decode_bound_ms(n: int) -> float:
    """argmax_shift_decode's least time at [n, 17, 64, 48]: one read of the
    float32 heatmaps and one write of the coordinates and maxima; the
    argmax's compares are far below the bytes."""
    rows = n * 17
    return 4 * (rows * 64 * 48 + rows * 3) / HBM_BYTES_PER_MS


def time_decode(device: torch.device) -> dict:
    """Phase 3, times: all device times with the calls queued (CUDA events),
    beside the per-call time back to back where it says so.

    The kernel and its plain version warm in L2; the kernel cold in L2,
    rotating over ``COLD_HEATMAPS`` heatmaps of more than 50 MB together; the
    launch floor (the kernel on a [1, 1, 1, 1] heatmap, and an empty kernel);
    ``torch.max(dim=1)``, the one PyTorch call that gives each row's maximum
    and its first index (the kernel's function at shift off); and the
    serving decoder per chunk through the kernel against the plain
    composition. The plain compositions launch tens of small kernels per
    call, so they are queued ``PLAIN_ITERS`` calls at a time, under the
    launch queue's depth.
    """
    rng = np.random.RandomState(SEED + 6)
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    for n in (BATCH_SIZE, 128):
        x = torch.from_numpy(rng.randn(n, 17, 64, 48).astype(np.float32)).to(device)
        cold = [torch.randn((n, 17, 64, 48), generator=gen, device=device)
                for _ in range(COLD_HEATMAPS)]
        bound = decode_bound_ms(n)
        for shift in (False, True):
            for queued in (True, False):
                kernel = time_ms(lambda: argmax_shift_decode(x, shift), queued)
                plain = time_ms(lambda: argmax_shift_decode_plain(x, shift), queued,
                                iters=PLAIN_ITERS if queued else 100)
                what = "device time" if queued else "per call, back to back"
                print(f"decode [{n},17,64,48] shift={shift} {what}: kernel {kernel:.5f} ms, "
                      f"plain {plain:.5f} ms")
                out[(n, shift, queued)] = (kernel, plain)
            cold_ms = time_ms(cycling(lambda h: argmax_shift_decode(h, shift), cold), True)
            warm_ms = out[(n, shift, True)][0]
            print(f"decode [{n},17,64,48] shift={shift} cold in L2 ({COLD_HEATMAPS} heatmaps, "
                  f"{COLD_HEATMAPS * x.numel() * 4 / 1e6:.1f} MB in turn): kernel {cold_ms:.5f} ms; "
                  f"bound {bound:.5f} ms (HBM bytes); kernel at {bound / warm_ms:.3f} of it warm, "
                  f"{bound / cold_ms:.3f} cold")
            out[(n, shift, "cold")] = cold_ms
        library = time_ms(lambda: torch.max(x.view(n * 17, 64 * 48), dim=1), True)
        print(f"decode [{n},17,64,48] library call torch.max(x.view(N*K, H*W), dim=1) device "
              f"time: {library:.5f} ms (kernel at shift=False {out[(n, False, True)][0]:.5f} ms)")
        out[(n, "library")] = library
        del cold
    one = torch.from_numpy(rng.randn(1, 1, 1, 1).astype(np.float32)).to(device)
    out["floor"] = time_ms(lambda: argmax_shift_decode(one, False), True)
    # one block of one thread that returns at once: the cost of a launch alone
    out["empty"] = time_ms(lambda: torch.cuda._sleep(0), True)
    print(f"decode launch floor, the kernel on a [1,1,1,1] heatmap, device time: "
          f"{out['floor']:.5f} ms; an empty kernel (torch.cuda._sleep(0)): {out['empty']:.5f} ms")

    decoder = create_decoder(HRNET_W32["decoder_name"], **HRNET_W32["decoder_setting"])
    kw = {"shift": decoder.shift_coordinate, "to_original": decoder.to_original,
          "use_udp": decoder.use_udp, "pixel_std": decoder.pixel_std}
    x = torch.from_numpy(rng.randn(BATCH_SIZE, 17, 64, 48).astype(np.float32)).to(device)
    crops = crop_inputs(rng, BATCH_SIZE, device)
    for queued in (True, False):
        fused = time_ms(lambda: decoder(x, *crops), queued)
        plain = time_ms(lambda: decode_heatmap_plain(x, *crops, **kw), queued,
                        iters=PLAIN_ITERS if queued else 100)
        what = "device time" if queued else "per call, back to back"
        print(f"decoder per {BATCH_SIZE}-crop chunk, {what}: through the kernel {fused:.5f} ms, "
              f"plain composition {plain:.5f} ms")
        out[("decoder", queued)] = (fused, plain)
    ops = device_ops(lambda: decoder(x, *crops))
    plain_ops = device_ops(lambda: decode_heatmap_plain(x, *crops, **kw))
    print(f"decoder call on a CUDA heatmap under torch.profiler: {len(ops)} device operation(s) "
          f"{ops}; the plain composition: {len(plain_ops)}")
    if len(ops) != 1:
        raise AssertionError(f"one decoder call ran {len(ops)} device operations, not 1: {ops}")
    out["decoder_ops"] = len(ops)
    return out


def build_kernels() -> None:
    """Phase 2: one nvcc per source, all started together; print each ptxas report."""
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        for built in pool.map(load_library, KERNEL_SOURCES):
            print(f"built {built.path.name} in {built.build_seconds:.2f} s")
            print(built.log.strip())


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values (8 significand bits) at |v|."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7)


def conv_chain_cases(rng: np.random.RandomState):
    """(name, x, weights) float32 cases: every depth 1-8 at C 4, 8, 32 and sizes
    that are not multiples of the 16x16 tile. Weights are He-scaled, so each
    layer keeps activations O(1) and no layer's gain hides another's error."""
    for c in (4, 8, 32):
        for h, w in ((1, 1), (3, 5), (16, 16), (65, 49)):
            for depth in range(1, 9):
                x = rng.randn(2, h, w, c)
                ws = rng.randn(depth, 3, 3, c, c) * np.sqrt(2.0 / (9 * c))
                yield f"C{c} {h}x{w} L{depth}", x, ws


def check_conv_chain(device: torch.device) -> None:
    """Phase 6: the conv chain kernel against its plain version on the GPU.

    float32 with TF32 off: the kernel and cuDNN sum each layer's 9C products
    in different orders. Two orders of an n-term float32 sum differ by at
    most about n * eps * sum|terms|, and with He-scaled weights sum|terms| is
    of the order of the largest output; over L layers of gain about 1 the
    differences add. So max|diff| <= 9 * C * L * eps * max|plain|.

    bf16 at depth 1: both sum in float32 and round once to bf16, so an
    element may land on the neighbouring bf16 value: |diff| <= one bf16 ulp
    of the larger of the two. An output whose float32 sum lies within the
    float32 order bound of zero may be cut by the ReLU on one side only, so
    that bound (9 * C * eps * max|plain|) is added as an absolute floor.
    """
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    eps = torch.finfo(torch.float32).eps
    worst = {}
    for name, x_np, ws_np in conv_chain_cases(rng):
        x = torch.from_numpy(x_np.astype(np.float32)).to(device)
        ws = torch.from_numpy(ws_np.astype(np.float32)).to(device)
        depth, c = ws.shape[0], ws.shape[-1]
        kernel = fused_conv_chain(x, ws)
        plain = conv_chain_plain(x, ws)
        err = float((kernel - plain).abs().max())
        scale = float(plain.abs().max())
        bound = 9 * c * depth * eps * scale
        key = name.rsplit(" ", 1)[0]
        worst[key] = max(worst.get(key, 0.0), err / max(scale, 1e-30) / eps)
        if not (err <= bound and bool(torch.isfinite(kernel).all())):
            raise AssertionError(f"conv chain f32 {name}: max|diff| {err:.3e} > bound {bound:.3e}")
    for key, ratio in worst.items():
        print(f"conv chain f32 {key} depths 1-8: worst max|diff| = {ratio:.2f} eps x max|plain| "
              f"(bound 9*C*L eps)")

    for c in (4, 8, 32):
        for h, w in ((1, 1), (3, 5), (65, 49), (64, 48)):
            x = torch.from_numpy(rng.rand(4, h, w, c).astype(np.float32) * 2 - 1)
            ws = torch.from_numpy(rng.rand(1, 3, 3, c, c).astype(np.float32) * 0.1 - 0.05)
            x, ws = x.to(device).bfloat16(), ws.to(device).bfloat16()
            kernel = fused_conv_chain(x, ws).float()
            plain = conv_chain_plain(x, ws).float()
            diff = (kernel - plain).abs()
            floor = 9 * c * eps * float(plain.abs().max())
            ok = diff <= bf16_ulp(torch.maximum(kernel.abs(), plain.abs())) + floor
            ulps = int((diff > 0).sum())
            print(f"conv chain bf16 C{c} {h}x{w} L1: {ulps} of {diff.numel()} elements differ, "
                  f"all within one bf16 ulp: {bool(ok.all())}")
            if not bool(ok.all()):
                raise AssertionError(f"conv chain bf16 C{c} {h}x{w}: differs by more than one ulp")

    check_bf16_chains(device, rng)


def bf16_chain_cases(rng: np.random.RandomState):
    """(name, x, weights) bf16 cases of the tensor-core kernel: depths 1-8 at
    C 4, 8, 16, 32, 64, on sizes that are smaller than its 16x16 tile, ragged,
    one tile, and the probe's 64x48. He-scaled weights of random sign, as in
    the float32 cases."""
    for c in (4, 8, 16, 32, 64):
        for h, w in ((1, 1), (3, 5), (16, 16), (65, 49), (64, 48)):
            for depth in range(1, 9):
                x = rng.randn(2, h, w, c)
                ws = rng.randn(depth, 3, 3, c, c) * np.sqrt(2.0 / (9 * c))
                yield f"C{c} {h}x{w} L{depth}", x, ws


def check_bf16_chains(device: torch.device, rng: np.random.RandomState) -> None:
    """Phase 6, bf16: the tensor-core kernel against cuDNN, depths 1-8.

    Both sum each layer in float32 and round once to bf16, in different
    orders, so after a layer an element may sit on the neighbouring bf16
    value: one ulp. A bf16 ulp at |v| is 2^(floor(log2|v|) - 7), between
    2^-8 and 2^-7 of |v|; at most one ulp of the largest output m is
    ulp(m) <= 2^-7 m. The He-scaled next layer carries such a difference on
    at the activations' scale and adds its own, so over L layers
    max|diff| <= L * ulp(m), m = max(max|kernel|, max|plain|). A float32
    sum that lies within rounding of 0 may be cut by the ReLU on one side
    only, so the float32 order bound 9 * C * L * eps * m is added as a floor.
    The worst max|diff| is also printed in units of L * 2^-8 * m.

    Each chain must count one tensor-core launch, and the kernel fusing 1, 2
    or 4 layers per launch (each that fits shared memory) must give the same
    bits: every output pixel sums its taps and channels in one order whatever
    the grouping, and a pixel outside the image is 0 between fused layers as
    between launches. An input whose base is not 16 B aligned, which the
    kernel stages without TMA, must give the bits of an aligned copy.
    """
    eps = torch.finfo(torch.float32).eps
    worst = {}
    for name, x_np, ws_np in bf16_chain_cases(rng):
        x = torch.from_numpy(x_np.astype(np.float32)).to(device).bfloat16()
        ws = torch.from_numpy(ws_np.astype(np.float32)).to(device).bfloat16()
        depth, c = ws.shape[0], ws.shape[-1]
        tensor_core = fused_conv_chain.tensor_core_launches
        out = fused_conv_chain(x, ws)
        if fused_conv_chain.tensor_core_launches != tensor_core + 1:
            raise AssertionError(f"conv chain bf16 {name} did not run on the tensor cores")
        for g in (1, 2, 4):
            if smem_bytes(torch.bfloat16, c, g) <= MAX_SMEM_PER_BLOCK:
                other = conv_chain_launch(x, ws, split_layers(depth, g))
                if not torch.equal(other, out):
                    raise AssertionError(f"conv chain bf16 {name}: {g} layers per launch "
                                         f"differ from {FUSED_LAYERS}")
        kernel = out.float()
        plain = conv_chain_plain(x, ws).float()
        err = float((kernel - plain).abs().max())
        m = max(float(kernel.abs().max()), float(plain.abs().max()))
        bound = depth * float(bf16_ulp(torch.tensor(m))) + 9 * c * depth * eps * m
        key = f"C{c}"
        worst[key] = max(worst.get(key, 0.0), err / max(depth * 2.0**-8 * m, 1e-30))
        if not (err <= bound and bool(torch.isfinite(kernel).all())):
            raise AssertionError(f"conv chain bf16 {name}: max|diff| {err:.3e} > bound {bound:.3e}")
    # a base that is not 16 B aligned: the kernel stages and stores without TMA
    flat = torch.from_numpy(rng.randn(2 * 64 * 48 * 32 + 1).astype(np.float32)).to(device)
    x = flat.bfloat16()[1:].view(2, 64, 48, 32)
    ws = torch.from_numpy((rng.randn(3, 3, 3, 32, 32) * np.sqrt(2.0 / (9 * 32))).astype(
        np.float32)).to(device).bfloat16()
    if not torch.equal(fused_conv_chain(x, ws), fused_conv_chain(x.clone(), ws)):
        raise AssertionError("conv chain bf16: an unaligned input gives other bits than an aligned one")
    print("conv chain bf16 C32 64x48 L3 from an unaligned base: bit for bit equal to the aligned run")
    for key, ratio in worst.items():
        print(f"conv chain bf16 {key} depths 1-8, 5 sizes: worst max|diff| = {ratio:.3f} x "
              f"L*2^-8*max|out| (bound L ulp(max|out|) <= 2 of these); every grouping bit for bit "
              f"equal; every chain on the tensor cores")


def drive_probe(device: torch.device) -> dict:
    """Phase 7: the probe's own run at its three geometries, bf16, depth 8.

    The chain's layers round to bf16 on both sides, so a bf16 ulp of
    difference may arise in any layer and carry on: reldiff (max|diff| over
    max|plain|) <= L half-ulps of bf16 = L * 2^-9. The weights are all
    positive, so the following layers average such a difference rather than
    amplify it. Counts launches of the kernel on this path.
    """
    bound = probe.DEPTH * 2.0**-9
    rng = np.random.RandomState(0)
    fused_conv_chain.launches = 0
    fused_conv_chain.tensor_core_launches = 0
    rows = [probe.run(*g, rng=rng, iters=PROBE_ITERS, device=device) for g in probe.GEOMETRIES]
    launches = fused_conv_chain.launches
    tensor_core = fused_conv_chain.tensor_core_launches
    print(f"conv chain kernel launches on the probe's path: {launches}, of them on the tensor "
          f"cores: {tensor_core}")
    for row in rows:
        if not (row["finite"] and row["reldiff"] <= bound):
            raise AssertionError(f"probe {row['tag']}: reldiff {row['reldiff']:.3e} > {bound:.3e}")
    print(f"probe reldiff within {bound:.4e} at every geometry")
    if launches == 0:
        raise AssertionError("the probe launched no conv chain kernel")
    if tensor_core != launches:
        raise AssertionError(f"{launches - tensor_core} of the probe's chains did not run on "
                             f"the tensor cores")
    return {"launches": launches, "tensor_core_launches": tensor_core, "rows": rows}


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


def compare_with_cpu(predictor: TopDownPredictor, cpu_predictor: TopDownPredictor, image, boxes,
                     xy_atol: float = 0.0, answers=None) -> None:
    """Phase 5 (and 15): the same request through the port on the GPU and on the CPU.

    The heatmaps are compared at the precision the predictor serves in: its
    calls have left TF32 off. Keypoints whose heatmap peak is clear agree
    within ``xy_atol`` px (phase 5: exactly). ``answers``: the GPU's and the
    CPU's keypoints for the request, when the caller has them already.
    """
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    print(f"card-vs-CPU: after serving, cudnn.allow_tf32, cuda.matmul.allow_tf32 = {tf32}")
    if any(tf32):
        raise AssertionError("the predictor did not serve in full float32")
    net, cpu_net = predictor.net, cpu_predictor.net
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

    preds_gpu, preds_cpu = answers or (predictor(image, boxes), cpu_predictor(image, boxes))
    top2 = torch.topk(heat_cpu.flatten(2), 2, dim=2).values
    # a peak that leads by more than both maps' error can not change place
    qualified = ((top2[..., 0] - top2[..., 1]) > 2 * tol).numpy()
    same = (np.abs(preds_gpu[..., :2] - preds_cpu[..., :2]) <= xy_atol).all(-1)
    print(f"card-vs-CPU keypoints: {int(qualified.sum())} of {qualified.size} joints have a "
          f"top-2 gap > {2 * tol:.3e}; {int(same[qualified].sum())} of them agree "
          + (f"within {xy_atol} px" if xy_atol else "exactly"))
    if not qualified.any() or not same[qualified].all():
        raise AssertionError("keypoints differ where the heatmap peak is clear")
    score_err = float(np.abs(preds_gpu[..., 2] - preds_cpu[..., 2]).max())
    if score_err > tol:
        raise AssertionError(f"scores differ by {score_err}")


def write_synthetic_coco(root: str, train_images: int = 0, val_images: int = EVAL_IMAGES,
                         people: int = EVAL_PEOPLE) -> dict:
    """tools/make_synthetic_coco.py's splits under ``root`` (person layout):
    {"train": (image root, annotation file), "val": (...)}."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                          "make_synthetic_coco.py")
    out = subprocess.run(
        [sys.executable, script, "--out", root, "--train-images", str(train_images),
         "--val-images", str(val_images), "--people", str(people), "--layout", "person"],
        capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"make_synthetic_coco.py failed:\n{out.stdout}\n{out.stderr}")
    print("\n".join(out.stdout.strip().splitlines()[-2 if train_images else -1:]))
    return {split: (os.path.join(root, split, "images"),
                    os.path.join(root, split, "annotations.json")) for split in ("train", "val")}


def eval_loader(args: Config, batch_size: int):
    """The eval entry's val loader over ``args``, at ``batch_size``."""
    dataset = create_dataset(args.val_root, args.val_label, dataset_format=args.dataset_format,
                             is_train=False, use_gt_bbox_for_val=args.val_use_gt_bbox,
                             num_workers=args.num_parallel_workers, config=args.dataset_setting)
    return create_pipeline(dataset, transforms=args.val_transforms, method=args.pipeline_method,
                           batch_size=batch_size, is_train=False,
                           normalize_mean=args.normalize_mean, normalize_std=args.normalize_std,
                           num_workers=args.num_parallel_workers, config=args.dataset_setting)


def eval_inferencer(net: nn.Module, args: Config, device: torch.device, amp_level: str,
                    tta: bool):
    """The eval entry's inferencer over ``net``; ``tta`` turns on hflip TTA with
    ``shift_heatmap``."""
    setting = dict(args.eval_setting, hflip_tta=tta, shift_heatmap=tta)
    decoder = create_decoder(args.decoder_name, **args.decoder_setting)
    return create_inferencer(create_eval_network(net, decoder), name=args.inference_method,
                             config=setting, dataset_config=args.dataset_setting, device=device,
                             amp_level=amp_level)


def check_checkpoint_round_trip(net: nn.Module, path: str) -> None:
    """Phase 8: the port's checkpoint of ``net``, loaded strictly into a fresh net,
    gives every tensor back bit for bit."""
    save_checkpoint(path, net)
    fresh = create_network(HRNET_W32["backbone_name"], HRNET_W32["head_name"],
                           num_joints=HRNET_W32["num_joints"],
                           backbone_args=HRNET_W32["backbone_setting"],
                           head_args=HRNET_W32["head_setting"])
    restore_train_state(path, fresh)
    want, got = net.state_dict(), fresh.state_dict()
    if list(got) != list(want):
        raise AssertionError("the restored net's state_dict has other keys")
    for key, value in want.items():
        restored = got[key]
        if (restored.dtype != value.dtype or restored.shape != value.shape or not torch.equal(
                restored.reshape(-1).view(torch.uint8), value.cpu().reshape(-1).view(torch.uint8))):
            raise AssertionError(f"the checkpoint round trip changed {key}")
    print(f"checkpoint round trip: {len(want)} tensors, {os.path.getsize(path)} B, every one "
          f"bitwise equal after a strict load into a fresh net")


def run_eval(args: Config, device: torch.device, label: str) -> dict:
    """Phase 8: one evaluation through the eval entry; the decode kernel's
    launches are counted on that run alone."""
    timings = {}
    torch.cuda.synchronize()
    argmax_shift_decode.launches = 0
    stats = evaluate(args, device=device, timings=timings)
    launches = argmax_shift_decode.launches
    records, batches, infer_s = timings["records"], timings["batches"], timings["infer_s"]
    print(f"eval {label}: {records} records in {batches} batches; inferencer {infer_s:.3f} s "
          f"({records / infer_s:.1f} crops/s, host loading included), evaluator "
          f"{timings['eval_s']:.3f} s; decode kernel launches {launches}")
    print(f"eval {label} stats: {json.dumps({k: float(v) for k, v in stats.items()})}")
    if launches != batches:
        raise AssertionError(f"{batches} eval batches made {launches} decode kernel launches")
    values = np.array([float(v) for v in stats.values()])
    if len(values) != 10 or not (np.isfinite(values) & (values >= -1) & (values <= 1)).all():
        raise AssertionError(f"eval {label}: malformed COCO stats {stats}")
    return dict(timings, launches=launches, stats=stats)


def time_eval_batch(net: nn.Module, args: Config, device: torch.device) -> dict:
    """Phase 8: where an eval batch's time goes. The host loader alone over the
    val set; on its first batch, at the recipe's precision, the forward with
    TTA off and on (back to back, as the inferencer runs it) and the decode
    kernel on that batch's float32 heatmap (device time)."""
    start = time.perf_counter()
    batch, crops, batches = None, 0, 0
    for b in eval_loader(args, args.batch_size):
        if batch is None:
            batch = b
        crops, batches = crops + len(b["bbox_ids"]), batches + 1
    load_s = time.perf_counter() - start
    print(f"eval loader alone ({args.num_parallel_workers} threads): {crops} crops in "
          f"{batches} batches in {load_s:.3f} s, {crops / load_s:.1f} crops/s")
    out = {"loader_crops_per_s": crops / load_s}
    for tta in (False, True):
        inferencer = eval_inferencer(net, args, device, args.amp_level, tta)
        image = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2).contiguous()
        ms = time_ms(lambda: inferencer.heatmaps(image), queued=False, iters=5, repeats=3)
        print(f"eval forward [{len(image)},3,256,192] {args.amp_level} TTA {tta}: {ms:.3f} ms "
              f"per batch ({len(image) / ms * 1e3:.1f} crops/s)")
        out[f"forward_ms_tta_{tta}"] = ms
        if not tta:
            heat = inferencer.heatmaps(image).float()
            crops_in = [torch.from_numpy(np.asarray(batch[k], np.float32)).to(device)
                        for k in ("center", "scale", "bbox_scores")]
            decoder = inferencer.decoder
    out["decode_ms"] = time_ms(lambda: decoder(heat, *crops_in), queued=True)
    out["decode_bound_ms"] = decode_bound_ms(len(heat))
    print(f"eval decode {list(heat.shape)} (this batch's heatmap) device time: "
          f"{out['decode_ms']:.5f} ms; bound {out['decode_bound_ms']:.5f} ms (HBM bytes)")
    return out


def compare_eval_with_cpu(net: nn.Module, args: Config, device: torch.device,
                          amp_level: str) -> None:
    """Phase 8: the first ``EVAL_CPU_CROPS`` crops of the eval set through the
    inferencer at ``amp_level`` on the GPU and on the CPU, TTA off and on.

    At O0 held to phase 5's tolerance: heatmaps and joint scores within
    ``HEATMAP_RTOL`` of the largest heatmap value, and the joints whose decode
    is clear of twice that within ``EVAL_XY_ATOL`` px. At O2 (bf16 autocast on
    both) the scores within ``O2_SCORE_RTOL`` of it, the joints clear of that
    within ``EVAL_XY_ATOL`` px, and at least ``O2_AGREE`` of all joints so.
    """
    batch = next(iter(eval_loader(args, EVAL_CPU_CROPS)))
    cpu_net = copy.deepcopy(net).cpu()
    shift = args.decoder_setting["shift_coordinate"]
    for tta in (False, True):
        gpu = eval_inferencer(net, args, device, amp_level, tta)
        cpu = eval_inferencer(cpu_net, args, torch.device("cpu"), amp_level, tta)
        preds_gpu, boxes_gpu, heat_gpu = (t.cpu().float() for t in gpu.infer_batch(batch))
        preds_cpu, boxes_cpu, heat_cpu = (t.float() for t in cpu.infer_batch(batch))
        if amp_level == "O0":
            tol = HEATMAP_RTOL * float(heat_cpu.abs().max())
            heat_tol, clear_gap, agree = tol, 2 * tol, 1.0
        else:
            tol = O2_SCORE_RTOL * float(heat_cpu.abs().max())
            heat_tol, clear_gap, agree = float("inf"), tol, O2_AGREE
        heat_err = float((heat_gpu - heat_cpu).abs().max())
        score_err = float((preds_gpu[..., 2] - preds_cpu[..., 2]).abs().max())
        clear = decode_margin(heat_cpu, shift) > clear_gap
        xy_err = (preds_gpu[..., :2] - preds_cpu[..., :2]).abs().amax(-1)
        worst = float(xy_err[clear].max()) if clear.any() else float("nan")
        close = float((xy_err <= EVAL_XY_ATOL).float().mean())
        print(f"eval card-vs-CPU, {amp_level}, TTA {tta}, {len(heat_cpu)} crops: heatmaps max "
              f"|diff| {heat_err:.3e}{'' if amp_level == 'O0' else ' (not held)'}, scores "
              f"{score_err:.3e} (tolerance {tol:.3e}); {int(clear.sum())} of {clear.numel()} "
              f"joints clear of {clear_gap:.3e}, their keypoints max |diff| {worst:.3e} px "
              f"(tolerance {EVAL_XY_ATOL}); {close:.3f} of all keypoints within it (at least "
              f"{agree}), {int((xy_err == 0).sum())} equal")
        if (heat_err > heat_tol or score_err > tol or not clear.any() or worst > EVAL_XY_ATOL
                or close < agree):
            raise AssertionError(f"eval on the GPU disagrees with the CPU, {amp_level}, TTA {tta}")
        if not torch.allclose(boxes_gpu, boxes_cpu, rtol=1e-6, atol=0):
            raise AssertionError(f"eval boxes on the GPU disagree with the CPU's, TTA {tta}")


def eval_fixture(root: str, device: torch.device) -> list:
    """Phase 8: the JAX-trained fixture checkpoint (tests/fixtures), read by the
    port's msgpack reader, evaluated on its val split on the GPU and on the
    CPU, at O0 and at O2: the GPU's AP is above 0 and within
    ``FIXTURE_AP_ATOL`` (O0) or ``FIXTURE_O2_AP_ATOL`` (O2) of the CPU's; then
    its crops at O2 through the inferencer on both. Returns the GPU's runs."""
    from tests.fixtures import tiny_coco  # numpy and cv2 only

    register_port_backbone()
    val_root, val_label = tiny_coco.write_val(os.path.join(root, "fixture"))
    runs = []
    for amp_level, atol, recorded in (("O0", FIXTURE_AP_ATOL, "jax_stats"),
                                      ("O2", FIXTURE_O2_AP_ATOL, "jax_stats_o2")):
        args = Config(**dict(RECORD["config"], amp_level=amp_level, val_root=val_root,
                             val_label=val_label, ckpt=CKPT,
                             result_path=os.path.join(root, "fixture_result.json")))
        gpu = run_eval(args, device, f"fixture checkpoint on the GPU, {amp_level}")
        ap_gpu = float(gpu["stats"]["AP"])
        ap_cpu = float(evaluate(args, device=torch.device("cpu"))["AP"])
        print(f"fixture AP at {amp_level}: GPU {ap_gpu:.6f}, CPU {ap_cpu:.6f}, |diff| "
              f"{abs(ap_gpu - ap_cpu):.2e} (tolerance {atol}); the JAX package recorded "
              f"{RECORD[recorded]['AP']:.6f} on the CPU where the fixture was made (not "
              f"asserted: this machine's image decoders may differ)")
        if not (ap_gpu > 0 and abs(ap_gpu - ap_cpu) <= atol):
            raise AssertionError(f"the fixture checkpoint's AP at {amp_level} on the GPU is 0 "
                                 "or far from the CPU's")
        runs.append(gpu)
    net = create_network(args.backbone_name, args.head_name, num_joints=args.num_joints)
    net.load_state_dict(load_net_state_dict(CKPT, net), strict=True)
    compare_eval_with_cpu(net, args, device, "O2")
    return runs


def evaluation(net: nn.Module, device: torch.device) -> dict:
    """Phase 8: top-down evaluation through the eval entry, at full width.

    The serving net's weights go through the port's checkpoint and back, then
    ``tools/eval.evaluate`` runs the recipe (O2, batch 128, GT boxes, OKS-NMS)
    on synthetic COCO, with TTA off (a first pass, then ``EVAL_WARM_REPEATS``
    warm ones, whose crops/s give the rate's spread) and with TTA and
    ``shift_heatmap`` on; then the JAX-trained fixture checkpoint, the batch
    timings, and the GPU against the CPU. Returns the decode kernel's
    launches over the evaluation runs and the batch timings.
    """
    with tempfile.TemporaryDirectory() as root:
        val_root, val_label = write_synthetic_coco(root)["val"]
        ckpt = os.path.join(root, "ckpt", "hrnet_w32_random.pt")
        check_checkpoint_round_trip(net, ckpt)
        args = Config(**dict(HRNET_W32, val_root=val_root, val_label=val_label, ckpt=ckpt,
                             result_path=os.path.join(root, "result.json")))
        tta_args = Config(**dict(vars(args), eval_setting=dict(
            args.eval_setting, hflip_tta=True, shift_heatmap=True)))
        runs = [run_eval(args, device, "recipe O2, TTA off, first pass")]
        warm = [run_eval(args, device, f"recipe O2, TTA off, warm pass {i + 1}")
                for i in range(EVAL_WARM_REPEATS)]
        rates = sorted(r["records"] / r["infer_s"] for r in warm)
        median = statistics.median(rates)
        print(f"eval recipe O2, TTA off, {len(warm)} warm passes of {warm[0]['records']} crops: "
              f"inferencer {rates[0]:.1f} / {median:.1f} / {rates[-1]:.1f} crops/s (min / "
              f"median / max), spread {(rates[-1] - rates[0]) / median:.3f} of the median")
        runs += warm + [run_eval(tta_args, device, "recipe O2, TTA and shift_heatmap on")]
        runs += eval_fixture(root, device)
        times = time_eval_batch(net, args, device)
        compare_eval_with_cpu(net, args, device, "O0")
    return {"launches": sum(r["launches"] for r in runs),
            "batches": sum(r["batches"] for r in runs), **times}


def training_net(device: torch.device) -> nn.Module:
    """Full-width HRNet-W32 + hrnet_head with ``random_weights_``."""
    net = create_network(HRNET_W32["backbone_name"], HRNET_W32["head_name"],
                         num_joints=HRNET_W32["num_joints"],
                         backbone_args=HRNET_W32["backbone_setting"],
                         head_args=HRNET_W32["head_setting"])
    random_weights_(net, device)
    return net


def train_batch(rng: np.random.RandomState, n: int, device: torch.device):
    """Synthetic uint8-range crops [n, H, W, 3] and keypoints [n, 17, 3] inside them.

    What the host pipeline hands the device step after its affine crop
    (``device_pipeline: true``); 80% of the joints visible.
    """
    w, h = HRNET_W32["dataset_setting"]["image_size"]
    image = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, 1, (n, HRNET_W32["num_joints"], 2)) * [w - 1, h - 1]
    vis = rng.uniform(0, 1, (n, HRNET_W32["num_joints"], 1)) < 0.8
    keypoints = np.concatenate([xy, vis], axis=-1).astype(np.float32)
    return torch.from_numpy(image).to(device), torch.from_numpy(keypoints).to(device)


def recipe_schedule():
    cfg = HRNET_W32
    return create_lr_scheduler(cfg["scheduler"], lr=cfg["lr"], total_epochs=cfg["num_epochs"],
                               steps_per_epoch=STEPS_PER_EPOCH, warmup=cfg["warmup"],
                               **cfg["lr_scheduler_setting"])


def recipe_preprocess():
    """The device preprocess: normalize + the yaml's sigma-2 Gaussian targets."""
    cfg = HRNET_W32
    ds = cfg["dataset_setting"]
    _, target_kwargs = strip_host_target_transform(cfg["train_transforms"])
    return build_topdown_preprocess(ds["image_size"], ds["heatmap_size"],
                                    cfg["normalize_mean"], cfg["normalize_std"], **target_kwargs)


def recipe_net_with_loss(net: nn.Module):
    cfg = HRNET_W32
    return create_network_with_loss(net, create_loss(cfg["loss"], **cfg["loss_setting"]),
                                     has_extra_inputs=cfg["loss_with_extra_input"])


def recipe_step(net: nn.Module, amp_level: str, schedule=None):
    """hrnet_w32_tpu.yaml's train step over ``net``: the device preprocess,
    joint_mse with target weights, adamw with its decay and grouping.
    Without a schedule the rate is the yaml's ``lr``, constant."""
    cfg = HRNET_W32
    optimizer = create_optimizer(net, cfg["optimizer"], learning_rate=cfg["lr"],
                                 weight_decay=cfg["weight_decay"],
                                 filter_bias_and_bn=cfg["filter_bias_and_bn"],
                                 **cfg["optimizer_setting"])
    return build_train_step(recipe_net_with_loss(net), optimizer, schedule,
                            preprocess=recipe_preprocess(), amp_level=amp_level)


def train_throughput(device: torch.device) -> dict:
    """Phase 9: the recipe's step at batch 128, O2; warm-up, then timed steps.

    Each step is timed on the host clock up to a ``torch.cuda.synchronize``.
    Returns the img/s and the step's median (ms).
    """
    n = HRNET_W32["batch_size"]
    net = training_net(device)
    schedule = recipe_schedule()
    step = recipe_step(net, HRNET_W32["amp_level"], schedule)
    image, keypoints = train_batch(np.random.RandomState(SEED + 1), n, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS):
        start = time.perf_counter()
        losses.append(step(image, keypoints))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).cpu()
    timed = ms[TRAIN_WARMUP_STEPS:]
    img_s = n * len(timed) / (sum(timed) / 1e3)
    finite = bool(torch.isfinite(losses).all())
    print(f"train step, batch {n}, {HRNET_W32['amp_level']}: warm-up steps "
          + ", ".join(f"{t:.1f}" for t in ms[:TRAIN_WARMUP_STEPS]) + " ms")
    print(f"train step, batch {n}, {HRNET_W32['amp_level']}, {len(timed)} timed steps: "
          f"median {statistics.median(timed):.3f} ms, min {min(timed):.3f}, "
          f"max {max(timed):.3f}; {img_s:.1f} img/s")
    print(f"train step peak torch.cuda.max_memory_allocated: {peak} B ({peak / 2**30:.2f} GiB)")
    print(f"train step losses: first {float(losses[0]):.6g}, last {float(losses[-1]):.6g}, "
          f"lr of the last step {schedule(step.count - 1):.6g}; all {len(losses)} finite: {finite}")
    if not finite:
        raise AssertionError("a train step gave a non-finite loss")
    return {"images_per_sec": img_s, "step_median_ms": statistics.median(timed)}


def head_init_(net: nn.Module, rng: np.random.RandomState) -> None:
    """The head's own initialisation, from a numpy seed: a truncated normal of
    sd 1e-3 (+-2 sd) and a zero bias, so the first heatmaps sit near zero."""
    with torch.no_grad():
        w = np.clip(rng.standard_normal(net.head.head.weight.shape), -2.0, 2.0) * 1e-3
        net.head.head.weight.copy_(torch.from_numpy(w.astype(np.float32)))
        net.head.head.bias.zero_()


def mark_joints(image: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """Paint each visible joint into its crop as a square of that joint's own
    colour (``MARK_SIZE`` pixels a side), so the targets can be read off the
    image."""
    palette = torch.from_numpy(np.random.RandomState(SEED).randint(0, 256, (17, 3))).to(
        image.device, image.dtype)
    n, h, w, _ = image.shape
    ys, xs = torch.arange(h, device=image.device), torch.arange(w, device=image.device)
    image = image.clone()
    half = MARK_SIZE // 2
    for k in range(keypoints.shape[1]):
        x, y, vis = (keypoints[:, k, i].round().long() for i in range(3))
        inside = (((ys[None, :, None] - y[:, None, None]).abs() <= half)
                  & ((xs[None, None, :] - x[:, None, None]).abs() <= half)
                  & (vis[:, None, None] > 0))
        image[inside] = palette[k]
    return image


def check_loss_falls(device: torch.device) -> None:
    """Phase 10: the recipe's optimizer at constant lr on one fixed batch learns.

    The head starts from its own near-zero initialisation and the batch's
    joints are painted into its crops (``mark_joints``), so the net can
    learn where the Gaussians lie. After ``LOSS_FALL_STEPS`` steps:
    - the loss is below ``LOSS_FALL_RATIO`` of the first step's;
    - it is below ``LOSS_ZERO_RATIO`` of the loss of an all-zero prediction
      on the same batch, ``mean(target^2 * w)``: the net predicts the
      targets better than no heatmap at all, which shrinking the head's
      output alone cannot do;
    - the backbone's parameters moved, as a whole, more than
      ``BACKBONE_MOVE_FACTOR`` times what the weight decay alone would move
      them (lr * wd per step): the backward reaches the backbone.
    """
    cfg = HRNET_W32
    net = training_net(device)
    head_init_(net, np.random.RandomState(SEED + 4))
    step = recipe_step(net, cfg["amp_level"])
    image, keypoints = train_batch(np.random.RandomState(SEED + 2), cfg["batch_size"], device)
    image = mark_joints(image, keypoints)
    _, target, weight = recipe_preprocess()(image, keypoints)
    zero_loss = float(create_loss(cfg["loss"], **cfg["loss_setting"])(
        torch.zeros_like(target), target, weight))
    start = [p.detach().clone() for p in net.backbone.parameters()]
    losses = [float(step(image, keypoints).sum()) for _ in range(LOSS_FALL_STEPS)]
    with torch.no_grad():
        moved = float(torch.stack([(p - p0).square().sum()
                                   for p, p0 in zip(net.backbone.parameters(), start)]).sum())
        norm = float(torch.stack([p0.square().sum() for p0 in start]).sum())
    moved = (moved / norm) ** 0.5
    decay_alone = cfg["lr"] * cfg["weight_decay"] * LOSS_FALL_STEPS
    print(f"loss on one fixed batch at lr {cfg['lr']}: "
          + ", ".join(f"{v:.5g}" for v in losses[::5]) + f", ..., {losses[-1]:.5g}")
    print(f"  step {LOSS_FALL_STEPS} / step 1 = {losses[-1] / losses[0]:.4f} (bound "
          f"{LOSS_FALL_RATIO}); / all-zero prediction's loss {zero_loss:.6g} = "
          f"{losses[-1] / zero_loss:.4f} (bound {LOSS_ZERO_RATIO}); backbone |p - p0| / |p0| = "
          f"{moved:.4e} (bound {BACKBONE_MOVE_FACTOR} x decay alone, {decay_alone:.1e})")
    if not (np.isfinite(losses).all() and losses[-1] < LOSS_FALL_RATIO * losses[0]
            and losses[-1] < LOSS_ZERO_RATIO * zero_loss
            and moved > BACKBONE_MOVE_FACTOR * decay_alone):
        raise AssertionError("the train step did not learn the fixed batch")


def _errors(got: dict, want: dict) -> dict:
    """Per tensor: max|got - want| / max|want|."""
    return {k: float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-300)
            for k in want}


def _summary(errs: dict) -> str:
    worst = max(errs, key=errs.get)
    return f"median {statistics.median(errs.values()):.3e}, worst {errs[worst]:.3e} ({worst})"


def _grads_and_stats(net: nn.Module):
    grads = {k: p.grad.detach().double().cpu() for k, p in net.named_parameters()}
    stats = {k: b.double().cpu() for k, b in net.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    return grads, stats


def _worst(errs: dict, n: int = 3) -> str:
    return "; ".join(f"{k} {errs[k]:.3e}" for k in sorted(errs, key=errs.get, reverse=True)[:n])


def compare_train_with_cpu(device: torch.device) -> None:
    """Phase 11: one train step at full width, batch 2, GPU against the port on the CPU.

    The recipe's schedule gives the first step lr 0, so the step computes the
    loss, gradients and BatchNorm statistics and moves no parameter.

    float64 on both (cuDNN has float64 convolutions; BatchNorm keeps float64):
    the same arithmetic summed in other orders, so the loss, every gradient
    tensor and every running statistic must agree to ``TRAIN_F64_RTOL`` of
    that tensor's largest |entry|. This holds the GPU's forward and backward
    to a well-conditioned answer.

    float32 (TF32 off), the precision the step runs in without autocast:
    the loss and the running statistics (forward quantities) are compared
    with the CPU's float32. The float32 gradient is not continuous in the
    rounding: of the ~37 M ReLU inputs of this step, ~90 lie within float32
    rounding of 0 and switch side between float32 and float64, and each
    switch adds or drops one pixel's share of a channel's gradient, up to
    1/96 of it in the 8x6 branch. So the CPU's own float32 gradient is off
    its float64 one by ~1e-2 of a tensor's largest entry (median over
    tensors) and up to ~0.25, worst in the 1/16- and 1/32-scale branches;
    with a smooth activation in place of ReLU the same comparison reads
    ~5e-5. So each float32 gradient is held against the CPU's float64 one,
    and the GPU's may be at most ``TRAIN_GRAD_FACTOR`` times as far from it
    as the CPU's float32 is, in the median over tensors and in the worst
    tensor.
    """
    cpu = torch.device("cpu")
    gpu_net = training_net(device)
    cpu_net = copy.deepcopy(gpu_net).cpu()
    image, keypoints = train_batch(np.random.RandomState(SEED + 3), TRAIN_CPU_BATCH, cpu)
    # PyTorch's default, set here so that the run shows the float32 step turns it off
    torch.backends.cudnn.allow_tf32 = True
    out = {}
    for name, net, dev in (("gpu32", copy.deepcopy(gpu_net), device),
                           ("cpu32", copy.deepcopy(cpu_net), cpu)):
        loss = recipe_step(net, "O0", recipe_schedule())(image.to(dev), keypoints.to(dev))
        out[name] = (loss.double().cpu(), *_grads_and_stats(net))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if any(tf32):
        raise AssertionError(f"the float32 train step left TF32 on: {tf32}")
    preprocess = recipe_preprocess()
    for name, net, dev in (("gpu64", gpu_net, device), ("cpu64", cpu_net, cpu)):
        net.double()
        loss = accum_loss_and_grads(
            recipe_net_with_loss(net), (image.to(dev), keypoints.to(dev)),
            preprocess=lambda *b: tuple(t.double() for t in preprocess(*b)))
        out[name] = (loss.cpu(), *_grads_and_stats(net))

    def loss_err(a, b):
        return float(((out[a][0] - out[b][0]).abs() / out[b][0].abs()).max())

    grads64 = _errors(out["gpu64"][1], out["cpu64"][1])
    f64 = {"loss": loss_err("gpu64", "cpu64"), "gradients": max(grads64.values()),
           "statistics": max(_errors(out["gpu64"][2], out["cpu64"][2]).values())}
    print(f"train step card-vs-CPU, float64, batch {TRAIN_CPU_BATCH}: loss {out['gpu64'][0].tolist()} "
          f"against {out['cpu64'][0].tolist()}; max|diff|/max|x| of the loss "
          f"{f64['loss']:.3e}, {len(grads64)} gradients {_summary(grads64)}, "
          f"{len(out['cpu64'][2])} running statistics {f64['statistics']:.3e}; "
          f"bound {TRAIN_F64_RTOL} each")
    f32_loss = loss_err("gpu32", "cpu32")
    stats_err = _errors(out["gpu32"][2], out["cpu32"][2])
    want = out["cpu64"][1]
    gpu_err, cpu_err = _errors(out["gpu32"][1], want), _errors(out["cpu32"][1], want)
    print(f"train step card-vs-CPU, float32, batch {TRAIN_CPU_BATCH}: loss "
          f"{out['gpu32'][0].tolist()} against {out['cpu32'][0].tolist()}, rel diff "
          f"{f32_loss:.3e} (rtol {TRAIN_LOSS_RTOL})")
    print(f"  BN running statistics against the CPU's float32, max|diff|/max|stat|: "
          f"{_summary(stats_err)}; bound {TRAIN_STATS_RTOL}")
    print(f"  gradients against the CPU's float64, max|diff|/max|g|: GPU {_summary(gpu_err)}; "
          f"CPU {_summary(cpu_err)}; bound {TRAIN_GRAD_FACTOR} x the CPU's")
    print(f"  worst float32 gradients, GPU: {_worst(gpu_err)}; CPU: {_worst(cpu_err)}")
    grads_ok = all(
        agg(gpu_err.values()) <= TRAIN_GRAD_FACTOR * agg(cpu_err.values())
        for agg in (statistics.median, max))
    if max(f64.values()) > TRAIN_F64_RTOL:
        raise AssertionError(f"the float64 GPU train step disagrees with the CPU's: {f64}")
    if not (f32_loss <= TRAIN_LOSS_RTOL and max(stats_err.values()) <= TRAIN_STATS_RTOL
            and grads_ok):
        raise AssertionError("the float32 GPU train step disagrees with the CPU beyond the "
                             "tolerances")


def time_train_loader(args: Config) -> dict:
    """Phase 12: the recipe's train loader alone (train transforms, batch 128,
    the yaml's workers), over 2 epochs with threads, then 2 with the process
    pool (whose first epoch includes starting it). Returns crops/s of each
    second epoch."""
    dataset = create_dataset(args.train_root, args.train_label,
                             dataset_format=args.dataset_format, is_train=True,
                             num_workers=args.num_parallel_workers, config=args.dataset_setting)
    threads = create_pipeline(dataset, transforms=args.train_transforms,
                              method=args.pipeline_method, batch_size=args.batch_size,
                              is_train=True, normalize_mean=args.normalize_mean,
                              normalize_std=args.normalize_std,
                              num_workers=args.num_parallel_workers, config=args.dataset_setting,
                              seed=SEED)
    processes = DataLoader(threads.dataset, threads.transforms, threads.final_columns,
                           batch_size=args.batch_size, is_train=True,
                           normalize_mean=args.normalize_mean, normalize_std=args.normalize_std,
                           num_workers=args.num_parallel_workers, seed=SEED,
                           worker_mode="process")
    out = {}
    try:
        for name, loader in (("threads", threads), ("processes", processes)):
            rates = []
            for _ in range(2):
                start = time.perf_counter()
                crops = sum(len(b["target_weight"]) for b in loader)
                rates.append(crops / (time.perf_counter() - start))
            print(f"train loader alone, {args.num_parallel_workers} {name}: {crops} crops per "
                  f"epoch ({len(loader)} batches of {args.batch_size}), {rates[0]:.1f} crops/s "
                  f"in the first epoch, {rates[1]:.1f} in the second")
            out[name] = rates[1]
    finally:
        processes.close()
    return out


def train_through_entry(root: str, phase9: dict, device: torch.device) -> dict:
    """Phase 12: hrnet_w32_tpu.yaml trained through the train entry on one GPU.

    The yaml as parsed from the file, with the data paths, ``num_epochs``,
    ``warmup``, ``val_interval`` and ``ckpt_save_dir`` overridden; then the
    last checkpoint through the eval entry, and a one-epoch resume from it.
    Returns the decode kernel's launches made by the callback's evaluations
    and the loader's and the entry's rates.
    """
    data = write_synthetic_coco(root, ENTRY_TRAIN_IMAGES, ENTRY_VAL_IMAGES, ENTRY_PEOPLE)
    (train_root, train_label), (val_root, val_label) = data["train"], data["val"]

    def parse(ckpt_dir: str, *options: str, ckpt=None) -> Config:
        flags = ["--device", str(device)] + (["--ckpt", ckpt] if ckpt else [])
        return train_entry.parse_train_args(
            ["--config", RECIPE_YAML, *flags, "--cfg-options", f"train_root={train_root}",
             f"train_label={train_label}", f"val_root={val_root}", f"val_label={val_label}",
             f"ckpt_save_dir={ckpt_dir}", *options])

    ckpt_dir = os.path.join(root, "entry")
    args = parse(ckpt_dir, f"num_epochs={ENTRY_EPOCHS}", f"warmup={ENTRY_WARMUP}",
                 f"val_interval={ENTRY_VAL_INTERVAL}")
    loader_rates = time_train_loader(args)

    torch.cuda.synchronize()
    start = time.perf_counter()
    argmax_shift_decode.launches = 0
    result = train_entry.train(args)
    launches = argmax_shift_decode.launches
    train_s = time.perf_counter() - start
    epochs = result["epochs"]
    base = phase9["images_per_sec"]
    for e in epochs:
        ap = f", AP {float(e['metrics']['AP']):.6f}" if e["metrics"] else ""
        print(f"entry epoch {e['epoch']}: loss {e['loss']:.6g}, lr {e['lr']:.6g}; "
              f"{e['images_per_sec']:.1f} img/s with the loader feeding the step "
              f"({e['images_per_sec'] / base:.3f} of phase 9's {base:.1f} on device-resident "
              f"batches); step median {e['step_median_s'] * 1e3:.1f} ms (phase 9: "
              f"{phase9['step_median_ms']:.1f}); wait on next(batches) median "
              f"{e['wait_median_s'] * 1e3:.1f} ms, {e['wait_total_s']:.2f} s in all over "
              f"{e['steps']} steps{ap}")
    warm = epochs[1:]
    rate = sum(e["images"] for e in warm) / sum(e["images"] / e["images_per_sec"] for e in warm)
    wait = sum(e["wait_total_s"] for e in warm) / sum(e["steps"] for e in warm)
    print(f"entry epochs 2-{len(epochs)}: {rate:.1f} img/s with the loader feeding the step, "
          f"{rate / base:.3f} of phase 9's; wait on the loader {wait * 1e3:.1f} ms per step; "
          f"{train_s:.1f} s for {len(epochs)} epochs with evaluations")

    evals = [e for e in epochs if e["metrics"]]
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    losses = [e["loss"] for e in epochs]
    last_stats = {k: float(v) for k, v in evals[-1]["metrics"].items()}
    print(f"entry: {len(evals)} evaluations of {val_batches} batch(es), decode kernel launches "
          f"{launches}; last stats {json.dumps(last_stats)}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the entry's losses are not finite or did not fall: {losses}")
    if not last_stats["AP"] > 0:
        raise AssertionError("the last evaluation's AP is 0")
    if launches != len(evals) * val_batches:
        raise AssertionError(f"{len(evals)} evaluations of {val_batches} batches made "
                             f"{launches} decode launches")
    last_path = os.path.join(ckpt_dir, "hrnet_w32_tpu_last.ckpt")
    best_path = os.path.join(ckpt_dir, "hrnet_w32_tpu_best.ckpt")
    if not (os.path.isfile(last_path) and os.path.isfile(best_path)):
        raise AssertionError(f"the callback did not write {last_path} and {best_path}")
    saved_step = load_checkpoint(last_path)["step"]

    stats = evaluate(Config(**dict(vars(args), ckpt=last_path,
                                   result_path=os.path.join(root, "entry_result.json"))),
                     device=device)
    worst = max(abs(float(stats[k]) - last_stats[k]) for k in last_stats)
    print(f"entry's last checkpoint (step {saved_step}) through the eval entry: "
          f"{json.dumps({k: float(v) for k, v in stats.items()})}; max |diff| against the "
          f"callback's {worst:.2e} (tolerance {ENTRY_STATS_ATOL})")
    if worst > ENTRY_STATS_ATOL:
        raise AssertionError("the last checkpoint's stats differ from the callback's")

    # the resume also takes its batches through DevicePrefetcher (pinned
    # memory, a side stream), the entry's `device_prefetch` path on the card
    resume_args = parse(os.path.join(root, "entry_resume"), "num_epochs=1",
                        f"warmup={ENTRY_RESUME_WARMUP}",
                        f"device_prefetch={ENTRY_RESUME_PREFETCH}", ckpt=last_path)
    resumed = train_entry.train(resume_args)
    steps = epochs[0]["steps"]
    schedule = create_lr_scheduler(resume_args.scheduler, lr=resume_args.lr, total_epochs=1,
                                   steps_per_epoch=steps,
                                   warmup=resume_args.warmup,
                                   **resume_args.lr_scheduler_setting)
    r = resumed["epochs"][0]
    print(f"entry resume from the last checkpoint for 1 epoch, device_prefetch "
          f"{ENTRY_RESUME_PREFETCH}: starts at step {resumed['start_step']} (saved "
          f"{saved_step}) with lr {schedule(saved_step):.6g}, ends at {resumed['step']}; loss "
          f"{r['loss']:.6g}, AP {float(r['metrics']['AP']):.6f}; {r['images_per_sec']:.1f} "
          f"img/s, step median {r['step_median_s'] * 1e3:.1f} ms, wait median "
          f"{r['wait_median_s'] * 1e3:.1f} ms")
    if not (resumed["start_step"] == saved_step == result["step"]
            and resumed["step"] == saved_step + steps):
        raise AssertionError("the resumed run did not continue the step count")
    return {"launches": launches, "loader": loader_rates, "images_per_sec": rate,
            "wait_per_step_s": wait, "data": data}


def entry_epochs(label: str, epochs: list) -> float:
    """Print each epoch of a run of the train entry; returns the img/s of
    epochs 2 on (the first includes cuDNN's autotuning)."""
    for e in epochs:
        ap = f", AP {float(e['metrics']['AP']):.6f}" if e["metrics"] else ""
        print(f"{label} epoch {e['epoch']}: loss {e['loss']:.6g}, lr {e['lr']:.6g}; "
              f"{e['images_per_sec']:.1f} img/s with the loader feeding the step; step median "
              f"{e['step_median_s'] * 1e3:.1f} ms; wait on next(batches) median "
              f"{e['wait_median_s'] * 1e3:.1f} ms, {e['wait_total_s']:.2f} s in all over "
              f"{e['steps']} steps{ap}")
    warm = epochs[1:]
    return sum(e["images"] for e in warm) / sum(e["images"] / e["images_per_sec"] for e in warm)


def train_simple_baseline(root: str, data: dict, device: torch.device, recipe: str) -> dict:
    """Phase 13: a SimpleBaseline recipe (``UDP_YAML`` or ``SB_YAML``) through the train entry.

    ResNet-50 + simple_baseline_head at full width, O2, batch 128, adamw,
    host targets (UDP ones for ``UDP_YAML``), on phase 12's synthetic COCO;
    overridden as phase 12 overrides: the data paths, ``num_epochs``,
    ``warmup``, ``val_interval`` (one evaluation, after the last epoch) and
    ``ckpt_save_dir``. It holds: finite losses, the last epoch's below the
    first's, AP above 0, one decode launch per val batch, the last
    checkpoint written. Returns the run's numbers and the parsed config.
    """
    name = os.path.splitext(os.path.basename(recipe))[0]
    (train_root, train_label), (val_root, val_label) = data["train"], data["val"]
    ckpt_dir = os.path.join(root, name)
    args = train_entry.parse_train_args(
        ["--config", recipe, "--device", str(device), "--cfg-options",
         f"train_root={train_root}", f"train_label={train_label}", f"val_root={val_root}",
         f"val_label={val_label}", f"ckpt_save_dir={ckpt_dir}", f"num_epochs={SB_EPOCHS}",
         f"warmup={ENTRY_WARMUP}", f"val_interval={SB_EPOCHS}"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    argmax_shift_decode.launches = 0
    result = train_entry.train(args)
    launches = argmax_shift_decode.launches
    train_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    epochs = result["epochs"]
    rate = entry_epochs(name, epochs)
    steps = sum(e["steps"] for e in epochs)
    step_median_ms = statistics.median(e["step_median_s"] for e in epochs[1:]) * 1e3
    print(f"{name} ({args.amp_level}, batch {args.batch_size}): "
          f"epochs 2-{len(epochs)} {rate:.1f} img/s with the loader feeding the step, median of "
          f"the epochs' step medians {step_median_ms:.1f} ms; {steps} steps and the evaluation "
          f"in {train_s:.1f} s; peak torch.cuda.max_memory_allocated {peak} B "
          f"({peak / 2**30:.2f} GiB)")
    evals = [e for e in epochs if e["metrics"]]
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    losses = [e["loss"] for e in epochs]
    stats = {k: float(v) for k, v in evals[-1]["metrics"].items()}
    print(f"{name}: {len(evals)} evaluation(s) of {val_batches} batch(es), decode kernel "
          f"launches {launches}; stats {json.dumps(stats)}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}'s losses are not finite or did not fall: {losses}")
    if not stats["AP"] > 0:
        raise AssertionError(f"{name}'s evaluation gave AP 0")
    if launches != len(evals) * val_batches:
        raise AssertionError(f"{len(evals)} evaluations of {val_batches} batches made "
                             f"{launches} decode launches")
    last_path = os.path.join(ckpt_dir, f"{name}_last.ckpt")
    if not os.path.isfile(last_path):
        raise AssertionError(f"the callback did not write {last_path}")
    return {"launches": launches, "name": name, "args": args, "ckpt": last_path, "stats": stats,
            "images_per_sec": rate, "step_median_ms": step_median_ms, "peak_bytes": peak,
            "steps": steps}


def eval_checkpoint(root: str, trained: dict, device: torch.device, dark: bool) -> dict:
    """Phase 14: a phase-13 run's last checkpoint through the eval entry with
    ``dark_udp_refine`` as given (one decode launch per eval batch); with it
    off, the 10 stats equal the callback's within ``ENTRY_STATS_ATOL``."""
    args, name = trained["args"], trained["name"]
    run_args = Config(**dict(vars(args), ckpt=trained["ckpt"], result_path=os.path.join(
        root, f"{name}_result_dark_{dark}.json"), decoder_setting=dict(
            args.decoder_setting, dark_udp_refine=dark)))
    run = run_eval(run_args, device, f"{name} checkpoint, dark_udp_refine {dark}")
    if not dark:
        worst = max(abs(float(run["stats"][k]) - trained["stats"][k]) for k in trained["stats"])
        print(f"{name} checkpoint through the eval entry against the callback's stats: max "
              f"|diff| {worst:.2e} (tolerance {ENTRY_STATS_ATOL})")
        if worst > ENTRY_STATS_ATOL:
            raise AssertionError(f"{name}'s checkpoint gives other stats than the callback's")
    return run


def eval_simple_baseline(root: str, trained: dict, device: torch.device) -> dict:
    """Phase 14: phase 13's UDP checkpoint through the eval entry with
    ``dark_udp_refine`` off and on (``eval_checkpoint``). Then, on one real
    eval batch's heatmap: the DARK decoder's device operations
    (torch.profiler) and device time per 32-crop chunk beside the decoder
    without it, and the DARK decoder on the card against its CPU run
    (coordinates within ``EVAL_XY_ATOL`` px, scores bitwise)."""
    args = trained["args"]
    runs = {dark: eval_checkpoint(root, trained, device, dark) for dark in (False, True)}

    net = create_network_from_config(args)
    net.load_state_dict(load_net_state_dict(trained["ckpt"], net), strict=True)
    batch = next(iter(eval_loader(args, args.batch_size)))
    inferencer = eval_inferencer(net, args, device, args.amp_level, False)
    image = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2).contiguous()
    heat = inferencer.heatmaps(image).float()
    crops = [torch.from_numpy(np.asarray(batch[k], np.float32)).to(device)
             for k in ("center", "scale", "bbox_scores")]
    dark = create_decoder(args.decoder_name, **dict(args.decoder_setting, dark_udp_refine=True))
    plain = create_decoder(args.decoder_name, **args.decoder_setting)
    chunk = (heat[:BATCH_SIZE].contiguous(), *(t[:BATCH_SIZE].contiguous() for t in crops))
    ops = device_ops(lambda: dark(*chunk))
    kernels = sum("heatmap_decode_kernel" in name for name in ops)
    dark_ms = time_ms(lambda: dark(*chunk), queued=True, iters=PLAIN_ITERS)
    plain_ms = time_ms(lambda: plain(*chunk), queued=True)
    dark_back_ms = time_ms(lambda: dark(*chunk), queued=False, iters=PLAIN_ITERS)
    print(f"DARK decoder call on a [{BATCH_SIZE},17,64,48] eval heatmap under torch.profiler: "
          f"{len(ops)} device operations, {kernels} of them the decode kernel, the rest the "
          f"refinement and back-projection ({len(set(ops))} kinds)")
    if kernels != 1:
        raise AssertionError(f"the DARK decoder ran {kernels} decode kernels, not 1: {ops}")
    print(f"decoder per {BATCH_SIZE}-crop chunk of an eval heatmap, device time: DARK "
          f"{dark_ms:.5f} ms, without DARK (one kernel launch) {plain_ms:.5f} ms; DARK per call "
          f"back to back {dark_back_ms:.5f} ms")

    argmax_shift_decode.launches = 0
    preds_gpu, boxes_gpu = (t.cpu() for t in dark(heat, *crops))
    launches = argmax_shift_decode.launches
    preds_cpu, boxes_cpu = dark(heat.cpu(), *(t.cpu() for t in crops))
    xy_err = float((preds_gpu[..., :2] - preds_cpu[..., :2]).abs().max())
    scores_equal = bitwise_equal(preds_gpu[..., 2], preds_cpu[..., 2])
    print(f"DARK decoder on the card against its CPU run, {len(heat)} crops of a real eval "
          f"heatmap: keypoints max |diff| {xy_err:.3e} px (tolerance {EVAL_XY_ATOL}), scores "
          f"bitwise equal {scores_equal}; {launches} decode launch")
    if not (xy_err <= EVAL_XY_ATOL and scores_equal and launches == 1
            and torch.allclose(boxes_gpu, boxes_cpu, rtol=1e-6, atol=0)):
        raise AssertionError("the DARK decoder on the card disagrees with its CPU run")
    return {"launches": runs[False]["launches"], "dark_launches": runs[True]["launches"],
            "batches": runs[True]["batches"], "dark_ms": dark_ms, "dark_ops": len(ops),
            "plain_ms": plain_ms}


def post(url: str, payload: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError(f"POST {url}: HTTP {resp.status}")
        return json.loads(resp.read())


class HttpService:
    """``build_http_server`` on 127.0.0.1 at an ephemeral port, served from a
    thread; ``close`` shuts it down, closes the service and joins the thread."""

    def __init__(self, service) -> None:
        self.service = service
        self.httpd, port = build_http_server(service, host="127.0.0.1", port=0)
        self.url = f"http://127.0.0.1:{port}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, name="chip-smoke-http")
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise AssertionError("the HTTP server's thread did not end")


def serve_request(url: str, payload: dict, boxes: np.ndarray) -> np.ndarray:
    preds = np.asarray(post(url + "/predict", payload)["predictions"], np.float32)
    check_preds(preds, boxes)
    return preds


def time_requests(url: str, payloads: list, requests: list) -> list:
    """``REPEATS`` timed runs of each request over HTTP (host clock around the
    round trip, the client in this process); beside it the service's own
    ``latency_ms`` (the predictor's call, after the image is decoded).
    Returns the median round trips."""
    medians = []
    for payload, boxes in zip(payloads, requests):
        runs, served = [], []
        for _ in range(REPEATS):
            start = time.perf_counter()
            served.append(post(url + "/predict", payload)["latency_ms"])
            runs.append((time.perf_counter() - start) * 1e3)
        medians.append(statistics.median(runs))
        print(f"serving entry, {len(boxes)} boxes over HTTP, {REPEATS} runs: median "
              f"{medians[-1]:.3f} ms, min {min(runs):.3f}, max {max(runs):.3f}; "
              f"{len(boxes) * REPEATS / (sum(runs) / 1e3):.1f} crops/s; of it the predictor "
              f"(the service's latency_ms) median {statistics.median(served):.3f} ms")
    return medians


def serve_simple_baseline(root: str, trained: dict, device: torch.device) -> dict:
    """Phase 15: phase 13's checkpoint through the serving entry.

    ``tools/serve.build_service`` on resnet50_udp_tpu.yaml with ``--ckpt``,
    behind ``build_http_server`` on 127.0.0.1: ``GET /healthz``, then
    ``POST /predict`` with 1, 5 and 40 boxes over real HTTP (one decode
    launch per 32-crop chunk), each timed over ``REPEATS`` runs; the 5-box
    answer against the same service on the CPU (phase 5's tolerance, the
    keypoints within ``EVAL_XY_ATOL`` px: the card's UDP back-projection
    multiplies by the float reciprocal of 47 where the CPU divides). Then
    resnet101_tpu.yaml and resnet152_tpu.yaml through the same entry, with
    random weights from a numpy seed written as a port checkpoint, answering
    a 40-box request each. Every server is shut down and its thread joined;
    no thread of this phase is left.
    """
    threads_before = set(threading.enumerate())
    image, requests = make_requests(np.random.RandomState(SEED + 20))
    ok, png = cv2.imencode(".png", cv2.cvtColor(image, cv2.COLOR_RGB2BGR))  # lossless
    if not ok:
        raise RuntimeError("cv2 could not encode the request image")
    image_b64 = base64.b64encode(png.tobytes()).decode()
    payloads = [{"image_b64": image_b64, "boxes": b.tolist()} for b in requests]
    chunks = sum(-(-len(b) // BATCH_SIZE) for b in requests)

    args = serve_entry.parse_serve_args(["--config", UDP_YAML, "--ckpt", trained["ckpt"],
                                         "--batch-size", str(BATCH_SIZE)])
    start = time.perf_counter()
    service = serve_entry.build_service(args, batch_size=args.batch_size, device=device)
    print(f"serving entry: resnet50_udp_tpu.yaml with phase 13's checkpoint built in "
          f"{time.perf_counter() - start:.2f} s")
    http = HttpService(service)
    try:
        with urllib.request.urlopen(http.url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        print(f"serving entry GET /healthz: {health}")
        if health != {"status": "ok", "mode": "topdown", "num_joints": 17}:
            raise AssertionError(f"unexpected /healthz answer {health}")
        serve_request(http.url, payloads[-1], requests[-1])  # warm-up
        torch.cuda.synchronize()
        argmax_shift_decode.launches = 0
        answers = [serve_request(http.url, p, b) for p, b in zip(payloads, requests)]
        launches = argmax_shift_decode.launches
        print(f"serving entry: decode kernel launches {launches} for requests of "
              f"{[len(b) for b in requests]} boxes ({chunks} chunks)")
        if launches != chunks:
            raise AssertionError(f"{chunks} chunks made {launches} decode launches")
        medians = time_requests(http.url, payloads, requests)
    finally:
        http.close()

    cpu_service = serve_entry.build_service(args, batch_size=args.batch_size,
                                            device=torch.device("cpu"))
    cpu_answer = np.asarray(cpu_service.predict(payloads[1])["predictions"], np.float32)
    cpu_service.close()
    compare_with_cpu(service.predictor, cpu_service.predictor, image, requests[1],
                     xy_atol=EVAL_XY_ATOL, answers=(answers[1], cpu_answer))
    del service, cpu_service
    torch.cuda.empty_cache()

    deeper = {}
    for arch, yaml_path in SB_DEEPER.items():
        arch_args = serve_entry.parse_serve_args(["--config", yaml_path, "--batch-size",
                                                  str(BATCH_SIZE)])
        net = create_network_from_config(arch_args)
        random_weights_(net, device)
        arch_args.ckpt = os.path.join(root, f"{arch}_random.ckpt")
        save_checkpoint(arch_args.ckpt, net)
        del net
        service = serve_entry.build_service(arch_args, batch_size=arch_args.batch_size,
                                            device=device)
        http = HttpService(service)
        try:
            serve_request(http.url, payloads[-1], requests[-1])  # warm-up
            torch.cuda.synchronize()
            argmax_shift_decode.launches = 0
            serve_request(http.url, payloads[-1], requests[-1])
            arch_launches = argmax_shift_decode.launches
            print(f"serving entry, {os.path.basename(yaml_path)} (random weights, numpy seed "
                  f"{SEED}): decode kernel launches {arch_launches} for 40 boxes")
            if arch_launches != -(-40 // BATCH_SIZE):
                raise AssertionError(f"{arch}: 40 boxes made {arch_launches} decode launches")
            (median,) = time_requests(http.url, payloads[-1:], requests[-1:])
        finally:
            http.close()
        deeper[arch] = {"launches": arch_launches, "latency_ms": median}
        launches += arch_launches
        del service
        torch.cuda.empty_cache()

    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    print(f"serving entry: threads left running after shutdown: {left or 'none'}")
    if left:
        raise AssertionError(f"the serving phase left threads running: {left}")
    return {"launches": launches, "latency_ms": medians, "deeper": deeper}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    adopt_orphans()
    device = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    build_kernels()

    decode_err = check_decode_bitwise(device)
    decode = time_decode(device)

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

    cpu_predictor = TopDownPredictor(
        copy.deepcopy(net).cpu(), HRNET_W32["dataset_setting"], HRNET_W32["decoder_setting"],
        HRNET_W32["normalize_mean"], HRNET_W32["normalize_std"], batch_size=BATCH_SIZE,
        device=torch.device("cpu"))
    compare_with_cpu(predictor, cpu_predictor, image, requests[1])
    del predictor, cpu_predictor
    torch.cuda.empty_cache()

    check_conv_chain(device)
    probed = drive_probe(device)

    evaluated = evaluation(net, device)
    del net
    torch.cuda.empty_cache()

    phase9 = train_throughput(device)
    check_loss_falls(device)
    compare_train_with_cpu(device)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        entry = train_through_entry(root, phase9, device)
        stop_worker_servers()
        torch.cuda.empty_cache()
        trained = train_simple_baseline(root, entry["data"], device, UDP_YAML)
        torch.cuda.empty_cache()
        plain = train_simple_baseline(root, entry["data"], device, SB_YAML)
        torch.cuda.empty_cache()
        plain_eval = eval_checkpoint(root, plain, device, dark=False)
        sb_eval = eval_simple_baseline(root, trained, device)
        sb_served = serve_simple_baseline(root, trained, device)
    check_no_processes_left()

    # the conv chain's numbers at the train step's geometry (HRNet-W32 branch 0, batch 128)
    chain = next(r for r in probed["rows"] if r["b"] == HRNET_W32["batch_size"])
    warm_ms, plain_ms = decode[(BATCH_SIZE, False, True)]
    kernels = [{
        "name": "argmax_shift_decode",
        "route": "cuda",
        "source": "mindpose_tpu_torch/csrc/decode.cu",
        "replaces": "mindpose_tpu/ops/pallas/decode.py:27",
        # serving's launches, evaluation's (phases 8 and 14), the training
        # entry's callbacks' (phases 12 and 13: one per eval batch), the DARK
        # evaluation's (phase 14) and the serving entry's (phase 15)
        "launches": (served["launches"] + evaluated["launches"] + entry["launches"]
                     + trained["launches"] + plain["launches"] + plain_eval["launches"]
                     + sb_eval["launches"] + sb_eval["dark_launches"] + sb_served["launches"]),
        "eval_launches": evaluated["launches"] + plain_eval["launches"] + sb_eval["launches"],
        "train_eval_launches": entry["launches"] + trained["launches"] + plain["launches"],
        "dark_launches": sb_eval["dark_launches"],
        "serve_entry_launches": sb_served["launches"],
        "eval_batches": evaluated["batches"],
        "max_abs_err": decode_err,
        # [32,17,64,48] as served, shift off (hrnet_w32_tpu.yaml), warm in L2
        "ms": warm_ms,
        "plain_ms": plain_ms,
        "bound_ms": decode_bound_ms(BATCH_SIZE),
        "bound_by": "bytes",
        # torch.max(dim=1): each row's maximum and its first index, the
        # kernel's function at shift off
        "library_ms": decode[(BATCH_SIZE, "library")],
        "cold_ms": decode[(BATCH_SIZE, False, "cold")],
        "floor_ms": decode["floor"],
        "empty_kernel_ms": decode["empty"],
        # the serving decoder per chunk, device time: one launch of the
        # kernel against the plain composition
        "decoder_ms": decode[("decoder", True)][0],
        "decoder_plain_ms": decode[("decoder", True)][1],
        "decoder_device_ops": decode["decoder_ops"],
        # the kernel on an eval batch's heatmap [128,17,64,48], as evaluation calls it
        "eval_ms": evaluated["decode_ms"],
        "eval_bound_ms": evaluated["decode_bound_ms"],
        # the DARK decoder per 32-crop chunk of a ResNet-50 eval heatmap
        # (device time; the kernel's argmax, then plain PyTorch) and its
        # device operations per call
        "dark_decoder_ms": sb_eval["dark_ms"],
        "dark_decoder_device_ops": sb_eval["dark_ops"],
    }, {
        "name": "fused_conv_chain",
        "route": "cuda",
        "source": "mindpose_tpu_torch/csrc/conv_chain.cu",
        "replaces": "mindpose_tpu/ops/pallas/conv_chain.py:36",
        "launches": probed["launches"],
        "tensor_core_launches": probed["tensor_core_launches"],
        "max_abs_err": max(r["max_abs_diff"] for r in probed["rows"]),
        "max_rel_err": max(r["reldiff"] for r in probed["rows"]),
        "ms": chain["kernel_device_ms"],
        "plain_ms": chain["plain_device_ms"],
        "bound_ms": chain["bound_ms"],
        "bound_by": chain["bound_by"],
        # the plain version is the library's: cuDNN's conv per layer, then ReLU
        "library_ms": chain["plain_device_ms"],
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
    try:
        code = main()
    finally:
        stop_worker_servers()
    sys.exit(code)
