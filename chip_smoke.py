#!/usr/bin/env python3
"""Drive the PyTorch port's paths (top-down HRNet-W32, SimpleBaseline, ViTPose, SimCC, RLE and MPII, bottom-up HigherHRNet-W32 inference and training, the training input modes, data-parallel and sharded training, distillation, remat, int8 serving, the serving export, the demos, the visualisation tools, the native COCO library, the experiment, ablation and bench tools) once on one CUDA GPU.

Usage (from the root of a checkout, on a machine with an NVIDIA Hopper GPU
and the CUDA toolkit):

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and exits nonzero, printing
no result, when there is no CUDA device or when any phase fails:

1. the GPU's name and power limit (nvidia-smi);
2. build every kernel of the path from csrc/ (nvcc, sm_90a) and the native
   COCO library (``csrc/coco_native.cpp``, g++), all started together, with
   the g++ seconds;
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
   (``tools/ablate_pallas_chain.py``), at its three bf16 geometries: both
   device times, and the launch counts on that run, all on the tensor cores;
8. evaluation through the eval entry (``tools/eval.evaluate``): the
   serving net's weights saved as a port checkpoint and loaded back bit for
   bit, then evaluated with the recipe's settings (O2, batch 128, GT boxes,
   OKS-NMS) on synthetic COCO from ``mindpose_tpu_torch/tools/make_synthetic_coco.py`` (168
   frames, 672 crops), TTA off (a first pass and 2 warm ones, with the
   warm rates' spread) and on: records, batches, inferencer and evaluator
   times, crops/s, one decode launch per batch, the 10 COCO stats; the
   JAX-trained fixture checkpoint (tests/fixtures/) read by the port's
   msgpack reader, whose AP on the GPU is above 0 and within 0.005 of the
   CPU's at O0 and within 0.02 at O2, and its crops at O2 on the GPU against
   the CPU; the host loader alone and the forward and decode of one batch;
   and the first 32 crops on the GPU against the CPU at O0, TTA off and on;
9. the train step of hrnet_w32_tpu.yaml (adamw, warmup multi-step schedule,
   O2) on HRNet-W32 at full width, batch 128 of synthetic crops: 3 warm-up
   and 5 timed steps, img/s, step times, peak memory, finite losses;
10. the net learning one fixed batch with its joints painted in, over 30
    steps at constant lr: the loss falls below a fraction of its first value
    and of an all-zero prediction's, and the backbone moves;
11. one full-width train step at batch 2 on the GPU against the port on the
    CPU, in float64 (loss, gradients, BatchNorm running statistics to 1e-8)
    and in float32 (gradients against the CPU's float64);
12. training through the train entry (``tools/train.train``) on
    hrnet_w32_tpu.yaml as parsed from the file (full-width HRNet-W32, O2,
    batch 128, adamw, host targets, evaluating every ``val_interval`` epochs) on
    synthetic COCO from ``mindpose_tpu_torch/tools/make_synthetic_coco.py``; the overrides are
    the data paths, ``num_epochs``, ``warmup``, ``val_interval`` and
    ``ckpt_save_dir``. Per epoch the img/s with the loader feeding the
    step, the step's median and the wait on the loader, beside phase 9's
    img/s (the process pool's 8 workers start beside this run); then the
    train loader alone with 8 threads and with the process pool (crops/s).
    It holds: every loss finite, the last epoch's mean
    loss below the first's, the last evaluation's AP above 0, one decode
    launch per val batch per evaluation, the best and last checkpoints
    written, the last one's 10 COCO stats through the eval entry equal to
    the callback's within 1e-4, and a one-epoch resume from it starting at
    its step count (its batches through ``DevicePrefetcher``);
13. training configs/udp/resnet50_udp_tpu.yaml (ResNet-50 +
    simple_baseline_head at full width, O2, batch 128, adamw, host UDP
    targets), then configs/simple_baseline/resnet50_tpu.yaml, through the
    train entry on phase 12's data for 4 epochs of 10 steps each,
    evaluating once after the last, overridden as phase 12: img/s with the
    loader, the step's median, peak memory; each holds finite losses, the
    last epoch's below the first's, AP above 0 and one decode launch per
    val batch;
14. each run's last checkpoint through the eval entry (the callback's 10
    stats within 1e-4), the UDP one with ``dark_udp_refine`` off and on,
    one decode launch per eval batch in all; on one real eval heatmap the
    DARK decoder's device operations (torch.profiler) and device time per
    32-crop chunk, and the DARK decoder on the card against its CPU run
    (each keypoint within the larger of 1e-3 px and twice its float32
    rounding bound through the Newton step, at least 95% of them within
    1e-3 px; scores bitwise);
15. the same checkpoint through the serving entry (``tools/serve.py``:
    ``build_service`` behind ``build_http_server`` on 127.0.0.1 at an
    ephemeral port): ``GET /healthz``, ``POST /predict`` with 1, 5 and 40
    boxes over real HTTP, one decode launch per 32-crop chunk, latency over
    10 runs each; the 5-box answer against the same service on the CPU;
    then resnet101_tpu.yaml and resnet152_tpu.yaml with random weights from
    a numpy seed through the same entry, a 40-box request each; every
    server shut down and no thread of the phase left;
16. the tag-grouping kernel (``csrc/grouping.cu``, the fixed-capacity
    matcher) against its plain version (``ops/grouping.py``, numpy on the
    host), groups and valid bitwise equal, on 48 seeded candidate sets
    (K=17, M=30; L = 1 and 2; the rounded norm and ``ignore_too_much`` on
    and off; sets that overflow the capacity; tie-heavy sets with tags on a
    grid) and 6 wider ones (the 128- and 256-column bounds); then the step
    floor of its bound (one warp's least dependent chain per LSAP
    iteration), and per kind of set the LSAP iterations per image, the
    kernel's device time per batch of 1 and of 32, its bound (the larger of
    the bytes' time and the largest image's iterations times the floor) and
    its share of it; the plain version's and the host Hungarian's
    (``utils/match.py``) host time per image;
17. bottom-up evaluation through the eval entry: the JAX-trained bottom-up
    fixture (tests/fixtures/) at O0, its 10 stats within 1e-3 of the JAX
    package's with the grouping kernel and with the host Hungarian; then
    higher_hrnet_w32_tpu.yaml at full width (random weights from a numpy
    seed, O2, batch 1 as the yaml's non-square max_image_size gives it) on
    32 frames of ``mindpose_tpu_torch/tools/make_synthetic_coco.py``: images/s, one grouping
    launch per batch, and the split (loader alone, forward, decode,
    grouping, host post-processing, evaluator);
18. the same net through the serving entry in bottom-up mode over HTTP on
    127.0.0.1: a 640x480 PNG (served at 832x832), one grouping launch per
    request, latency over 10 requests beside the service's ``latency_ms``,
    the device operations of one request (torch.profiler); the fixture's
    service on the card against the CPU (the kernel against the plain
    matcher): the same persons, keypoints within 1e-3 px, scores within
    1e-4; no thread left;
19. bottom-up training: (a) the bottom-up fixture's reduced HigherHRNet
    (128x128, levels 32x32 and 64x64), one step of the yaml's loss,
    optimizer and schedule on a loader batch, on the card against the CPU
    (float64, the loss too: loss vector, gradients and BatchNorm
    statistics within 1e-8; float32 at O0 as phase 11 holds it); (b)
    higher_hrnet_w32_tpu.yaml as parsed through the train entry (full
    width, O2, batch 32, adam, host targets, 8 loader threads, random
    weights) on synthetic COCO, 2 epochs of 5 steps, evaluating after each on 16
    frames: per epoch img/s, the step median, the wait on the loader, the
    loss vector and the AP, the peak memory, the allocator's calls, and
    one warm step under torch.profiler (its device busy time against its
    wall time, the device targets' share, the top kernels); it holds finite
    losses, the last epoch's summed loss below the first's, one grouping
    launch per eval batch of the callback, every train forward in train
    mode and every evaluation's in eval mode, the last checkpoint equal to
    the trained net bit for bit, and that checkpoint through the eval entry
    giving the callback's last persons (within 1e-3) and stats (within
    1e-4); (c) the same run with ``device_pipeline: true``, after its
    device targets on one batch are held within 1e-6 of the host
    ``bottomup_generate_target``'s on the same warped keypoints;
20. configs/vitpose/vitpose_b_tpu.yaml as parsed (ViT-B/16 + the deconv
    head at full width, 256x192, O2, batch 128, adamw) through the train
    entry on phase 12's data, 2 epochs of 10 steps, evaluating after the
    last, from a ViT-B backbone file saved at 224x224 (random weights from a
    numpy seed; its 14x14 position grid resized on load): the tensors
    loaded, img/s with the loader, the step median, peak memory, the losses
    (finite, falling), one decode launch per val batch; the last checkpoint
    through the eval entry (the callback's keypoints within 1e-3 and stats
    within 1e-4, one decode launch per batch) and through the serving entry
    as in phase 15 (1, 5 and 40 boxes, one decode launch per 32-crop chunk,
    the card against the CPU at phase 5's tolerance, keypoints within 1e-3
    px: the card's back-projection rounds apart from the CPU's in the last
    bits);
21. vitpose_s_tpu.yaml and vitpose_l_tpu.yaml (layer decay 0.8) through
    the train entry, 2 epochs on 64 synthetic frames, evaluating after the
    last: img/s, the step median, peak memory, finite losses, one decode
    launch per val batch; each last checkpoint through the eval entry (the
    callback's stats) and the serving entry (a 40-box request, 2 decode
    launches); vitpose_h_tpu.yaml trains sharded in phase 27 (b);
22. configs/simcc/resnet50_simcc_tpu.yaml as parsed (ResNet-50 +
    ``simcc_head`` at full width, 256x192, O2, batch 128, adamw, host
    targets) through the train entry on phase 12's data, 2 epochs of 10
    steps, evaluating after the last with hflip TTA: img/s with the loader,
    the step median, the wait on the loader, peak memory, finite falling
    losses, AP, no decode launch (SimCC decodes with plain PyTorch); the
    last checkpoint through the eval entry (the callback's stats and
    keypoints); one batch of device targets against the host transform's
    (weights bit for bit, labels within 2e-6 of each), then 2 epochs with
    ``device_pipeline: true``; the serving entry over HTTP at 1, 5 and 40
    boxes, the 5-box request on the card against the CPU (head outputs
    within phase 5's tolerance; joints whose top two logits lead by more
    than twice it within 1e-3 px; scores within the bound the logits'
    carries through the softmax);
23. the same for configs/rle/resnet50_rle_tpu.yaml (``rle_head``, laplace
    NLL; the device targets bit for bit; served joints within 1e-3 px plus
    twice the mu bound times the crop's size, scores within sigma's bound),
    first one float64 step of the recipe at full width, batch 2, constant
    lr, on the card against the CPU (loss, gradients and BatchNorm running
    statistics within 1e-8); both runs at one loader worker with cuDNN's
    deterministic algorithms, each step's loss printed, the two runs' equal;
24. the decode kernel at MPII's heatmaps [32|128,16,64,64], shift on, both
    wrappers bitwise against their plain versions (random heatmaps and exact
    ties, the back-projection on), then timed warm and cold in L2 beside
    the whole decoder, the plain version, ``torch.max(x.view(N*K, H*W),
    dim=1)`` and the bound; configs/mpii/hrnet_w32_mpii_tpu.yaml as parsed
    (HRNet-W32 at 256x256, 16 joints, O2, batch 128, ``topdown_keypoint``)
    through the train entry on synthetic MPII frames (tests/fixtures/mpii.py,
    converted by the port's tools/convert_mpii.py), 2 epochs of 5 steps, evaluating
    after the last (PCKh and EPE, one decode launch per eval batch); the last
    checkpoint through the eval entry (the callback's PCKh and EPE, one launch
    per batch) and a 40-box request through the serving entry (16 joints, one
    launch per 32-crop chunk);
25. the training input modes of hrnet_w32_tpu.yaml: first the first batch
    of phase 12's train split (128 records, the recipe's augmentations from
    one seed at one worker) in ``device_pipeline: full`` (uint8 source
    patches bucketed to 64, warp matrices, keypoints; the flip deferred into
    the matrix), its crops and targets warped and rendered on the card
    against the host pipeline's (the cv2 crop within 8.47 on the 0-255
    scale: cv2 4.x rounds each sample coordinate to 1/32 px and the result
    to uint8; targets within 1e-5) and against the same preprocess on the CPU (crops
    within 0.05, targets within 1e-5); then the yaml as parsed (full width,
    O2, batch 128, adamw) through the train entry on phase 12's data, 3
    epochs of 10 steps each, evaluating after the last, with
    ``device_pipeline: true`` and with ``device_pipeline: full``
    (``image_bucket`` 64, the decode cache, frame-grouped shuffling,
    patch-grouped batching, ``profile: true``): per run img/s with the
    loader, the step median, the wait per step, the bytes handed to the step
    per batch, the decode cache's hit rate and peak memory; each holds
    finite, falling losses, AP above 0 and one decode launch per val batch;
    the full run's epoch-2 trace (torch.profiler) holds CUDA kernel events
    and epoch 2's steps only; and its last checkpoint's backbone, written as
    a published ``.pth``, goes through ``tools/convert_ckpt.py --check`` and
    ``load_pretrained_backbone`` into a net on the card bit for bit;
26. data-parallel training: (a) two ranks on the one card over gloo (nccl
    refuses two ranks on one card), fresh interpreters with a timeout,
    HRNet-W32 at full width in float32 (TF32 off, cuDNN's deterministic
    algorithms), 16 crops of a batch of 32 each, 3 steps at the yaml's lr,
    against one process at
    ``accum_steps=2`` on the 32: the ranks bitwise equal after every step,
    the parameters within 1e-5 (twice the summed lr where a gradient was
    below 1e-4 of its tensor's largest), the running statistics by the
    formula of tests/test_torch_ddp.py (the mean of two momentum updates
    against two in sequence); (b) the train entry under ``python3 -m
    torch.distributed.run --nproc_per_node=1`` (nccl, world size 1, DDP
    over the card; one process for 26 (b) and 27 (b), run beside the main
    process's phases from 17 on, whose times it shares the card and cores
    with) on
    hrnet_w32_tpu.yaml as parsed, phase 12's data, 3
    epochs of 10 steps, evaluating after the last: finite, falling losses,
    AP above 0, one decode launch per val batch, all-reduces issued in the
    profiled step; epochs 2-3's img/s beside phase 12's without DDP,
    and per step the all-reduces issued, the nccl kernels' device time and
    DDP's device-to-device copies (torch.profiler, epoch 1's last step);
27. FSDP on vitpose_h_tpu.yaml (ViT-H/16 + the deconv head, 632M
    parameters): (a) the net at full width, cut to 4 of its 32 encoder
    blocks, sharded over two ranks on the one card over gloo (fresh
    interpreters with a timeout, started beside 26 (a)'s), float64, 8 crops a rank, 2
    steps of the recipe's adamw with layer decay, against one process on
    the 16 (the head's BatchNorm takes the global batch's statistics under
    FSDP): each step's loss within 1e-12, the first step's reduced
    gradients (put together from the ranks' shards) within 1e-9 of each
    tensor's largest, and each rank's parameter and AdamW-moment bytes
    beside the whole ones; (b) the train
    entry under ``python3 -m torch.distributed.run --nproc_per_node=1``
    (nccl, world size 1, the net sharded over a mesh of one) on the yaml as
    parsed (batch 32 in 4 microbatches, O2) and phase 21's data, 1 epoch,
    rank 0's callback evaluating its unsharded copy: finite losses, one
    decode launch per val batch, the rank's bytes, the copy's and peak
    memory; then the
    last checkpoint, gathered from the shards, through the eval entry (the
    callback's stats) and the serving entry, which load it strictly. One
    torchrun process runs 26 (b)'s training and then 27 (b)'s, in one
    process group;
28. distillation: hrnet_w32_tpu.yaml as the student of an HRNet-W48
    teacher (torch's initialisation, BatchNorm statistics from one batch,
    written as a port checkpoint) through the
    train entry with ``distill_setting`` and ``joint_mse_distill``, one
    epoch of phase 12's data, evaluating after it: both loss components
    logged and positive, one decode launch per val batch, and the
    teacher's heatmaps appended to the last microbatch against a plain
    forward of the teacher within 1e-5 of their largest;
29. remat: the recipe's step (batch 128, O2) with and without ``remat`` from
    the same weights on the same batch: the first step's loss, gradients and
    running statistics within 1e-3 of each tensor's largest (cuDNN's
    deterministic algorithms), then each one's step time (CUDA events, 5
    steps) and peak ``torch.cuda.max_memory_allocated``;
30. int8 serving: hrnet_w32_tpu.yaml's net at full width (random weights
    from a numpy seed, written as a port checkpoint) through the serving
    entry with ``--quantize int8`` and without: the quantized bytes and
    each predictor's ``torch.cuda.memory_allocated``; requests of 1, 5 and
    40 boxes, one decode launch per 32-crop chunk, the keypoints equal to a
    float32 predictor's on the dequantized weights (bit for bit, or else
    every clear joint equal), one request over HTTP; the 5-box request on
    the card against int8 on the CPU (phase 5's check); the requests' times,
    int8 and float32 interleaved, a 40-box request's peak memory, and the
    dequantize's device time;
31. the serving export: the same net and the decoder traced with
    ``torch.export`` on the card (batch symbolic, traced at 2), saved,
    loaded from the bytes alone (``engine/export.py``), and called at
    batches 1, 5 and 32: one decode launch per call, the outputs against the
    direct forward and decode; the times of the trace, the save and the
    load, the artifact's size, its time per call against the direct path,
    the host's cost of the decode op's dispatch; then ``python3 -m
    mindpose_tpu_torch.tools.export --selftest`` on
    configs/simple_baseline/resnet50_tpu.yaml as parsed (O2, bf16 autocast)
    with phase 13's checkpoint, in a process of its own (ResNet-50 traces in
    a fraction of HRNet-W32's time);
32. the demo CLIs: ``tools/demo.py`` top-down (phase 12's last checkpoint,
    the whole frame as the box) and bottom-up (phase 17's checkpoint) on 4
    frames of phase 12's val split, then ``tools/demo_video.py`` on an 8-frame
    clip that cv2 writes from them: the files written, one decode launch
    per frame top-down, one grouping launch per image bottom-up;
33. the last host modules: (a) the visualisation tools on 2 samples each,
    on the card: ``tools/visual_gt_heatmap.py`` (hrnet_w32_tpu.yaml's train
    loader on phase 12's data), ``visual_pred_heatmap_topdown.py`` (phase
    12's last checkpoint; one decode launch per sample, keypoints on the
    heatmap) and ``visual_pred_heatmap_ae.py`` (phase 17's checkpoint; one
    grouping launch per sample); (b) phase 17's checkpoint through the eval
    entry on 8 frames of phase 12's val split with ``bottomup_resize`` as
    the val transform (512x704 inputs: sides multiples of 64, not square;
    batch 1), one grouping launch per frame, its 10 stats and AP; (c)
    hrnet_w32_tpu.yaml as parsed through the train entry with
    ``topdown_photometric_distortion`` after its first train transform, 3
    steps on 192 synthetic frames, evaluating after them: finite losses,
    the transform on every trained record, one decode launch per val batch;
    (d) phase 8's first pass's evaluator again on its results with the
    native COCO library on and off: the seconds of each, beside the card's
    name and power limit, the stats within 1e-9;
34. the 14 experiment and ablation tools' ``main`` (``tools/ablate_accuracy``,
    ``exp_grouping``, ``exp_warmstart``, ``ablate_step``, ``profile_parts``,
    ``ablate_bottomup``, ``ablate_bu_backbone``, ``ablate_bu_loss``,
    ``ablate_conv_chain``, ``ablate_conv_bwd``, ``ablate_conv_layout``,
    ``ablate_conv_shape``, ``ablate_s2d_head``, ``probe_layout``) at full
    width and their smallest counts (one timed call after the warm one; the
    bottom-up step and loss ablations at batch 8): JAX's report keys, at least one decode
    launch in ablate_accuracy and one grouping launch in exp_grouping's
    device arm, exp_warmstart's converted backbone bit for bit equal to the
    exported one, finite times and no NaN scalar in every ablation row;
35. the six bench tools (``tools/bench``, ``bench_serve``, ``bench_e2e``,
    ``bench_variant``, ``bench_bu_variant``, ``budget_table``) at full width:
    ``bench`` whole in a process of its own, its loops cut (its one-line
    report: value > 0, vs_baseline 1.0, the expected extra keys, no error
    key, decode launches), the five serving presets at 1, 8 and 32 boxes
    and hrnet_w32 with int8 weights (p50 <= p90 <= p99; decode launches for
    the heatmap presets only), bench_e2e's three modes and its bytes-only
    and loader-only runs (32 records), the variant tools at 1 timed step
    (batches 32 and 8; bench_variant's base, bn4 and bnfrozen,
    bench_bu_variant's base, bnfrozen and remat), and the budget table
    (every row within 105% of its eager program's bound and of its least
    bytes' roofline bound);
36. the JAX package's divergent training knobs on hrnet_w32_tpu.yaml's
    full-width net: (a) one step at batch 2 (constant lr) on the card against
    the port on the CPU in float64, as phase 11, with ``bn_grad_stats:
    frozen``, then with ``frozen_var``, ``bn_stats_frac`` 0.5 and the radial
    projection: the loss, every gradient and running statistic within
    ``TRAIN_F64_RTOL``, the update within ``close_update``'s bounds (2 lr
    an element, 1e-2 lr the mean), and each projected filter's update
    orthogonal to it (``RADIAL_COS_BOUND``); (b) the yaml through the train
    entry (batch 128, O2, the knobs of (a)'s second case,
    ``allow_divergent_knobs: true``), one epoch of phase 12's data
    evaluating after it: finite losses, every BatchNorm of the backbone in
    the mode, a ``RadialAdamW``, each step's projected filters orthogonal
    to their update, one decode launch per val batch; (c) the B128 O2 step's
    ms of base, frozen, frozen_var, bn4 and the radial AdamW, base first and
    last, beside the card's name and power limit.

Some phases run in processes of their own beside the main process's
phases, on the same card: 34 and 35 (b)-(e) in one beside phases 10-13
and 15 (which runs before 14); then, after phase 23 (which runs alone,
right after 24's decode kernel), one process at a time beside phases 17-22
and 24 (b)-33, 36, 26 (b) and 27 (b)'s torchrun process, 35 (a)
(``tools/bench.py``) and 25; 26 (a)'s and 27 (a)'s ranks start beside
phase 20. These processes run on all of the host's cores but two, which
the main process keeps. None runs beside phase 9 (the one full timing of
the train step) or a phase that times a kernel for the kernels line (3, 7,
8, 14, 16, and 24's decode kernel, which runs right after 16; its training
runs after 23). Each such process's output is printed once it has ended,
and after a group of phases over which one ran the script says so on a
line of its own: those phases' times were taken on a shared card and
host.

Every process the run starts ends before it does: the script adopts each
one whose parent ends first (a child subreaper), stops the process pool's
forkserver and resource tracker after phase 12, and fails if any process it
started is still there at the end. After each group of phases it
prints ``time: phases ... took N s``, and at the end the whole run's
seconds by its own clock.

The line before the last is the GPU's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import base64
import contextlib
import copy
import ctypes
import gc
import hashlib
import itertools
import json
import os
from concurrent.futures import ThreadPoolExecutor
import re
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
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.profiler import ProfilerActivity, profile, record_function

from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.data.loader import DataLoader, stop_worker_servers
from mindpose_tpu_torch.data.device_pipeline import (
    BOTTOMUP_DEVICE_FINAL_COLUMNS,
    DEVICE_FULL_FINAL_COLUMNS,
    build_bottomup_preprocess,
    build_topdown_full_preprocess,
    build_topdown_preprocess,
    strip_host_target_transform,
    swap_bottomup_target_transform,
    to_matrix_transforms,
)
from mindpose_tpu_torch.data.transform import box_to_center_scale
from mindpose_tpu_torch.data.transform.utils import transform_keypoints
from mindpose_tpu_torch.engine import (
    BottomUpPredictor,
    PoseService,
    TopDownPredictor,
    build_http_server,
    create_evaluator,
    create_inferencer,
    load_serving_fn,
)
from mindpose_tpu_torch.engine.export import ServingModule, save_program, trace_eval_net
from mindpose_tpu_torch.models import (
    Net,
    create_backbone,
    create_decoder,
    create_eval_network,
    create_head,
    create_loss,
    create_network,
    create_network_from_config,
    create_network_with_loss,
)
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.models.quantize import QTensor, dequantize_variables, quantized_bytes
from mindpose_tpu_torch.ops.cuda.build import load_host_library, load_library
from mindpose_tpu_torch.ops.image import affine_warp
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
from mindpose_tpu_torch.ops import grouping as plain_grouping
from mindpose_tpu_torch.ops.heatmap import gaussian_kernel_2d
from mindpose_tpu_torch.ops.cuda import decode as cuda_decode
from mindpose_tpu_torch.ops.cuda import grouping as cuda_grouping
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.register import entrypoint
from mindpose_tpu_torch.parallel import (
    accum_loss_and_grads,
    build_train_step,
    create_mesh,
    is_sharded,
    shard_net,
)
from mindpose_tpu_torch.scheduler import create_lr_scheduler
from mindpose_tpu_torch.tools import ablate_pallas_chain as probe
from mindpose_tpu_torch.tools import convert_ckpt
from mindpose_tpu_torch.tools import demo as demo_tool
from mindpose_tpu_torch.tools import demo_video as demo_video_tool
from mindpose_tpu_torch.tools import serve as serve_entry
from mindpose_tpu_torch.tools import eval as eval_entry
from mindpose_tpu_torch.tools import make_synthetic_coco
from mindpose_tpu_torch.tools import train as train_entry
from mindpose_tpu_torch.tools import visual_gt_heatmap as visual_gt_tool
from mindpose_tpu_torch.tools import visual_pred_heatmap_ae as visual_ae_tool
from mindpose_tpu_torch.tools import visual_pred_heatmap_topdown as visual_topdown_tool
from mindpose_tpu_torch.utils import native
from mindpose_tpu_torch.tools.eval import evaluate
from mindpose_tpu_torch.utils.match import match_by_tag
from mindpose_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_net_state_dict,
    load_pretrained_backbone,
    restore_train_state,
    save_checkpoint,
)
from mindpose_tpu_torch.config import parse_args
from tests.fixtures import mpii, tiny_coco
from tests.fixtures.ddp_ranks import free_port, run_processes
from tests.fixtures.eval_checks import (
    BOTTOMUP_CKPT,
    BOTTOMUP_RECORD,
    CKPT,
    RECORD,
    compare_callback_with_eval_entry,
    decode_margin,
    recording_entry,
    register_port_backbone,
)
from tests.fixtures.grouping_sets import ORDER, SETS, TIE_SETS, candidate_sets

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
REPEATS = 10  # timed runs of each request
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM, 3.35 TB/s (NVIDIA's data sheet)
MAX_SMEM_PER_BLOCK = 232448  # Hopper, 227 KB
KERNEL_SOURCES = ("decode", "conv_chain", "grouping")
# the decoder's back-projection settings held bitwise to the plain version
DECODE_MODES = (("to_original off", {"to_original": False, "use_udp": False}),
                ("to_original on", {"to_original": True, "use_udp": False}),
                ("to_original on, UDP", {"to_original": True, "use_udp": True}))
COLD_HEATMAPS = 16  # heatmaps the cold-L2 timing rotates over (> 50 MB at 32 crops)
PLAIN_ITERS = 20  # queued calls per timing of a plain composition (tens of kernels each)
PROBE_ITERS = 5  # chains per timing in the probe (each is 1-100 ms)
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 5
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
# Phase 8: synthetic COCO val frames (mindpose_tpu_torch/tools/make_synthetic_coco.py) with 4
# persons each, 672 crops: 5 full batches of 128 and a ragged one of 32,
# so that a pass lasts seconds and its rate can be compared across passes
EVAL_IMAGES = 168
EVAL_PEOPLE = 4
EVAL_WARM_REPEATS = 2  # warm passes of the recipe, TTA off: the rate's spread
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
# Phase 14, the DARK decoder on the card against the CPU. Its Newton step
# divides by the Hessian of the log of the blurred heatmap, and the card's
# blur sums its 121 products in another order than the CPU's: where that
# Hessian is near singular (a flat or clamped heatmap), the step turns
# rounding of the blurred heatmap into differences of tenths of a pixel (on
# an H100, one joint in 2,176 of a 60-step checkpoint 1.13e-3 px apart). So
# each joint is held within the larger of EVAL_XY_ATOL px and twice its
# float32 rounding bound (``dark_rounding_bound``), and at least DARK_AGREE
# of all joints within EVAL_XY_ATOL px (0.9995-1.0 of them there)
DARK_AGREE = 0.95
# Phase 12: synthetic COCO train frames (2 persons each: 1,280 records, 10
# steps of 128 per epoch) and val frames (128 crops, one eval batch); 3
# epochs of the recipe, warmup cut from 500 steps to 10 (the yaml's would
# leave the rate near 0 for the whole run), evaluation every 2 epochs and
# after the last
ENTRY_TRAIN_IMAGES = 640
ENTRY_VAL_IMAGES = 64
ENTRY_PEOPLE = 2
ENTRY_EPOCHS = 3
ENTRY_WARMUP = 10
ENTRY_VAL_INTERVAL = 2
ENTRY_RESUME_WARMUP = 5  # the one-epoch resume's schedule has 10 steps in all
ENTRY_RESUME_PREFETCH = 2  # batches the resume's DevicePrefetcher keeps in flight
ENTRY_STATS_ATOL = 1e-4  # the last checkpoint through the eval entry against the callback
RECIPE_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "hrnet",
                           "hrnet_w32_tpu.yaml")
# Phases 13-15: the SimpleBaseline recipes. Phase 13 trains the UDP recipe and
# the plain one on phase 12's data for 4 epochs of 10 steps each, evaluating
# once, after the last (at 30 steps the plain recipe's AP read 0 in one of two
# runs: ResNet-50 from scratch sits at AP ~1e-4 there)
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
UDP_YAML = os.path.join(CONFIGS, "udp", "resnet50_udp_tpu.yaml")
SB_YAML = os.path.join(CONFIGS, "simple_baseline", "resnet50_tpu.yaml")
SB_DEEPER = {arch: os.path.join(CONFIGS, "simple_baseline", f"{arch}_tpu.yaml")
             for arch in ("resnet101", "resnet152")}
SB_EPOCHS = 4
HIGHER_YAML = os.path.join(CONFIGS, "higher_hrnet", "higher_hrnet_w32_tpu.yaml")
GROUPING_SETS = 1  # images of each kind of SETS + TIE_SETS, per tag width and flags (48)
GROUPING_ITERS = 20  # queued launches per timing of the grouping kernel
GROUPING_FLOOR_STEPS = 200_000  # links of the step-floor probe's chain (~10 ms)
# (M, group_cap, candidate_sets kwargs): sets that take the grouping
# kernel's 128- and 256-column bounds (G + M + 1 = 97, 141, 255)
GROUPING_WIDE = ((48, 0, dict(persons=5, visible=0.3)),
                 (100, 40, dict(persons=12, visible=0.5)),
                 (127, 0, dict(persons=20, visible=0.5)))
BU_EVAL_IMAGES = 32
BU_EVAL_PEOPLE = 3
BU_SPLIT_BATCHES = 8  # eval batches whose forward, decode and grouping are timed apart
BU_STATS_ATOL = 1e-3  # the bottom-up fixture's stats against the JAX package's, O0
BU_SCORE_ATOL = 1e-4  # a served person's score, on the card against the CPU
# Phase 19, bottom-up training. (a) The bottom-up fixture's reduced net
# (tests/fixtures: 128x128, levels 32x32 and 64x64) one step on the card
# against the CPU, on a batch of BU_CPU_BATCH tiny_coco frames. Float64,
# its loss too, is held to TRAIN_F64_RTOL; float32 (TF32 off): the loss vector to
# TRAIN_LOSS_RTOL of its largest entry (the push loss subtracts the
# instance count from a sum of ones, so its own relative error is that
# much larger), the running statistics to TRAIN_STATS_RTOL, and each
# gradient against the CPU's float64 at most TRAIN_GRAD_FACTOR times as far
# as the CPU's float32, or within BU_GRAD_FLOOR of its largest entry (the
# reduced net's float32 gradients sit ~5e-6 from float64 where no ReLU
# input crosses 0, so a factor of small errors alone would flap).
# (b) higher_hrnet_w32_tpu.yaml through the train entry on synthetic COCO:
# BU_TRAIN_IMAGES frames of BU_TRAIN_PEOPLE persons (5 steps of 32 per
# epoch), BU_TRAIN_EPOCHS epochs, the warmup cut from 500 steps to
# BU_TRAIN_WARMUP, evaluating every BU_TRAIN_VAL_INTERVAL epochs and after
# the last on BU_TRAIN_VAL_IMAGES frames (batch 1: the yaml's non-square
# max_image_size); (c) the same with ``device_pipeline: true``, its device
# targets held within BU_TARGET_ATOL of the host's (float32 exp on the card
# against numpy's)
BU_CPU_BATCH = 4
BU_GRAD_FLOOR = 1e-4
BU_TRAIN_IMAGES = 160
BU_TRAIN_PEOPLE = 3
BU_TRAIN_VAL_IMAGES = 16
BU_TRAIN_EPOCHS = 2
BU_TRAIN_WARMUP = 5
BU_TRAIN_VAL_INTERVAL = 1  # an evaluation after each epoch: two in all
BU_TARGET_ATOL = 1e-6
# the callback's last persons against the eval entry's on its last
# checkpoint: keypoints (x, y, score, tags) and scores
BU_ENTRY_PERSON_ATOL = 1e-3
# the entry's step calls timed apart in each run: call 1 between two
# synchronizations, calls 2 and 3 under torch.profiler (call 3 measured); in
# epoch 1, which the reported medians leave out
BU_PROFILED_CALL = 3


# Phases 20-21: the ViTPose recipes. Phase 20 trains vitpose_b_tpu.yaml as
# parsed on phase 12's data from a ViT-B backbone saved at 224x224 (a 14x14
# position grid, resized onto the recipe's 16x12 as it loads), 2 epochs of
# 10 steps, evaluating after the last; phase 21 trains vitpose_s_tpu.yaml and
# vitpose_l_tpu.yaml (and phase 27 vitpose_h_tpu.yaml) 2 epochs on 64 frames of
# their own.
VITPOSE_YAML = {arch: os.path.join(CONFIGS, "vitpose", f"vitpose_{arch}_tpu.yaml")
                for arch in ("s", "b", "l", "h")}
VIT_EPOCHS = 2
VIT_PRETRAINED_SIZE = (224, 224)
# flax leaves per block: 2 LayerNorms (4), query/key/value (6), out (2), 2 Dense (4)
VIT_LEAVES_PER_BLOCK = 16
VIT_SMALL_IMAGES = 64  # phase 21: 128 records, per epoch 1 step of ViT-S, 2 of ViT-L, 4 of ViT-H
VIT_SMALL_VAL_IMAGES = 16
VIT_SMALL_EPOCHS = 2
VIT_SMALL_WARMUP = 2
# Phases 22-24: the SimCC, RLE and MPII recipes, as parsed. Phases 22 and 23
# train resnet50_simcc_tpu.yaml and resnet50_rle_tpu.yaml on phase 12's data,
# FAMILY_EPOCHS epochs of 10 steps, evaluating after the last (hflip TTA on,
# as the yamls set it), then FAMILY_DEVICE_EPOCHS with ``device_pipeline:
# true`` and no evaluation; phase 24 trains hrnet_w32_mpii_tpu.yaml on
# synthetic MPII frames (tests/fixtures/mpii.py; 640 records, 5 steps of
# 128 per epoch; 192 val crops, 2 eval batches)
SIMCC_YAML = os.path.join(CONFIGS, "simcc", "resnet50_simcc_tpu.yaml")
RLE_YAML = os.path.join(CONFIGS, "rle", "resnet50_rle_tpu.yaml")
MPII_YAML = os.path.join(CONFIGS, "mpii", "hrnet_w32_mpii_tpu.yaml")
FAMILY_EPOCHS = 2
FAMILY_DEVICE_EPOCHS = 2
# phase 23's loader workers: one, so that both runs train on the same
# batches on every call (the recipe's 8 threads draw the augmentations in the
# order they reach numpy's stream: a run on unchanged code read epoch losses
# 2.500 then 3.034 against 0.83-1.05 in others)
RLE_WORKERS = 1
# the SimCC device labels against the host transform's on the same warped
# keypoints: float32 exp on the card against numpy's and each row's sum in
# another order, a few ulps of each label (the regression targets divide
# alike on both: bit for bit)
SIMCC_TARGET_RTOL = 2e-6
MPII_TRAIN_IMAGES = 320
MPII_VAL_IMAGES = 96
MPII_PEOPLE = 2
MPII_EPOCHS = 2
MPII_HEATMAP = (16, 64, 64)  # K, H, W of the yaml's 64x64x16 heatmaps
# phase 25: hrnet_w32_tpu.yaml through the train entry on phase 12's data in
# two input modes beside phase 12's host targets (device_pipeline true and
# full), 3 epochs
# of 10 steps each, evaluating after the last; full mode with its loader
# options and epoch 2 traced by torch.profiler
INPUT_EPOCHS = 3
INPUT_WARMUP = 5
FULL_BUCKET = 64
FULL_CACHE_MB = 4096  # phase 12's 640 frames of 360x480 RGB: 332 MB
FULL_CROP_ATOL = 0.05  # the warp on the card against the CPU's, 0-255 scale
# the warp against cv2's crop, 0-255 scale: cv2 4.x rounds each sample
# coordinate to 1/32 px (INTER_BITS 5), up to 1/64 px off on each axis, which a
# step of 255 between neighbouring pixels turns into 255/64 per axis; then it
# rounds to uint8 (0.5). cv2 5.0 samples at the float coordinate: 0.505 on
# a batch of the same kind
FULL_HOST_ATOL = 2 * 255 / 64 + 0.5
FULL_TARGET_ATOL = 1e-5
# phase 25's input modes beside phase 12's host targets, as the train entry's
# options; both at the yaml's loader workers
INPUT_MODES = {
    "device": ("device_pipeline=True",),
    "full": ("device_pipeline=full", f"image_bucket={FULL_BUCKET}",
             f"decode_cache_mb={FULL_CACHE_MB}", "frame_grouped_shuffle=True",
             "patch_grouped_batching=True", "profile=True"),
}
# phase 26: data-parallel training. (a) two ranks on this one card over gloo
# (nccl refuses two ranks on one card), each given 16 crops of a batch of 32,
# against one process at accum_steps=2 on the 32; (b) the train entry under
# torchrun, one rank, nccl, on phase 12's data as phase 25 trains it
DDP_WORLD = 2
DDP_RANK_BATCH = 16
DDP_STEPS = 3
DDP_TIMEOUT_S = 600  # each of the phase's process groups
DDP_STATS_RTOL = 1e-4  # the running statistics against the formula, of each tensor's largest
# (b): epoch 1's last step is the profiled one, epochs 2-3 the rate's (at 2
# epochs the evaluation after step 20 read AP 0)
DDP_EPOCHS = 3
DDP_PROFILED_STEPS = 1  # host and device activity: ~12 s for a step of HRNet-W32 at 128
# phase 27: FSDP on vitpose_h_tpu.yaml (ViT-H/16 + the deconv head, 632M
# parameters). (a) at full width, FSDP_DEPTH blocks deep, two ranks on this
# one card over gloo, each given
# FSDP_RANK_BATCH crops of a batch, against one process on the whole batch;
# (b) the train entry under torchrun, one rank, nccl, on phase 21's data
FSDP_WORLD = 2
FSDP_DEPTH = 4  # (a): encoder blocks of ViT-H's 32, at full width
FSDP_RANK_BATCH = 8
FSDP_STEPS = 2
FSDP_EPOCHS = 1
FSDP_OPTIONS = (f"num_epochs={FSDP_EPOCHS}", f"warmup={VIT_SMALL_WARMUP}",
                f"val_interval={FSDP_EPOCHS}", "save_best=False")
FSDP_TIMEOUT_S = 600
# phase 27 (a) runs in float64: in float32, cuDNN's weight gradient of the
# head's transposed conv summed over 8 + 8 crops lay up to 6.25e-4 of its
# largest entry from the same gradient over the 16 crops in one process
# (measured), a cancellation that float64 takes down by eps's ratio, ~1e-9
FSDP_LOSS_RTOL = 1e-12  # each step's loss of the ranks against the one process's
FSDP_GRAD_RTOL = 1e-9  # the first step's reduced gradients, of each tensor's largest
# phase 28: hrnet_w32_tpu.yaml as student of an HRNet-W48 teacher, one epoch on
# phase 12's data, evaluating after it
DISTILL_TEACHER = "hrnet_w48"
DISTILL_ALPHA = 0.5
DISTILL_HEAT_RTOL = 1e-5  # the appended heatmaps against a plain forward, of the largest
# phase 29: the recipe's step (batch 128, O2) with and without remat
REMAT_TIMED_STEPS = 3
REMAT_RTOL = 1e-3  # loss, gradients, running statistics: of each tensor's largest
# phase 36: the JAX package's divergent training knobs on hrnet_w32_tpu.yaml's net
DIVERGENT_BACKBONE = {"bn_grad_stats": "frozen_var", "bn_stats_frac": 0.5}
# (a): each case's backbone settings and whether the optimizer projects
DIVERGENT_CASES = {"frozen": ({"bn_grad_stats": "frozen"}, False),
                   "frozen_var + 0.5 + radial": (DIVERGENT_BACKBONE, True)}
# (c): the B128 O2 step of each arm; base is timed first and last
DIVERGENT_VARIANTS = {"base": ({}, False), "frozen": ({"bn_grad_stats": "frozen"}, False),
                      "frozen_var": ({"bn_grad_stats": "frozen_var"}, False),
                      "bn4": ({"bn_stats_frac": 0.25}, False), "radial": ({}, True)}
# one warm-up step an arm: phase 36 (b) has run the same step's shapes in
# the same process (its kernels' plans are made); the median of 3
DIVERGENT_WARMUP_STEPS = 1
DIVERGENT_TIMED_STEPS = 3
# (a), (b): the largest |<u, w>| / (|u| |w|) over the output channels of a
# projected filter, u the update's Adam part, against a float32 update read
# back from the weights (~1e-5 of rounding); an unprojected update of a
# 3x3 x C filter sits near 1 / sqrt(9 C), 0.02 at C = 256
RADIAL_COS_BOUND = 1e-3
# phases 34-35, 36 and 25 run in processes of their own beside the main
# process's phases (``run_phases``); each such process's time limit
PHASES_TIMEOUT_S = 900
# host cores that the processes beside the main process's phases leave to it
# (``Background``): its step issue and loader threads would otherwise wait
# behind theirs
MAIN_CORES = 2
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


class Background:
    """Work that runs beside the main process's phases on the same card: each
    job, a function on a pool thread that starts a process of its own
    (``run_processes``), has a label and the span it ran over; ``serial``
    jobs run one after another on a pool of one thread, in the order they
    were submitted. A job's thread, and so every process it starts, runs on
    the host's cores but the first ``MAIN_CORES``. ``sharers`` names the jobs
    that ran during a span of the main process, whose timings then shared
    the card (and the host's other cores) with them."""

    def __init__(self, pool: ThreadPoolExecutor, serial: ThreadPoolExecutor) -> None:
        self.pool, self.serial = pool, serial
        self.spans = {}

    def submit(self, label: str, fn, *args, serial: bool = False):
        span = self.spans[label] = [None, None]

        def run():
            cores = sorted(os.sched_getaffinity(0))
            if len(cores) > 2 * MAIN_CORES:
                os.sched_setaffinity(0, cores[MAIN_CORES:])  # this thread's, inherited
            span[0] = time.perf_counter()
            try:
                return fn(*args)
            finally:
                span[1] = time.perf_counter()

        return (self.serial if serial else self.pool).submit(run)

    def sharers(self, start: float, end: float) -> list:
        return [label for label, (s, e) in self.spans.items()
                if s is not None and s < end and (e is None or e > start)]


def run_phases(phases: str, root: str, job: dict) -> dict:
    """Phases ``phases`` in a process of their own (``chip_smoke.py --phases``,
    ``phases_process``) on the same card, with ``job`` (JSON) and ``root``;
    returns their log and what they wrote. Raises with the log's tail if the
    process fails or outlives ``PHASES_TIMEOUT_S``."""
    out_dir = os.path.join(root, f"phases_{phases}")
    os.makedirs(out_dir, exist_ok=True)
    job_path = os.path.join(out_dir, "job.json")
    result_path = os.path.join(out_dir, "result.json")
    with open(job_path, "w") as f:
        json.dump(dict(job, root=root, out=result_path), f)
    start = time.perf_counter()
    (log,) = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--phases", phases, job_path]],
        [os.path.join(out_dir, "log")], PHASES_TIMEOUT_S, f"phases {phases}",
        env=dict(os.environ, PYTHONUNBUFFERED="1"))
    with open(result_path) as f:
        return {"log": log, "result": json.load(f), "seconds": time.perf_counter() - start}


def joined(label: str, done: dict) -> dict:
    """Print the log of a ``run_phases`` job once it is joined; returns its result."""
    print(f"--- {label}, in a process of their own ({done['seconds']:.1f} s from its start to "
          f"its end), sharing the card with the main process's phases:")
    print(done["log"].rstrip())
    print(f"--- end of {label}")
    return done["result"]


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


def trace_events(prof) -> list:
    """(name, on the device, start us, end us) of each event of a finished
    torch.profiler trace of a train step, read from its raw events: the
    events that ``prof.events()`` gives, without building their Python tree
    (seconds for a train step's 100,000 events; 10.7 s for 168,640 CPU
    events on an 8-core host, against 0.23 s for the raw ones)."""
    from torch.autograd.profiler_util import _filter_name

    cuda = torch.autograd.DeviceType.CUDA
    # the events the parser of prof.events() leaves out, left out alike
    return [(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if not (_filter_name(e.name()) or e.is_hidden_event())]


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
    """Phase 2: one nvcc per source and g++ for the native COCO library, all
    started together; print each ptxas report and the g++ seconds."""
    with ThreadPoolExecutor(len(KERNEL_SOURCES) + 1) as pool:
        host = pool.submit(load_host_library, native.SOURCE)
        for built in pool.map(load_library, KERNEL_SOURCES):
            print(f"built {built.path.name} in {built.build_seconds:.2f} s")
            print(built.log.strip())
        built = host.result()
        print(f"built {built.path.name} (g++, host) in {built.build_seconds:.2f} s")


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


def check_preds(preds: np.ndarray, boxes: np.ndarray, num_joints: int = 17,
                dataset_setting: dict = HRNET_W32["dataset_setting"],
                in_window: bool = True) -> None:
    """[M, K, 3], finite, and (``in_window``) each keypoint inside its box's
    padded crop window, up to the back-projection's float32 rounding. A
    regression head's coordinates are not bounded by the crop: for it, the
    scores lie in [0, 1]."""
    m = len(boxes)
    if preds.shape != (m, num_joints, 3):
        raise AssertionError(f"preds shape {preds.shape}, want {(m, num_joints, 3)}")
    if not np.isfinite(preds).all():
        raise AssertionError("non-finite keypoints")
    if not in_window:
        if not ((preds[..., 2] >= 0).all() and (preds[..., 2] <= 1).all()):
            raise AssertionError("regression scores outside [0, 1]")
        return
    ds = dataset_setting
    cs = [box_to_center_scale(b, ds["image_size"], ds["pixel_std"], ds["scale_padding"])
          for b in boxes]
    centers = np.stack([c for c, _ in cs])
    half = np.stack([s for _, s in cs]) * ds["pixel_std"] / 2
    # the back-projection takes 4 float32 operations, each rounded: a joint
    # on the heatmap's border lands on the window's edge up to a few ulps
    # out (tests/test_torch_decode.py)
    atol = 4 * np.spacing(np.maximum(abs(centers - half), abs(centers + half)).astype(np.float32))
    lo, hi = centers - half - atol, centers + half + atol
    xy = preds[..., :2]
    if not ((xy >= lo[:, None]).all() and (xy <= hi[:, None]).all()):
        excess = float(np.maximum(lo[:, None] - xy, xy - hi[:, None]).max())
        raise AssertionError(f"keypoints outside their crop windows: {excess:.3e} px beyond "
                             f"the window and its rounding")


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
    xy_err = np.abs(preds_gpu[..., :2] - preds_cpu[..., :2]).max(-1)
    same = xy_err <= xy_atol
    print(f"card-vs-CPU keypoints: {int(qualified.sum())} of {qualified.size} joints have a "
          f"top-2 gap > {2 * tol:.3e}; {int(same[qualified].sum())} of them agree "
          + (f"within {xy_atol} px" if xy_atol else "exactly")
          + f" (max |diff| among them {float(xy_err[qualified].max()):.3e} px)")
    if not qualified.any() or not same[qualified].all():
        raise AssertionError("keypoints differ where the heatmap peak is clear")
    score_err = float(np.abs(preds_gpu[..., 2] - preds_cpu[..., 2]).max())
    if score_err > tol:
        raise AssertionError(f"scores differ by {score_err}")


def write_synthetic_coco(root: str, train_images: int = 0, val_images: int = EVAL_IMAGES,
                         people: int = EVAL_PEOPLE) -> dict:
    """The splits of the port's ``mindpose_tpu_torch/tools/make_synthetic_coco.py`` under ``root``
    (person layout), written in this process:
    {"train": (image root, annotation file), "val": (...)}."""
    for split, images, seed in (("train", train_images, 0), ("val", val_images, 1)):
        make_synthetic_coco.generate_split(os.path.join(root, split), images, seed=seed,
                                           people_per_img=people, layout="person")
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
        kept = {}
        make_evaluator = eval_entry.create_evaluator

        def keeping_evaluator(*a, **kw):  # the first pass's results, for phase 33 (d)
            evaluator = make_evaluator(*a, **kw)

            def call(outputs):
                kept.setdefault("outputs", copy.deepcopy(outputs))
                return evaluator(outputs)

            return call

        eval_entry.create_evaluator = keeping_evaluator
        try:
            runs = [run_eval(args, device, "recipe O2, TTA off, first pass")]
        finally:
            eval_entry.create_evaluator = make_evaluator
        with open(val_label) as f:
            kept.update(annotations=json.load(f), args=args, eval_s=runs[0]["eval_s"])
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
            "batches": sum(r["batches"] for r in runs), "evaluator_inputs": kept, **times}


def hrnet_w32_net(**backbone_args) -> nn.Module:
    """Full-width HRNet-W32 + hrnet_head, torch's own initialisation;
    ``backbone_args`` over the yaml's ``backbone_setting`` (phase 36's
    BatchNorm modes)."""
    return create_network(HRNET_W32["backbone_name"], HRNET_W32["head_name"],
                          num_joints=HRNET_W32["num_joints"],
                          backbone_args={**HRNET_W32["backbone_setting"], **backbone_args},
                          head_args=HRNET_W32["head_setting"])


def training_net(device: torch.device, **backbone_args) -> nn.Module:
    """``hrnet_w32_net(**backbone_args)`` with ``random_weights_``."""
    net = hrnet_w32_net(**backbone_args)
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


def recipe_optimizer(net: nn.Module, **optimizer_setting) -> torch.optim.Optimizer:
    """hrnet_w32_tpu.yaml's adamw with its decay and grouping over ``net``;
    ``optimizer_setting`` over the yaml's (phase 36's radial projection)."""
    cfg = HRNET_W32
    return create_optimizer(net, cfg["optimizer"], learning_rate=cfg["lr"],
                            weight_decay=cfg["weight_decay"],
                            filter_bias_and_bn=cfg["filter_bias_and_bn"],
                            **{**cfg["optimizer_setting"], **optimizer_setting})


def recipe_step(net: nn.Module, amp_level: str, schedule=None, accum_steps: int = 1,
                **optimizer_setting):
    """hrnet_w32_tpu.yaml's train step over ``net``: the device preprocess,
    joint_mse with target weights, adamw with its decay and grouping.
    Without a schedule the rate is the yaml's ``lr``, constant. Within a
    process group the step is data-parallel (``build_train_step``)."""
    return build_train_step(recipe_net_with_loss(net), recipe_optimizer(net, **optimizer_setting),
                            schedule, preprocess=recipe_preprocess(), amp_level=amp_level,
                            accum_steps=accum_steps)


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


def train_loaders(args: Config) -> tuple:
    """Phase 12: the recipe's train loader (train transforms, batch 128, the
    yaml's workers) with threads and with the process pool, and the thread
    that starts the pool's workers (each importing this script) beside the
    entry's run: it takes the pool's first batch and drops it (the workers,
    not this process, draw its augmentations). ``time_train_loader`` times
    both loaders after the run."""
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

    def start_pool() -> None:
        batches = iter(processes)
        next(batches)
        batches.close()

    starter = threading.Thread(target=start_pool, name="pool-start")
    starter.start()
    return threads, processes, starter


def time_train_loader(args: Config, threads: DataLoader, processes: DataLoader,
                      starter: threading.Thread) -> dict:
    """Phase 12: ``train_loaders``' loaders alone over 2 epochs each (the
    process pool started beside the entry's run by ``starter``: its first
    epoch no longer includes the start). Returns crops/s of each second
    epoch; closes the pool."""
    out = {}
    starter.join()
    try:
        for name, loader in (("threads", threads), ("processes", processes)):
            rates = []
            for _ in range(2):
                start = time.perf_counter()
                crops = sum(len(b["target_weight"]) for b in loader)
                rates.append(crops / (time.perf_counter() - start))
            print(f"train loader alone, {args.num_parallel_workers} {name}: {crops} crops per "
                  f"epoch ({len(loader)} batches of {args.batch_size}), {rates[0]:.1f} crops/s "
                  f"in the first epoch, {rates[1]:.1f} in the second"
                  + (" (the pool started beside the entry's run)" if loader is processes else ""))
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
    loaders = train_loaders(args)

    torch.cuda.synchronize()
    start = time.perf_counter()
    argmax_shift_decode.launches = 0
    result = train_entry.train(args)
    launches = argmax_shift_decode.launches
    train_s = time.perf_counter() - start
    loader_rates = time_train_loader(args, *loaders)
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
    epochs 2 on (the first includes cuDNN's autotuning), or of a run's only
    epoch."""
    for e in epochs:
        # COCO's AP, or every metric of another evaluator (MPII's PCKh and EPE)
        shown = {k: v for k, v in e["metrics"].items() if k == "AP"} or e["metrics"]
        ap = "".join(f", {k} {float(v):.6f}" for k, v in shown.items())
        print(f"{label} epoch {e['epoch']}: loss {e['loss']:.6g}, lr {e['lr']:.6g}; "
              f"{e['images_per_sec']:.1f} img/s with the loader feeding the step; step median "
              f"{e['step_median_s'] * 1e3:.1f} ms; wait on next(batches) median "
              f"{e['wait_median_s'] * 1e3:.1f} ms, {e['wait_total_s']:.2f} s in all over "
              f"{e['steps']} steps{ap}")
    warm = epochs[1:] or epochs
    return sum(e["images"] for e in warm) / sum(e["images"] / e["images_per_sec"] for e in warm)


def entry_argv(recipe: str, data: dict, ckpt_dir: str, *options: str) -> list:
    """The train entry's command line for ``recipe`` with the data paths and
    ``ckpt_save_dir`` of this run and ``options``."""
    (train_root, train_label), (val_root, val_label) = data["train"], data["val"]
    return ["--config", recipe, "--cfg-options", f"train_root={train_root}",
            f"train_label={train_label}", f"val_root={val_root}", f"val_label={val_label}",
            f"ckpt_save_dir={ckpt_dir}", *options]


def recipe_args(recipe: str, data: dict, ckpt_dir: str, device: torch.device,
                *options: str) -> Config:
    """A recipe as the train entry parses it on ``device`` (``entry_argv``)."""
    return train_entry.parse_train_args([*entry_argv(recipe, data, ckpt_dir, *options),
                                         "--device", str(device)])


@contextlib.contextmanager
def step_losses():
    """Within the block, the train entry's callback also keeps each step's
    summed loss in the list it yields (device scalars: read them after the
    run, as the callback does, so that no step waits for its loss)."""
    losses = []
    on_step_end = train_entry.EvalCallback.on_step_end

    def recorded(callback, loss_vector):
        losses.append(loss_vector.detach().sum())
        on_step_end(callback, loss_vector)

    train_entry.EvalCallback.on_step_end = recorded
    try:
        yield losses
    finally:
        train_entry.EvalCallback.on_step_end = on_step_end


def train_recipe(args: Config, label: str) -> dict:
    """Phases 22-24: ``args`` through the train entry on the card, recording
    what its callback evaluated (``recording_entry``). Prints each epoch (img/s
    with the loader feeding the step, the step median, the wait on the
    loader), then epochs 2 on, the peak memory, the losses and each step's
    loss; holds finite losses, the last epoch's below the first's. Returns
    the run's numbers, the decode kernel's launches in it and the record. An
    earlier phase's net and optimizer may still be allocated, held in
    reference cycles: they are collected first, so that the peak is this
    run's own."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    argmax_shift_decode.launches = 0
    with recording_entry(train_entry) as seen, step_losses() as per_step:
        result = train_entry.train(args)
    launches = argmax_shift_decode.launches
    train_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    epochs = result["epochs"]
    rate = entry_epochs(label, epochs)
    warm = epochs[1:]
    wait = sum(e["wait_total_s"] for e in warm) / sum(e["steps"] for e in warm)
    step_median_ms = statistics.median(e["step_median_s"] for e in warm) * 1e3
    losses = [e["loss"] for e in epochs]
    per_step = torch.stack(per_step).tolist()
    print(f"{label} ({args.backbone_name} + {args.head_name}, {args.amp_level}, batch "
          f"{args.batch_size}, device_pipeline {getattr(args, 'device_pipeline', False)}): "
          f"epochs 2-{len(epochs)} {rate:.1f} img/s with the loader feeding the step, median of "
          f"the epochs' step medians {step_median_ms:.1f} ms, wait on the loader "
          f"{wait * 1e3:.1f} ms per step; {result['step']} steps in {train_s:.1f} s with the "
          f"evaluation; peak torch.cuda.max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
          f"losses {losses}; decode kernel launches {launches}")
    print(f"{label}: each step's loss " + ", ".join(f"{v:.9g}" for v in per_step))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}'s losses are not finite or did not fall: {losses}")
    evals = [e for e in epochs if e["metrics"]]
    return {"result": result, "seen": seen, "launches": launches, "images_per_sec": rate,
            "wait_per_step_ms": wait * 1e3, "step_median_ms": step_median_ms,
            "peak_bytes": peak, "losses": losses, "step_losses": per_step,
            "evaluations": len(evals),
            "stats": {k: float(v) for k, v in evals[-1]["metrics"].items()} if evals else {}}


def eval_recipe_checkpoint(root: str, args: Config, trained: dict, ckpt: str,
                           device: torch.device, label: str) -> dict:
    """Phases 22-24: the run's last checkpoint through the eval entry: the
    callback's stats within ``ENTRY_STATS_ATOL``, its last keypoints within
    ``BU_ENTRY_PERSON_ATOL``, the checkpoint the trained net bit for bit, each
    evaluation in eval mode. Returns the stats and the decode kernel's
    launches."""
    argmax_shift_decode.launches = 0
    with recording_entry(eval_entry) as evaluated:
        got = evaluate(Config(**dict(vars(args), ckpt=ckpt,
                                     result_path=os.path.join(root, f"{label}_entry.json"))),
                       device=device)
    launches = argmax_shift_decode.launches
    same = compare_callback_with_eval_entry(trained["seen"], evaluated, load_checkpoint(ckpt))
    worst = max(abs(float(got[k]) - trained["stats"][k]) for k in trained["stats"])
    print(f"{label}'s last checkpoint through the eval entry: "
          f"{json.dumps({k: float(v) for k, v in got.items()})}; max |diff| against the "
          f"callback's {worst:.2e} (tolerance {ENTRY_STATS_ATOL}); the checkpoint holds the "
          f"trained net bit for bit; {same['evaluations']} evaluation(s), each after a "
          f"train-mode step, in eval mode; {same['persons']} crops, keypoints within "
          f"{same['pred_err']:.3e} of the callback's (tolerance {BU_ENTRY_PERSON_ATOL}); decode "
          f"kernel launches {launches}")
    if worst > ENTRY_STATS_ATOL:
        raise AssertionError(f"{label}: the last checkpoint's stats differ from the callback's")
    if not same["persons"] or same["pred_err"] > BU_ENTRY_PERSON_ATOL:
        raise AssertionError(f"{label}: the last checkpoint's keypoints differ from the "
                             "callback's")
    return {"stats": {k: float(v) for k, v in got.items()}, "launches": launches}


def train_simple_baseline(root: str, data: dict, device: torch.device, recipe: str) -> dict:
    """Phase 13: a SimpleBaseline recipe (``UDP_YAML`` or ``SB_YAML``) through the train entry.

    ResNet-50 + simple_baseline_head at full width, O2, batch 128, adamw,
    host targets (UDP ones for ``UDP_YAML``), on phase 12's synthetic COCO;
    overridden as phase 12 overrides: the data paths, ``num_epochs``,
    ``warmup``, ``val_interval`` (one evaluation, after the last epoch) and
    ``ckpt_save_dir``. It holds (``train_recipe``): finite losses, the last
    epoch's below the first's; and AP above 0, one decode launch per val
    batch, the last checkpoint written. Returns the run's numbers and the
    parsed config.
    """
    name = os.path.splitext(os.path.basename(recipe))[0]
    ckpt_dir = os.path.join(root, name)
    args = recipe_args(recipe, data, ckpt_dir, device, f"num_epochs={SB_EPOCHS}",
                       f"warmup={ENTRY_WARMUP}", f"val_interval={SB_EPOCHS}")
    run = train_recipe(args, name)
    del run["seen"]
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    print(f"{name}: {run['evaluations']} evaluation(s) of {val_batches} batch(es), decode "
          f"kernel launches {run['launches']}; stats {json.dumps(run['stats'])}")
    if not run["evaluations"] or not run["stats"]["AP"] > 0:
        raise AssertionError(f"{name}'s evaluation gave AP 0")
    if run["launches"] != run["evaluations"] * val_batches:
        raise AssertionError(f"{run['evaluations']} evaluations of {val_batches} batches made "
                             f"{run['launches']} decode launches")
    last_path = os.path.join(ckpt_dir, f"{name}_last.ckpt")
    if not os.path.isfile(last_path):
        raise AssertionError(f"the callback did not write {last_path}")
    return dict(run, name=name, args=args, ckpt=last_path)


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


def dark_rounding_bound(heat: torch.Tensor, coords: torch.Tensor, kernel: torch.Tensor,
                        px_per_cell: torch.Tensor) -> torch.Tensor:
    """[N, K] first-order bound, in px of the original frame, on how far two
    float32 runs of ``dark_udp_refine`` on the same heatmap and argmax
    ``coords`` may put a joint apart when each sums and rounds in its own order.

    Computed in float64 on the CPU. Each run's blurred value is within
    gamma_n * (blur of |heatmap|) of the exact one (n = kernel taps, the
    dot-product bound); through the clamp and the log that is an absolute
    error of that over the clamped value, plus the log's own rounding. These
    tap errors and the rounding of each derivative, the determinant and the
    step go through the step's closed form to first order. Where the
    determinant's error reaches half its value the bound is infinite.
    ``px_per_cell`` [N, 2] scales heatmap cells to the original frame.
    """
    u = 2.0 ** -24
    n = kernel.numel()
    gamma = n * u / (1 - n * u)
    heat = heat.detach().cpu().double()
    b, k, h, w = heat.shape
    filt = kernel.detach().cpu().double().expand(k, 1, *kernel.shape).contiguous()

    def blur(m: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.conv2d(m, filt, padding="same", groups=k)

    c = torch.clamp(blur(heat), 0.001, 50.0)
    spread = blur(heat.abs())
    log = torch.log(c)
    err = 2 * gamma * spread / c + 8 * u * log.abs()
    stride = w + 2
    center = ((coords[..., 0].long() + 1) + (coords[..., 1].long() + 1) * stride).cpu()

    def taps(m: torch.Tensor) -> dict:
        flat = torch.nn.functional.pad(m, (1, 1, 1, 1)).reshape(b, k, (h + 2) * stride)
        offsets = {"0": 0, "x": 1, "x_": -1, "y": stride, "y_": -stride, "xy": stride + 1,
                   "xy_": -stride - 1}
        return {name: torch.gather(flat, 2, (center + o)[..., None])[..., 0]
                for name, o in offsets.items()}

    t, e = taps(log), taps(err)
    dx, dy = 0.5 * (t["x"] - t["x_"]), 0.5 * (t["y"] - t["y_"])
    dxx = t["x"] - 2 * t["0"] + t["x_"]
    dyy = t["y"] - 2 * t["0"] + t["y_"]
    dxy = 0.5 * (t["xy"] - t["x"] - t["y"] + 2 * t["0"] - t["x_"] - t["y_"] + t["xy_"])
    a, d, bb = dxx + 1e-7, dyy + 1e-7, dxy
    det = a * d - bb * bb
    # tap errors, plus 16 u of the sum of |terms| for each derivative's own rounding
    e_dx = 0.5 * (e["x"] + e["x_"]) + 16 * u * 0.5 * (t["x"].abs() + t["x_"].abs())
    e_dy = 0.5 * (e["y"] + e["y_"]) + 16 * u * 0.5 * (t["y"].abs() + t["y_"].abs())
    e_a = e["x"] + 2 * e["0"] + e["x_"] + 16 * u * (t["x"].abs() + 2 * t["0"].abs()
                                                    + t["x_"].abs())
    e_d = e["y"] + 2 * e["0"] + e["y_"] + 16 * u * (t["y"].abs() + 2 * t["0"].abs()
                                                    + t["y_"].abs())
    names = ("xy", "x", "y", "0", "x_", "y_", "xy_")
    weights = (1, 1, 1, 2, 1, 1, 1)
    e_b = 0.5 * sum(wt * e[nm] for nm, wt in zip(names, weights)) + 16 * u * 0.5 * sum(
        wt * t[nm].abs() for nm, wt in zip(names, weights))
    e_det = (d.abs() * e_a + a.abs() * e_d + 2 * bb.abs() * e_b
             + 8 * u * ((a * d).abs() + bb * bb))
    num_x, num_y = d * dx - bb * dy, a * dy - bb * dx
    e_num_x = (dx.abs() * e_d + d.abs() * e_dx + dy.abs() * e_b + bb.abs() * e_dy
               + 8 * u * ((d * dx).abs() + (bb * dy).abs()))
    e_num_y = (dy.abs() * e_a + a.abs() * e_dy + dx.abs() * e_b + bb.abs() * e_dx
               + 8 * u * ((a * dy).abs() + (bb * dx).abs()))
    step_x, step_y = num_x / det, num_y / det
    # and the rounding of the step and of ``coords - step``
    refined = coords.detach().cpu().double().abs() + torch.stack([step_x, step_y], -1).abs()
    e_x = (e_num_x + step_x.abs() * e_det) / det.abs() + 8 * u * refined[..., 0]
    e_y = (e_num_y + step_y.abs() * e_det) / det.abs() + 8 * u * refined[..., 1]
    px = px_per_cell.detach().cpu().double()[:, None, :]
    bound = torch.maximum(e_x * px[..., 0], e_y * px[..., 1])
    return torch.where(e_det < 0.5 * det.abs(), bound, torch.full_like(bound, float("inf")))


def compare_dark_with_cpu(dark, heat: torch.Tensor, crops: list) -> dict:
    """The DARK decoder on the card and on the CPU, one heatmap: scores and
    boxes equal, one decode launch, and the keypoints held as set out at
    ``DARK_AGREE``. Returns the counts and differences it printed."""
    argmax_shift_decode.launches = 0
    preds_gpu, boxes_gpu = (t.cpu() for t in dark(heat, *crops))
    launches = argmax_shift_decode.launches
    heat_cpu, crops_cpu = heat.cpu(), [t.cpu() for t in crops]
    preds_cpu, boxes_cpu = dark(heat_cpu, *crops_cpu)
    coords, _ = argmax_shift_decode_plain(heat_cpu, False)
    h, w = heat.shape[2:4]
    cells = torch.tensor([w - 1.0, h - 1.0] if dark.use_udp else [w, h], dtype=torch.float64)
    bound = dark_rounding_bound(heat_cpu, coords, torch.from_numpy(
        gaussian_kernel_2d(dark.kernel_size)), crops_cpu[1].double() * dark.pixel_std / cells)
    # and the back-projection's own rounding of two different coordinates
    bound = bound + 8 * 2.0 ** -24 * preds_cpu[..., :2].abs().amax(-1).double()
    xy_err = (preds_gpu[..., :2] - preds_cpu[..., :2]).abs().amax(-1).double()
    within_bound = xy_err <= torch.clamp(2 * bound, min=EVAL_XY_ATOL)
    out = {
        "joints": xy_err.numel(),
        "tight": int((bound <= EVAL_XY_ATOL / 2).sum()),
        "unbounded": int(torch.isinf(bound).sum()),
        "max_err": float(xy_err.max()),
        "agree": float((xy_err <= EVAL_XY_ATOL).double().mean()),
        "within_bound": int(within_bound.sum()),
        "worst_err_over_bound": float((xy_err / bound)[bound > 0].max()),
        "scores_equal": bitwise_equal(preds_gpu[..., 2], preds_cpu[..., 2]),
        "boxes_close": torch.allclose(boxes_gpu, boxes_cpu, rtol=1e-6, atol=0),
        "launches": launches,
    }
    print(f"DARK decoder on the card against its CPU run, {len(heat)} crops: keypoints max "
          f"|diff| {out['max_err']:.3e} px; {out['within_bound']} of {out['joints']} joints "
          f"within the larger of {EVAL_XY_ATOL} px and twice their float32 rounding bound "
          f"({out['tight']} bounds <= {EVAL_XY_ATOL / 2} px, {out['unbounded']} infinite; "
          f"largest |diff| / bound {out['worst_err_over_bound']:.3e}); {out['agree']:.4f} of all "
          f"within {EVAL_XY_ATOL} px (at least {DARK_AGREE}); scores bitwise equal "
          f"{out['scores_equal']}, boxes within rtol 1e-6 {out['boxes_close']}; {launches} "
          f"decode launch")
    if not (bool(within_bound.all()) and out["agree"] >= DARK_AGREE and out["scores_equal"]
            and out["boxes_close"] and launches == 1):
        raise AssertionError("the DARK decoder on the card disagrees with its CPU run")
    return out


def eval_simple_baseline(root: str, trained: dict, device: torch.device) -> dict:
    """Phase 14: phase 13's UDP checkpoint through the eval entry with
    ``dark_udp_refine`` off and on (``eval_checkpoint``). Then, on one real
    eval batch's heatmap: the DARK decoder's device operations
    (torch.profiler) and device time per 32-crop chunk beside the decoder
    without it, and the DARK decoder on the card against its CPU run
    (``compare_dark_with_cpu``)."""
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

    compare_dark_with_cpu(dark, heat, crops)
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


def request_payloads(seed: int):
    """``make_requests``'s image and 1/5/40-box requests, with their
    ``POST /predict`` payloads (a lossless PNG) and their 32-crop chunks."""
    image, requests = make_requests(np.random.RandomState(seed))
    ok, png = cv2.imencode(".png", cv2.cvtColor(image, cv2.COLOR_RGB2BGR))  # lossless
    if not ok:
        raise RuntimeError("cv2 could not encode the request image")
    image_b64 = base64.b64encode(png.tobytes()).decode()
    payloads = [{"image_b64": image_b64, "boxes": b.tolist()} for b in requests]
    chunks = sum(-(-len(b) // BATCH_SIZE) for b in requests)
    return image, requests, payloads, chunks


def serve_checkpoint(recipe: str, ckpt: str, label: str, device: torch.device,
                     xy_atol: float) -> dict:
    """Phases 15 and 20: ``recipe`` with ``ckpt`` through the serving entry.

    ``tools/serve.build_service`` behind ``build_http_server`` on 127.0.0.1:
    ``GET /healthz``, then ``POST /predict`` with 1, 5 and 40 boxes over real
    HTTP (one decode launch per 32-crop chunk), each timed over ``REPEATS``
    runs; the 5-box answer against the same service on the CPU (phase 5's
    tolerance, the keypoints within ``xy_atol`` px). The server is shut down
    and its thread joined.
    """
    image, requests, payloads, chunks = request_payloads(SEED + 20)
    name = os.path.basename(recipe)
    args = serve_entry.parse_serve_args(["--config", recipe, "--ckpt", ckpt,
                                         "--batch-size", str(BATCH_SIZE)])
    start = time.perf_counter()
    service = serve_entry.build_service(args, batch_size=args.batch_size, device=device)
    print(f"serving entry: {name} with {label} built in {time.perf_counter() - start:.2f} s")
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
        print(f"serving entry, {name}: decode kernel launches {launches} for requests of "
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
                     xy_atol=xy_atol, answers=(answers[1], cpu_answer))
    return {"launches": launches, "latency_ms": medians}


def serve_simple_baseline(root: str, trained: dict, device: torch.device) -> dict:
    """Phase 15: phase 13's checkpoint through the serving entry.

    ``serve_checkpoint`` on resnet50_udp_tpu.yaml, the keypoints on the card
    against the CPU within ``EVAL_XY_ATOL`` px (the card's UDP
    back-projection multiplies by the float reciprocal of 47 where the CPU
    divides). Then resnet101_tpu.yaml and resnet152_tpu.yaml through the same
    entry, with random weights from a numpy seed written as a port
    checkpoint, answering a 40-box request each. Every server is shut down
    and its thread joined; no thread of this phase is left.
    """
    threads_before = set(threading.enumerate())
    served = serve_checkpoint(UDP_YAML, trained["ckpt"], "phase 13's checkpoint", device,
                              EVAL_XY_ATOL)
    launches, medians = served["launches"], served["latency_ms"]
    torch.cuda.empty_cache()
    _, requests, payloads, _ = request_payloads(SEED + 20)

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



def grouping_bytes_ms(n: int, k: int, m: int, tag_dim: int, g: int) -> float:
    """The matcher's bytes over the card's memory rate on n images: one read
    of its candidates (val_k, tag_k, ind_k) and one write of its groups and
    valid flags."""
    return (4 * n * k * m * (1 + tag_dim + 2) + 4 * n * g * k * (3 + tag_dim) + n * g) \
        / HBM_BYTES_PER_MS


def grouping_step_floor_ms(device: torch.device) -> float:
    """The time of one link of the least chain that an LSAP iteration runs
    (``cuda_grouping.step_floor``: a dependent shared-memory load, a warp min,
    a ballot and a shuffle): the slope of one warp's time over
    GROUPING_FLOOR_STEPS and twice as many links (CUDA events, median of 5)."""
    out = torch.empty(32, dtype=torch.int32, device=device)
    times = {}
    for steps in (GROUPING_FLOOR_STEPS, 2 * GROUPING_FLOOR_STEPS):
        times[steps] = time_ms(lambda: cuda_grouping.step_floor(out, steps), True, iters=3,
                               repeats=5)
    return (times[2 * GROUPING_FLOOR_STEPS] - times[GROUPING_FLOOR_STEPS]) / GROUPING_FLOOR_STEPS


def grouping_bound_ms(iterations: list, floor_ms: float, n: int, k: int, m: int, tag_dim: int,
                      g: int) -> tuple:
    """The matcher's least time on a batch, and what sets it: the larger of
    its bytes' time and its dependent chain's, the largest image's LSAP
    iterations (one warp per image, the images side by side) times the step
    floor. -> (bound ms, "operations" or "bytes", chain ms, bytes ms)."""
    chain = max(iterations) * floor_ms
    bytes_ms = grouping_bytes_ms(n, k, m, tag_dim, g)
    return max(chain, bytes_ms), "operations" if chain >= bytes_ms else "bytes", chain, bytes_ms


def plain_with_steps(sets, **kw) -> tuple:
    """The plain matcher on each image of ``sets`` apart: (groups, valid)
    stacked, and each image's LSAP iterations (``match_by_tag_batch.steps``)."""
    out, steps = [], []
    for image in zip(*sets):
        plain_grouping.match_by_tag_batch.steps = 0
        out.append(plain_grouping.match_by_tag_batch(*(a[None] for a in image), ORDER, **kw))
        steps.append(plain_grouping.match_by_tag_batch.steps)
    return (np.concatenate([g for g, _ in out]), np.concatenate([v for _, v in out])), steps


def check_grouped(got, want, label: str) -> None:
    """The kernel's (groups, valid) on the card bitwise equal to the plain version's."""
    got = tuple(t.cpu().numpy() for t in got)
    if not (np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
            and np.array_equal(got[1], want[1])):
        bad = np.nonzero((got[0] != want[0]).any((2, 3)) | (got[1] != want[1]))
        raise AssertionError(f"grouping kernel differs from the plain version on {label}: "
                             f"(image, group) {list(zip(*bad))[:5]}")


def time_grouping(device: torch.device, sets, floor_ms: float, label: str, cap: int = 0) -> dict:
    """The kernel on a batch of the recipe's settings (L = 1, the rounded norm;
    capacity ``cap``) and on its first image alone: bitwise against the plain
    version, each image's iterations, the device time (CUDA events, queued)
    and the bound of both batches."""
    want, steps = plain_with_steps(sets, group_cap=cap)
    dev = [torch.from_numpy(a).to(device) for a in sets]
    one = [a[:1].contiguous() for a in dev]
    check_grouped(cuda_grouping.match_by_tag_batch(*dev, ORDER, group_cap=cap), want, label)
    n, k, m = sets[0].shape
    out = {"iterations": steps, "iterations_mean": float(np.mean(steps))}
    for key, batch, its in (("1", one, steps[:1]), (str(n), dev, steps)):
        ms = time_ms(lambda: cuda_grouping.match_by_tag_batch(*batch, ORDER, group_cap=cap),
                     True, iters=GROUPING_ITERS, repeats=5)
        bound, by, chain, bytes_ms = grouping_bound_ms(its, floor_ms, len(its), k, m, 1,
                                                       cap or m)
        out[key] = {"ms": ms, "bound_ms": bound, "bound_by": by, "chain_ms": chain,
                    "bytes_ms": bytes_ms, "share": bound / ms, "max_iterations": max(its)}
    print(f"grouping kernel, {label}: iterations per image {out['iterations_mean']:.1f} "
          f"(image 0 {steps[0]}, largest {max(steps)}); batch of 1 {out['1']['ms']:.5f} ms, "
          f"chain bound {out['1']['chain_ms']:.5f} ms, share {out['1']['share']:.3f}; batch of "
          f"{n} {out[str(n)]['ms']:.5f} ms, chain bound {out[str(n)]['chain_ms']:.5f} ms, share "
          f"{out[str(n)]['share']:.3f}; {out[str(n)]['ms'] / max(steps) * 1e3:.4f} us per "
          f"iteration of the largest image")
    return out


def check_grouping(device: torch.device) -> dict:
    """Phase 16: the grouping kernel against its plain version (ops/grouping.py,
    numpy on the host) on ``GROUPING_SETS`` seeded candidate sets of each kind
    of ``SETS`` (K=17, M=30: a few persons, close tags, more persons than the
    capacity, a capacity of 4) and of ``TIE_SETS`` (tags on a grid, no noise:
    exact ties) for L = 1 and 2, the rounded norm on and off,
    ``ignore_too_much`` on and off, and on wider sets that take the kernel's
    128- and 256-column bounds: groups and valid bitwise equal. Then the step
    floor (the bound's probe), and at the recipe's settings (L = 1, rounded)
    on the timed batch (5 persons, drawn after the checks from their
    generator) and on 32 images of each kind of ``SETS``
    (each drawn from a fresh ``RandomState(0)``): each image's LSAP
    iterations (counted by the plain version), the kernel's device time per
    batch of 1 and of 32 (CUDA events, queued), its bound (the larger of the
    bytes' time and the largest image's iterations times the step floor) and
    its share of it; the plain version's and the host Hungarian's
    (utils/match.py) host time per image."""
    rng = np.random.RandomState(SEED + 30)
    ties = np.random.RandomState(SEED + 32)  # apart, so that rng's draws stay as they were
    total = 0
    for tag_dim in (1, 2):
        for rounded in (True, False):
            for ignore in (False, True):
                for source, kinds in ((rng, SETS), (ties, TIE_SETS)):
                    for name, kwargs, cap in kinds:
                        sets = candidate_sets(source, GROUPING_SETS, tag_dim=tag_dim, **kwargs)
                        kw = dict(vis_thr=0.1, tag_thr=1.0, use_rounded_norm=rounded,
                                  ignore_too_much=ignore, group_cap=cap)
                        want = plain_grouping.match_by_tag_batch(*sets, ORDER, **kw)
                        got = cuda_grouping.match_by_tag_batch(
                            *(torch.from_numpy(a).to(device) for a in sets), ORDER, **kw)
                        check_grouped(got, want, f"{name}, L={tag_dim}, rounded={rounded}, "
                                                 f"ignore_too_much={ignore}")
                        total += len(sets[0])
    print(f"grouping kernel: {total} candidate sets (K=17, M=30; L=1, 2; rounded norm on, off; "
          f"ignore_too_much on, off; {[name for name, _, _ in SETS + TIE_SETS]}): groups and "
          f"valid bitwise equal to the plain version")
    wide = np.random.RandomState(SEED + 31)
    for m, cap, kwargs in GROUPING_WIDE:
        sets = candidate_sets(wide, 2, m=m, tag_dim=2, **kwargs)
        want = plain_grouping.match_by_tag_batch(*sets, ORDER, group_cap=cap)
        got = cuda_grouping.match_by_tag_batch(
            *(torch.from_numpy(a).to(device) for a in sets), ORDER, group_cap=cap)
        check_grouped(got, want, f"M={m}, G={cap or m}")
        total += len(sets[0])
    print(f"grouping kernel: {2 * len(GROUPING_WIDE)} wider sets (M, G = "
          f"{[(m, cap or m) for m, cap, _ in GROUPING_WIDE]}, L=2): bitwise equal")

    floor_ms = grouping_step_floor_ms(device)
    print(f"grouping step floor (one warp: a dependent shared-memory load, redux.sync, a "
          f"ballot, a shuffle): {floor_ms * 1e6:.3f} ns a step")

    sets = candidate_sets(rng, BATCH_SIZE, **SETS[0][1])
    out = {"sets": total, "max_abs_err": 0.0, "step_floor_ms": floor_ms}
    out["timed"] = time_grouping(device, sets, floor_ms, "the timed batch (5 persons)")
    start = time.perf_counter()
    plain_grouping.match_by_tag_batch(*sets, ORDER)
    out["plain_ms"] = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    for v, t, i in zip(*sets):
        match_by_tag(v, t, i, ORDER)
    out["library_ms"] = (time.perf_counter() - start) * 1e3
    out["kinds"] = {name: time_grouping(device, candidate_sets(np.random.RandomState(0),
                                                               BATCH_SIZE, **kwargs),
                                        floor_ms, name, cap)
                    for name, kwargs, cap in SETS}
    timed = out["timed"][str(BATCH_SIZE)]
    print(f"grouping kernel, device time (queued): {out['timed']['1']['ms']:.5f} ms per batch "
          f"of 1, {timed['ms']:.5f} ms per batch of {BATCH_SIZE} ({timed['ms'] / BATCH_SIZE:.5f} "
          f"ms per image); bound {timed['bound_ms']:.5f} ms, by {timed['bound_by']} (the chain: "
          f"the largest image's {timed['max_iterations']} iterations x the step floor = "
          f"{timed['chain_ms']:.5f} ms; the bytes {timed['bytes_ms']:.5f} ms), share "
          f"{timed['share']:.3f}; the plain version on the "
          f"host {out['plain_ms'] / BATCH_SIZE:.3f} ms per image; the host Hungarian "
          f"(utils/match.py, scipy) {out['library_ms'] / BATCH_SIZE:.3f} ms per image")
    return out


def bottomup_args(root: str, ckpt: str, images: tuple, **options) -> Config:
    """higher_hrnet_w32_tpu.yaml as the eval entry parses it, on ``images``
    (image root, annotation file) with ``ckpt``."""
    flags = [f"val_root={images[0]}", f"val_label={images[1]}", f"ckpt={ckpt}",
             f"result_path={os.path.join(root, 'bottomup_result.json')}"]
    flags += [f"{k}={v}" for k, v in options.items()]
    return parse_args(["--config", HIGHER_YAML, "--cfg-options", *flags])


def bottomup_fixture_args(root: str, **eval_setting) -> Config:
    """The bottom-up fixture's config on its val split under ``root``."""
    img_root, ann = tiny_coco.write_val(os.path.join(root, "bottomup_fixture"))
    cfg = dict(BOTTOMUP_RECORD["config"], val_root=img_root, val_label=ann, ckpt=BOTTOMUP_CKPT,
               result_path=os.path.join(root, "bottomup_fixture_result.json"))
    cfg["eval_setting"] = dict(cfg["eval_setting"], **eval_setting)
    return Config(**cfg)


def bottomup_eval(args: Config, device: torch.device, label: str) -> dict:
    """Phase 17: one bottom-up evaluation through the eval entry, the grouping
    kernel's launches counted on that run alone."""
    timings = {}
    torch.cuda.synchronize()
    cuda_grouping.match_by_tag_batch.launches = 0
    stats = evaluate(args, device=device, timings=timings)
    launches = cuda_grouping.match_by_tag_batch.launches
    records, batches, infer_s = timings["records"], timings["batches"], timings["infer_s"]
    print(f"bottom-up eval {label}: {records} images in {batches} batches; inferencer "
          f"{infer_s:.3f} s ({records / infer_s:.2f} images/s, host loading included), "
          f"evaluator {timings['eval_s']:.3f} s; grouping kernel launches {launches}")
    print(f"bottom-up eval {label} stats: {json.dumps({k: float(v) for k, v in stats.items()})}")
    want = batches if args.eval_setting.get("device_grouping", True) else 0
    if launches != want:
        raise AssertionError(f"{label}: {batches} batches made {launches} grouping launches")
    values = np.array([float(v) for v in stats.values()])
    if len(values) != 10 or not (np.isfinite(values) & (values >= -1) & (values <= 1)).all():
        raise AssertionError(f"bottom-up eval {label}: malformed COCO stats {stats}")
    return dict(timings, launches=launches, stats=stats)


def time_bottomup_batches(args: Config, device: torch.device) -> dict:
    """Phase 17: where a bottom-up eval batch's time goes: the host loader
    alone over the val set, then on ``BU_SPLIT_BATCHES`` batches the forward,
    the decode and the grouping (the kernel, its result copied to the host)
    each ended by a synchronize, and the host's post-processing (scores,
    back-projection, with ``refine_missing_joint`` off as in the yaml);
    medians in ms per batch."""
    net = create_network_from_config(args)
    net.load_state_dict(load_net_state_dict(args.ckpt, net), strict=True)
    decoder = create_decoder(args.decoder_name, **args.decoder_setting)
    inferencer = create_inferencer(create_eval_network(net, decoder),
                                   name=args.inference_method, config=args.eval_setting,
                                   dataset_config=args.dataset_setting, device=device,
                                   amp_level=args.amp_level)
    loader = eval_loader(args, args.batch_size)
    start = time.perf_counter()
    batches = list(loader)
    loader_s = time.perf_counter() - start
    split = {"forward": [], "decode": [], "grouping": [], "host": []}
    with torch.inference_mode():
        for batch in batches[:BU_SPLIT_BATCHES + 1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            image = inferencer._upload(batch["image"]).permute(0, 3, 1, 2).contiguous()
            mask = inferencer._upload(batch["mask"])
            with inferencer.precision():
                raw = inferencer.net.net.eval()(image)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            val_k, tag_k, ind_k, heatmap, tags = decoder(raw, mask)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            persons = inferencer.group(val_k, tag_k, ind_k)
            t3 = time.perf_counter()
            [[y[:, 2].mean() for y in x] for x in persons]  # the scores
            transform_keypoints(persons, np.asarray(batch["center"], np.float32),
                                np.asarray(batch["scale"], np.float32),
                                np.asarray(batch["image_shape"], np.float32)
                                / args.eval_setting["downsample_scale"],
                                pixel_std=args.dataset_setting["pixel_std"])
            t4 = time.perf_counter()
            for key, value in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[key].append(value * 1e3)
    out = {key: statistics.median(v[1:]) for key, v in split.items()}  # the first warms up
    out["loader_images_per_s"] = len(loader.dataset) / loader_s
    out["persons"] = sum(len(p) for p in persons)
    print(f"bottom-up eval loader alone: {len(loader.dataset)} images in {loader_s:.3f} s "
          f"({out['loader_images_per_s']:.1f} images/s)")
    print(f"bottom-up eval batch of {len(batches[0]['image'])} [{batches[0]['image'].shape[1]}x"
          f"{batches[0]['image'].shape[2]}] at {args.amp_level}, median of "
          f"{BU_SPLIT_BATCHES}: forward {out['forward']:.3f} ms, decode {out['decode']:.3f} ms, "
          f"grouping (kernel + copy) {out['grouping']:.3f} ms, host post-processing "
          f"{out['host']:.3f} ms")
    del inferencer, net
    return out


def bottomup_evaluation(root: str, device: torch.device) -> dict:
    """Phase 17.

    (a) The bottom-up fixture (JAX-trained, tests/fixtures/) at O0 through the
    eval entry: with ``device_grouping`` on (the kernel) its 10 stats within
    ``BU_STATS_ATOL`` of the JAX package's with its matcher, and off (the
    host Hungarian) of JAX's host stats; one kernel launch per batch.
    (b) higher_hrnet_w32_tpu.yaml at full width, with random weights from a
    numpy seed written as a port checkpoint, at O2 and batch 1 (the yaml's
    non-square max_image_size) on ``BU_EVAL_IMAGES`` frames of
    mindpose_tpu_torch/tools/make_synthetic_coco.py: images/s, one grouping launch per batch,
    and the split of ``time_bottomup_batches``.
    """
    register_port_backbone()
    fixture = {}
    for grouping in (True, False):
        args = bottomup_fixture_args(root, device_grouping=grouping)
        label = f"fixture O0 {'matcher (kernel)' if grouping else 'host Hungarian'}"
        run = bottomup_eval(args, device, label)
        want = BOTTOMUP_RECORD["jax_stats"]["device_grouping" if grouping else "host"]
        err = max(abs(float(run["stats"][k]) - v) for k, v in want.items())
        print(f"bottom-up {label}: AP {float(run['stats']['AP']):.6f}, JAX "
              f"{want['AP']:.6f}; largest stat difference {err:.2e} (limit {BU_STATS_ATOL})")
        if err > BU_STATS_ATOL:
            raise AssertionError(f"bottom-up {label}: stats {err} from JAX's")
        fixture[grouping] = run

    data = write_synthetic_coco(os.path.join(root, "bottomup"), 0, BU_EVAL_IMAGES,
                                BU_EVAL_PEOPLE)
    ckpt = os.path.join(root, "higher_hrnet_w32_random.ckpt")
    probe = bottomup_args(root, ckpt, data["val"])
    net = create_network_from_config(probe)
    random_weights_(net, device)
    save_checkpoint(ckpt, net)
    del net
    args = bottomup_args(root, ckpt, data["val"])
    run = bottomup_eval(args, device, f"higher_hrnet_w32_tpu.yaml {args.amp_level}, random "
                                      f"weights")
    if run["batches"] != BU_EVAL_IMAGES:
        raise AssertionError(f"the recipe's non-square max_image_size batched "
                             f"{BU_EVAL_IMAGES} images into {run['batches']} batches")
    split = time_bottomup_batches(args, device)
    torch.cuda.empty_cache()
    return {"fixture": fixture, "recipe": run, "split": split, "ckpt": ckpt,
            "launches": fixture[True]["launches"] + run["launches"]}


def serving_frame() -> np.ndarray:
    """A 640x480 RGB frame holding a tiny_coco val frame (two drawn persons)
    scaled by 2.5."""
    with tempfile.TemporaryDirectory() as root:
        img_root, _ = tiny_coco.write_val(root)
        small = cv2.cvtColor(cv2.imread(os.path.join(img_root, "000000000001.png")),
                             cv2.COLOR_BGR2RGB)
    big = np.zeros((480, 640, 3), np.uint8)
    big[40:440, 40:600] = cv2.resize(small, (560, 400), interpolation=cv2.INTER_LINEAR)
    return big


def check_persons(preds: np.ndarray, scores: list) -> None:
    """[P, 17, 3] persons, finite, one score each."""
    if preds.ndim != 3 or preds.shape[1:] != (17, 3) or len(scores) != len(preds):
        raise AssertionError(f"persons of shape {preds.shape} with {len(scores)} scores")
    if not np.isfinite(preds).all() or not np.isfinite(scores).all():
        raise AssertionError("non-finite persons or scores")


def serve_bottomup(root: str, ckpt: str, device: torch.device) -> dict:
    """Phase 18: higher_hrnet_w32_tpu.yaml through the serving entry
    (``tools/serve.build_service`` with phase 17's random-weight checkpoint,
    behind ``build_http_server`` on 127.0.0.1): ``GET /healthz``, then
    ``POST /predict`` of a 640x480 PNG (served at 832x832) over real HTTP,
    one grouping launch per request, ``REPEATS`` timed requests beside the
    service's ``latency_ms``, and the device operations of one request under
    torch.profiler. Then the bottom-up fixture's service with
    ``device_grouping`` on, on the card against the CPU (the plain matcher):
    the same persons, keypoints within ``EVAL_XY_ATOL`` px, scores within
    ``BU_SCORE_ATOL``. Every server is shut down and no thread is left."""
    threads_before = set(threading.enumerate())
    image = serving_frame()
    ok, png = cv2.imencode(".png", cv2.cvtColor(image, cv2.COLOR_RGB2BGR))  # lossless
    if not ok:
        raise RuntimeError("cv2 could not encode the request image")
    payload = {"image_b64": base64.b64encode(png.tobytes()).decode()}

    args = serve_entry.parse_serve_args(["--config", HIGHER_YAML, "--ckpt", ckpt])
    start = time.perf_counter()
    service = serve_entry.build_service(args, device=device)
    print(f"serving entry: higher_hrnet_w32_tpu.yaml (bottom-up) with random weights built in "
          f"{time.perf_counter() - start:.2f} s")
    http = HttpService(service)
    try:
        with urllib.request.urlopen(http.url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        print(f"serving entry GET /healthz: {health}")
        if health != {"status": "ok", "mode": "bottomup", "num_joints": 17}:
            raise AssertionError(f"unexpected /healthz answer {health}")
        post(http.url + "/predict", payload)  # warm-up
        torch.cuda.synchronize()
        cuda_grouping.match_by_tag_batch.launches = 0
        answer = post(http.url + "/predict", payload)
        launches = cuda_grouping.match_by_tag_batch.launches
        preds = np.asarray(answer["predictions"], np.float32)
        check_persons(preds, answer["scores"])
        print(f"serving entry, bottom-up 640x480 PNG: {len(preds)} persons; grouping kernel "
              f"launches {launches} for 1 request")
        if launches != 1:
            raise AssertionError(f"one bottom-up request made {launches} grouping launches")
        runs, served = [], []
        for _ in range(REPEATS):
            start = time.perf_counter()
            served.append(post(http.url + "/predict", payload)["latency_ms"])
            runs.append((time.perf_counter() - start) * 1e3)
        latency = {"median": statistics.median(runs), "min": min(runs), "max": max(runs),
                   "service_median": statistics.median(served)}
        print(f"serving entry, bottom-up 640x480 over HTTP, {REPEATS} runs: median "
              f"{latency['median']:.3f} ms, min {latency['min']:.3f}, max {latency['max']:.3f}; "
              f"of it the predictor (the service's latency_ms) median "
              f"{latency['service_median']:.3f} ms, min {min(served):.3f}, max {max(served):.3f}")
        ops = device_ops(lambda: service.predictor(image))
        kernels = sorted({name for name in ops})
        print(f"serving entry, bottom-up request under torch.profiler: {len(ops)} device "
              f"operations ({len(kernels)} distinct); grouping kernel among them: "
              f"{any('match_kernel' in name for name in ops)}")
    finally:
        http.close()
    del service
    torch.cuda.empty_cache()

    register_port_backbone()
    fixture = bottomup_fixture_args(root, device_grouping=True)
    with torch.device("meta"):
        skeleton = create_network_from_config(fixture)
    state = load_net_state_dict(BOTTOMUP_CKPT, skeleton)
    answers = {}
    for label, where in (("card", device), ("cpu", torch.device("cpu"))):
        fixture_service = PoseService(BottomUpPredictor.from_config(fixture, state, device=where),
                                      mode="bottomup", num_joints=17)
        try:
            answers[label] = fixture_service.predict(payload)
        finally:
            fixture_service.close()
    got, want = (np.asarray(answers[k]["predictions"], np.float32) for k in ("card", "cpu"))
    got_s, want_s = (np.asarray(answers[k]["scores"], np.float32) for k in ("card", "cpu"))
    if got.shape != want.shape or len(got) < 2:
        raise AssertionError(f"the fixture's persons on the card {got.shape}, on the CPU "
                             f"{want.shape}")
    xy_err = float(np.abs(got[..., :2] - want[..., :2]).max())
    score_err = max(float(np.abs(got[..., 2] - want[..., 2]).max()),
                    float(np.abs(got_s - want_s).max()))
    print(f"bottom-up fixture served on the card against the CPU (device_grouping on: the "
          f"kernel, the plain matcher): {len(got)} persons each; keypoints within {xy_err:.2e} "
          f"px (limit {EVAL_XY_ATOL}), scores within {score_err:.2e} (limit {BU_SCORE_ATOL})")
    if xy_err > EVAL_XY_ATOL or score_err > BU_SCORE_ATOL:
        raise AssertionError("the bottom-up fixture served on the card differs from the CPU")

    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    print(f"bottom-up serving: threads left running after shutdown: {left or 'none'}")
    if left:
        raise AssertionError(f"the bottom-up serving phase left threads running: {left}")
    return {"launches": launches, "latency": latency, "device_ops": len(ops)}


def bottomup_step_inputs(batch: dict, dtype=torch.float32) -> list:
    """A bottom-up train batch as the train entry uploads it: image NHWC ->
    NCHW, target [N, S, H, W, K] -> [N, S, K, H, W], mask and tag_ind as
    they are (on the CPU)."""
    return [torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).contiguous().to(dtype),
            torch.from_numpy(batch["target"]).permute(0, 1, 4, 2, 3).contiguous().to(dtype),
            torch.from_numpy(batch["mask"]), torch.from_numpy(batch["tag_ind"])]


def compare_bottomup_train_with_cpu(root: str, device: torch.device) -> dict:
    """Phase 19 (a): one bottom-up train step of the fixture's reduced
    HigherHRNet (its JAX-trained weights) on the card against the CPU, on
    one loader batch of tiny_coco frames with higher_hrnet_w32_tpu.yaml's
    train transforms, loss, optimizer and schedule (whose first step has lr
    0). Float64 and float32 (O0), held as ``BU_CPU_BATCH``'s comment says."""
    register_port_backbone()
    cfg = BOTTOMUP_RECORD["config"]
    recipe = parse_args(["--config", HIGHER_YAML])
    setting = cfg["dataset_setting"]
    img_root, ann = tiny_coco.write_split(os.path.join(root, "bottomup_step"), 2 * BU_CPU_BATCH,
                                          tiny_coco.TRAIN_SEED)
    np.random.seed(SEED)
    dataset = create_dataset(img_root, ann, dataset_format="coco_bottomup", is_train=True,
                             config=setting)
    batch = first_batch(create_pipeline(dataset, recipe.train_transforms, method="bottomup",
                                        batch_size=BU_CPU_BATCH, is_train=True, config=setting,
                                        num_workers=1, seed=SEED))
    loss_setting = dict(recipe.loss_setting, stage_sizes=setting["heatmap_sizes"])
    cpu = torch.device("cpu")

    def make(dev, dtype):
        net = create_network(cfg["backbone_name"], cfg["head_name"], num_joints=17,
                             head_args=cfg["head_setting"])
        net.load_state_dict(load_net_state_dict(BOTTOMUP_CKPT, net), strict=True)
        net.to(dev, dtype)
        nwl = create_network_with_loss(net, create_loss(recipe.loss, **loss_setting),
                                       has_extra_inputs=True)
        return net, nwl, [t.to(dev) for t in bottomup_step_inputs(batch, dtype)]

    out = {}
    for name, dev in (("gpu32", device), ("cpu32", cpu)):
        net, nwl, inputs = make(dev, torch.float32)
        optimizer = create_optimizer(net, recipe.optimizer, learning_rate=recipe.lr,
                                     weight_decay=recipe.weight_decay,
                                     filter_bias_and_bn=recipe.filter_bias_and_bn)
        schedule = create_lr_scheduler(recipe.scheduler, lr=recipe.lr, total_epochs=1,
                                       steps_per_epoch=2 * BU_TRAIN_WARMUP,
                                       warmup=BU_TRAIN_WARMUP)
        loss = build_train_step(nwl, optimizer, schedule, amp_level="O0")(*inputs)
        out[name] = (loss.double().cpu(), *_grads_and_stats(net))
    # a float64 net's losses are float64 too (in float32 the AE loss's sums
    # round apart on the card and the CPU, and its gradient seeds with them:
    # 2.4e-8 of a gradient tensor's largest entry)
    for name, dev in (("gpu64", device), ("cpu64", cpu)):
        net, nwl, inputs = make(dev, torch.float64)
        loss = accum_loss_and_grads(nwl, inputs)
        out[name] = (loss.cpu(), *_grads_and_stats(net))

    def loss_err(a, b):
        return float((out[a][0] - out[b][0]).abs().max() / out[b][0].abs().max())

    grads64 = _errors(out["gpu64"][1], out["cpu64"][1])
    f64 = {"loss": loss_err("gpu64", "cpu64"), "gradients": max(grads64.values()),
           "statistics": max(_errors(out["gpu64"][2], out["cpu64"][2]).values())}
    print(f"bottom-up train step card-vs-CPU, fixture net, batch {BU_CPU_BATCH}, float64: loss "
          f"{out['gpu64'][0].tolist()} against {out['cpu64'][0].tolist()}; max|diff|/max|x| of "
          f"the loss {f64['loss']:.3e}, {len(grads64)} gradients {_summary(grads64)}, "
          f"{len(out['cpu64'][2])} running statistics {f64['statistics']:.3e}; bound "
          f"{TRAIN_F64_RTOL} each")
    f32_loss = loss_err("gpu32", "cpu32")
    stats_err = _errors(out["gpu32"][2], out["cpu32"][2])
    want = out["cpu64"][1]
    gpu_err, cpu_err = _errors(out["gpu32"][1], want), _errors(out["cpu32"][1], want)
    print(f"bottom-up train step card-vs-CPU, float32 (O0): loss {out['gpu32'][0].tolist()} "
          f"against {out['cpu32'][0].tolist()}, max|diff|/max|loss| {f32_loss:.3e} (bound "
          f"{TRAIN_LOSS_RTOL}); BN running statistics {_summary(stats_err)} (bound "
          f"{TRAIN_STATS_RTOL}); gradients against the CPU's float64: GPU {_summary(gpu_err)}, "
          f"CPU {_summary(cpu_err)} (bound the larger of {TRAIN_GRAD_FACTOR} x the CPU's and "
          f"{BU_GRAD_FLOOR}); worst GPU {_worst(gpu_err)}")
    grads_ok = all(
        agg(gpu_err.values()) <= max(TRAIN_GRAD_FACTOR * agg(cpu_err.values()), BU_GRAD_FLOOR)
        for agg in (statistics.median, max))
    if max(f64.values()) > TRAIN_F64_RTOL:
        raise AssertionError(f"the float64 bottom-up train step on the card disagrees with the "
                             f"CPU's: {f64}")
    if not (f32_loss <= TRAIN_LOSS_RTOL and max(stats_err.values()) <= TRAIN_STATS_RTOL
            and grads_ok):
        raise AssertionError("the float32 bottom-up train step on the card disagrees with the "
                             "CPU beyond the tolerances")
    return {"f64": f64, "f32_loss": f32_loss}


def bottomup_train_args(root: str, data: dict, device: torch.device, label: str,
                        *options: str) -> Config:
    """higher_hrnet_w32_tpu.yaml as the train entry parses it, with phase
    19's overrides: the data paths, ``num_epochs``, ``warmup``,
    ``val_interval``, ``ckpt_save_dir``, and ``options``."""
    (train_root, train_label), (val_root, val_label) = data["train"], data["val"]
    return train_entry.parse_train_args(
        ["--config", HIGHER_YAML, "--device", str(device), "--cfg-options",
         f"train_root={train_root}", f"train_label={train_label}", f"val_root={val_root}",
         f"val_label={val_label}", f"ckpt_save_dir={os.path.join(root, label)}",
         f"num_epochs={BU_TRAIN_EPOCHS}", f"warmup={BU_TRAIN_WARMUP}",
         f"val_interval={BU_TRAIN_VAL_INTERVAL}", *options])


class _TracedStep:
    """A train entry's step whose calls ``BU_PROFILED_CALL - 2`` to
    ``BU_PROFILED_CALL`` (from 0) are timed apart (``traced_entry_step``)."""

    def __init__(self, step, out: dict, preprocess_events: dict) -> None:
        self.step, self.out, self.events = step, out, preprocess_events
        self.calls = 0
        self.prof = None

    @property
    def count(self) -> int:
        return self.step.count

    def __call__(self, *batch):
        call, self.calls = self.calls, self.calls + 1
        if call == BU_PROFILED_CALL - 2:
            torch.cuda.synchronize()
            start = time.perf_counter()
            loss = self.step(*batch)
            self.out["issue_ms"] = (time.perf_counter() - start) * 1e3
            torch.cuda.synchronize()
            self.out["wall_ms"] = (time.perf_counter() - start) * 1e3
            return loss
        if call == BU_PROFILED_CALL - 1:
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            loss = self.step(*batch)
            torch.cuda.synchronize()
            time.sleep(0.01)
            return loss
        if call != BU_PROFILED_CALL:
            return self.step(*batch)
        mark = "chip_smoke.traced_step"
        self.events["on"] = True
        with record_function(mark):
            loss = self.step(*batch)
            torch.cuda.synchronize()
        self.events["on"] = False
        self.prof.__exit__(None, None, None)
        events = trace_events(self.prof)
        cut = next(start for name, _, start, _ in events if name == mark) - 5000
        ops = [(name, start, end) for name, on_device, start, end in events
               if on_device and start >= cut and name != mark]
        spans = sorted((start, end) for _, start, end in ops)
        busy, reach = 0.0, float("-inf")
        for begin, end in spans:  # the union of the operations' intervals
            busy += max(0.0, end - max(begin, reach))
            reach = max(reach, end)
        by_name = {}
        for name, start, end in ops:
            by_name[name] = by_name.get(name, 0.0) + (end - start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        start, end = self.events.get("targets", (None, None))
        self.out.update(
            device_ops=len(ops), busy_ms=busy / 1e3,
            span_ms=(spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0,
            targets_ms=start.elapsed_time(end) if start is not None else None,
            top=[(name[:60], us / 1e3) for name, us in top])
        self.prof = None
        return loss


@contextlib.contextmanager
def traced_entry_step():
    """Within the block, the train entry's step (``build_train_step``) is a
    ``_TracedStep`` and the device pipeline's preprocess, at the traced
    call, is timed with CUDA events. Yields the dict the traced calls fill:
    ``issue_ms`` and ``wall_ms`` (call ``BU_PROFILED_CALL - 2`` from a
    synchronization until the step returns, and until the device has
    finished it), and of call ``BU_PROFILED_CALL`` (the one before it
    in the same trace: a trace may miss the device operations at its
    start, see ``device_ops``) ``device_ops``, ``busy_ms`` (the union of
    their intervals), ``span_ms``, ``targets_ms`` and ``top``."""
    out, events = {}, {"on": False}
    build_step = train_entry.build_train_step
    build_preprocess = train_entry.build_bottomup_preprocess

    def build_train_step(*args, **kwargs):
        return _TracedStep(build_step(*args, **kwargs), out, events)

    def build_bottomup_preprocess(*args, **kwargs):
        preprocess = build_preprocess(*args, **kwargs)

        def timed(*columns):
            if not events["on"]:
                return preprocess(*columns)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            result = preprocess(*columns)
            end.record()
            events["targets"] = (start, end)
            return result

        return timed

    train_entry.build_train_step = build_train_step
    train_entry.build_bottomup_preprocess = build_bottomup_preprocess
    try:
        yield out
    finally:
        train_entry.build_train_step = build_step
        train_entry.build_bottomup_preprocess = build_preprocess


def train_bottomup(args: Config, device: torch.device, label: str) -> dict:
    """Phase 19 (b), (c): one run of the train entry on ``args``, the grouping
    kernel's launches counted on it alone. Prints per epoch the img/s, the
    step median, the wait on ``next(batches)``, the loss vector and the AP,
    then the peak memory. Holds: finite losses, the last epoch's summed loss
    below the first's, at least two evaluations, one grouping launch per
    eval batch and none of the decode kernel, the last checkpoint written.
    Also prints the memory live at its start, the allocator's calls over
    the run, and one warm step timed apart (``traced_entry_step``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    counters = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    before = torch.cuda.memory_stats()
    start = time.perf_counter()
    cuda_grouping.match_by_tag_batch.launches = 0
    argmax_shift_decode.launches = 0
    with recording_entry(train_entry) as seen, traced_entry_step() as traced:
        result = train_entry.train(args)
    launches = cuda_grouping.match_by_tag_batch.launches
    decode_launches = argmax_shift_decode.launches
    train_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_stats()
    allocator = {k: after.get(k, 0) - before.get(k, 0) for k in counters}
    epochs = result["epochs"]
    rate = entry_epochs(label, epochs)
    with open(os.path.join(args.ckpt_save_dir, "summary", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    vectors = [[r[f"train/loss_{i}"] for i in range(3)] for r in records]
    step_median_ms = statistics.median(e["step_median_s"] for e in epochs[1:]) * 1e3
    wait_ms = statistics.median(e["wait_median_s"] for e in epochs[1:]) * 1e3
    evals = [e for e in epochs if e["metrics"]]
    val_batches = BU_TRAIN_VAL_IMAGES  # batch 1
    print(f"{label}: loss vectors [mse, push, pull] per epoch {vectors}")
    print(f"{label} ({args.amp_level}, batch {args.batch_size}, {args.num_parallel_workers} "
          f"loader threads): epochs 2-{len(epochs)} {rate:.2f} img/s with the loader feeding "
          f"the step, median of the epochs' step medians {step_median_ms:.1f} ms, of their waits "
          f"on next(batches) {wait_ms:.1f} ms; {sum(e['steps'] for e in epochs)} steps and "
          f"{len(evals)} evaluations in {train_s:.1f} s; peak torch.cuda.max_memory_allocated "
          f"{peak} B ({peak / 2**30:.2f} GiB)")
    stats = {k: float(v) for k, v in evals[-1]["metrics"].items()} if evals else {}
    print(f"{label}: {len(evals)} evaluations of {val_batches} batches, grouping kernel "
          f"launches in the callback {launches}, decode kernel launches {decode_launches}; last "
          f"stats {json.dumps(stats)}")
    print(f"{label}: memory live at the start {live} B, reserved {reserved} B; over the run "
          f"{json.dumps(allocator)}")
    top = "; ".join(f"{name} {ms:.3f} ms" for name, ms in traced["top"])
    targets = ("none" if traced["targets_ms"] is None
               else f"{traced['targets_ms']:.3f} ms (CUDA events)")
    if not traced["device_ops"]:
        raise AssertionError(f"{label}: the traced step holds no device operation")
    idle = 1 - traced["busy_ms"] / traced["span_ms"]
    print(f"{label}: step call {BU_PROFILED_CALL - 2} from a synchronization: issued in "
          f"{traced['issue_ms']:.3f} ms, done on the device in {traced['wall_ms']:.3f} ms; call "
          f"{BU_PROFILED_CALL} under torch.profiler: "
          f"{traced['device_ops']} device operations, busy {traced['busy_ms']:.3f} ms of a "
          f"{traced['span_ms']:.3f} ms span (idle share {idle:.3f}), device targets "
          f"{targets}; top by device time: {top}")
    losses = [e["loss"] for e in epochs]
    if not (np.isfinite(losses).all() and np.isfinite(vectors).all()) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the losses are not finite or did not fall: {losses}")
    if len(evals) < 2 or launches != len(evals) * val_batches or decode_launches:
        raise AssertionError(f"{label}: {len(evals)} evaluations of {val_batches} batches made "
                             f"{launches} grouping and {decode_launches} decode launches")
    name = os.path.splitext(os.path.basename(HIGHER_YAML))[0]
    last_path = os.path.join(args.ckpt_save_dir, f"{name}_last.ckpt")
    if not os.path.isfile(last_path):
        raise AssertionError(f"the callback did not write {last_path}")
    return {"launches": launches, "stats": stats, "ckpt": last_path, "images_per_sec": rate,
            "step_median_ms": step_median_ms, "wait_median_ms": wait_ms, "peak_bytes": peak,
            "loss_vectors": vectors, "evaluations": len(evals), "seen": seen, "traced": traced,
            "allocator": allocator}


def check_device_targets(args: Config, device: torch.device) -> dict:
    """Phase 19 (c): one batch of the device pipeline's loader (the host's
    warp and ``bottomup_generate_tag_ind``), its targets rendered on the
    card by ``build_bottomup_preprocess`` against the host
    ``bottomup_generate_target`` on the same warped keypoints, within
    ``BU_TARGET_ATOL``; the tag indices equal. Also times both per batch."""
    transforms, sigma = swap_bottomup_target_transform(args.train_transforms)
    np.random.seed(SEED)
    dataset = create_dataset(args.train_root, args.train_label,
                             dataset_format=args.dataset_format, is_train=True,
                             config=args.dataset_setting)
    loader = create_pipeline(dataset, transforms, method="bottomup", batch_size=args.batch_size,
                             is_train=True, normalize=False, config=args.dataset_setting,
                             num_workers=args.num_parallel_workers, seed=SEED,
                             final_columns=BOTTOMUP_DEVICE_FINAL_COLUMNS)
    batch = first_batch(loader)
    preprocess = build_bottomup_preprocess(args.dataset_setting["heatmap_sizes"],
                                           args.normalize_mean, args.normalize_std, sigma=sigma)
    inputs = [torch.from_numpy(batch[c]).to(device) for c in BOTTOMUP_DEVICE_FINAL_COLUMNS]
    target = preprocess(*inputs)[1].cpu()
    device_ms = time_ms(lambda: preprocess(*inputs), queued=False, iters=5, repeats=3)
    kwargs = next(next(iter(t.values())) for t in args.train_transforms
                  if isinstance(t, dict) and "bottomup_generate_target" in t)
    host = entrypoint("transform", "bottomup_generate_target")(
        is_train=True, config=args.dataset_setting, **kwargs)
    start = time.perf_counter()
    want = [host({"keypoints": k}) for k in batch["keypoints"]]
    host_ms = (time.perf_counter() - start) * 1e3
    err = max(float(np.abs(target[i].numpy() - w["target"].transpose(0, 3, 1, 2)).max())
              for i, w in enumerate(want))
    tags_equal = all(np.array_equal(w["tag_ind"], batch["tag_ind"][i])
                     for i, w in enumerate(want))
    peak = float(target.max())
    print(f"bottom-up device targets [{', '.join(map(str, target.shape))}] against the host "
          f"bottomup_generate_target on the same warped keypoints: max |diff| {err:.3e} (bound "
          f"{BU_TARGET_ATOL}), largest value {peak:.6f}; tag indices equal: {tags_equal}; the "
          f"device preprocess {device_ms:.3f} ms per batch of {len(want)} (CUDA events, calls "
          f"back to back), the host targets {host_ms:.1f} ms on one thread")
    if err > BU_TARGET_ATOL or not tags_equal or not peak > 0.9:
        raise AssertionError("the bottom-up device targets differ from the host's")
    return {"max_abs_err": err, "device_ms": device_ms, "host_ms": host_ms}


def bottomup_training(root: str, device: torch.device) -> dict:
    """Phase 19: (a) the reduced net's step on the card against the CPU;
    (b) higher_hrnet_w32_tpu.yaml through the train entry, host targets, 8
    loader threads, random weights, its last checkpoint through the eval
    entry with the callback's last persons and stats; (c) the same with
    ``device_pipeline: true``, its device targets against the host's."""
    step = compare_bottomup_train_with_cpu(root, device)
    data = write_synthetic_coco(os.path.join(root, "bottomup_train"), BU_TRAIN_IMAGES,
                                BU_TRAIN_VAL_IMAGES, BU_TRAIN_PEOPLE)
    args = bottomup_train_args(root, data, device, "bottomup_entry")
    host = train_bottomup(args, device, "bottom-up entry, host targets")
    check_bottomup_checkpoint(root, args, host, device)
    args = bottomup_train_args(root, data, device, "bottomup_entry_device", "device_pipeline=True")
    targets = check_device_targets(args, device)
    on_device = train_bottomup(args, device, "bottom-up entry, device_pipeline: true")
    return {"step": step, "host": host, "device": on_device, "targets": targets,
            "launches": host["launches"] + on_device["launches"]}


def check_bottomup_checkpoint(root: str, args: Config, host: dict, device: torch.device) -> None:
    """Phase 19 (b): the run's last checkpoint holds the trained net, and
    through the eval entry gives the callback's last persons and stats; the
    callback evaluated in eval mode the net each step left in train mode."""
    with recording_entry(eval_entry) as evaluated:
        stats = evaluate(Config(**dict(vars(args), ckpt=host["ckpt"],
                                       result_path=os.path.join(root, "bottomup_entry.json"))),
                         device=device)
    same = compare_callback_with_eval_entry(host["seen"], evaluated, load_checkpoint(host["ckpt"]))
    worst = max(abs(float(stats[k]) - host["stats"][k]) for k in host["stats"])
    print(f"bottom-up entry's last checkpoint through the eval entry: "
          f"{json.dumps({k: float(v) for k, v in stats.items()})}; max |diff| against the "
          f"callback's {worst:.2e} (tolerance {ENTRY_STATS_ATOL}); the checkpoint holds the "
          f"trained net bit for bit; {same['evaluations']} evaluations, each after a train-mode "
          f"step, in eval mode; the callback's last pass {same['persons']} persons, the eval "
          f"entry's within {same['pred_err']:.3e} (keypoints) and {same['score_err']:.3e} "
          f"(scores), tolerance {BU_ENTRY_PERSON_ATOL}")
    if worst > ENTRY_STATS_ATOL:
        raise AssertionError("the bottom-up last checkpoint's stats differ from the callback's")
    if not same["persons"] or max(same["pred_err"], same["score_err"]) > BU_ENTRY_PERSON_ATOL:
        raise AssertionError("the bottom-up last checkpoint's persons differ from the callback's")


def random_vit_backbone(arch: str, image_size) -> nn.Module:
    """A ViT backbone at ``image_size`` ([W, H]) with weights from a numpy
    seed: kernels with variance 1 / fan_in, LayerNorm scales in [0.5, 1.5],
    biases 0.1 sd, the position grid 0.02 sd. On the CPU."""
    backbone = create_backbone(arch, image_size=image_size)
    rng = np.random.RandomState(SEED + 30)
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            if name == "pos_embed":
                w = 0.02 * rng.standard_normal(p.shape)
            elif p.dim() >= 2:
                w = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
            elif name.endswith("weight"):
                w = rng.uniform(0.5, 1.5, p.shape)
            else:
                w = 0.1 * rng.standard_normal(p.shape)
            p.copy_(torch.from_numpy(w.astype(np.float32)))
    return backbone


def vitpose_training(root: str, data: dict, device: torch.device) -> dict:
    """Phase 20: vitpose_b_tpu.yaml through the train, eval and serving entries.

    The yaml as parsed (ViT-B/16 at full width, 256x192, O2, batch 128,
    adamw with weight decay 0.1, host targets) on phase 12's synthetic COCO,
    overridden: the data paths, ``num_epochs``, ``warmup``, ``val_interval``
    (one evaluation, after the last epoch), ``ckpt_save_dir``, and
    ``backbone_pretrained`` with ``backbone_ckpt_url`` naming a port file of
    a ViT-B saved at 224x224, whose 14x14 position grid is resized on load.
    It holds: every backbone tensor loaded, finite losses, the last epoch's
    below the first's, one decode launch per val batch, every train forward
    in train mode and each evaluation in eval mode, the last checkpoint the
    trained net bit for bit; that checkpoint through the eval entry giving
    the callback's keypoints (within ``BU_ENTRY_PERSON_ATOL``) and stats
    (within ``ENTRY_STATS_ATOL``), one decode launch per eval batch; and
    through the serving entry (``serve_checkpoint``: 1, 5 and 40 boxes, one
    decode launch per 32-crop chunk, the card against the CPU at phase 5's
    tolerance, keypoints within ``EVAL_XY_ATOL`` px).
    """
    backbone_path = os.path.join(root, "vit_b_224.ckpt")
    backbone = random_vit_backbone("vit_b", VIT_PRETRAINED_SIZE)
    save_checkpoint(backbone_path, backbone)
    want_tensors = 5 + VIT_LEAVES_PER_BLOCK * backbone.depth  # patch 2, grid 1, norm 2
    del backbone
    ckpt_dir = os.path.join(root, "vitpose_b")
    args = recipe_args(VITPOSE_YAML["b"], data, ckpt_dir, device, f"num_epochs={VIT_EPOCHS}",
                       f"warmup={ENTRY_WARMUP}", f"val_interval={VIT_EPOCHS}",
                       "backbone_pretrained=True", f"backbone_ckpt_url={backbone_path}")
    run = train_recipe(args, "vitpose_b_tpu")
    result, seen = run["result"], run["seen"]
    print(f"vitpose_b_tpu: {result['pretrained_tensors']} backbone tensors loaded from a "
          f"ViT-B saved at {VIT_PRETRAINED_SIZE[1]}x{VIT_PRETRAINED_SIZE[0]} (its 14x14 position "
          f"grid resized onto {seen['net'].backbone.grid[0]}x{seen['net'].backbone.grid[1]}), "
          f"of {want_tensors}")
    if result["pretrained_tensors"] != want_tensors:
        raise AssertionError("the pretrained backbone did not load every tensor")
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    print(f"vitpose_b_tpu: {run['evaluations']} evaluation(s) of {val_batches} batch(es), "
          f"decode kernel launches {run['launches']}; stats {json.dumps(run['stats'])}")
    if run["launches"] != run["evaluations"] * val_batches or not run["evaluations"]:
        raise AssertionError(f"{run['evaluations']} evaluations of {val_batches} batches made "
                             f"{run['launches']} decode launches")

    last_path = os.path.join(ckpt_dir, "vitpose_b_tpu_last.ckpt")
    evaluated = eval_recipe_checkpoint(root, args, run, last_path, device, "vitpose_b_tpu")
    if evaluated["launches"] != val_batches:
        raise AssertionError(f"{val_batches} eval batches made {evaluated['launches']} decode "
                             "launches")
    del run["seen"], seen
    torch.cuda.empty_cache()

    threads_before = set(threading.enumerate())
    # the card's back-projection multiplies by the float reciprocal of 48
    # where the CPU divides (csrc/decode.cu), so x and y may differ in their
    # last bits (6.1e-5 px at 640); phase 5's net happens to land where none do
    served = serve_checkpoint(VITPOSE_YAML["b"], last_path, "phase 20's checkpoint", device,
                              xy_atol=EVAL_XY_ATOL)
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"the ViTPose serving phase left threads running: {left}")
    return {"launches": run["launches"], "eval_launches": evaluated["launches"],
            "serve_launches": served["launches"], "latency_ms": served["latency_ms"],
            "images_per_sec": run["images_per_sec"], "step_median_ms": run["step_median_ms"],
            "peak_bytes": run["peak_bytes"], "stats": run["stats"]}


def check_recipe_checkpoint(name: str, recipe: str, args: Config, last_path: str, stats: dict,
                            val_batches: int, root: str, device: torch.device) -> dict:
    """A recipe's last checkpoint through the eval entry (the callback's stats
    within ``ENTRY_STATS_ATOL``, one decode launch per batch) and the serving
    entry (a 40-box request, checked as phase 4 checks it, one decode launch
    per 32-crop chunk); both load the file strictly into an unsharded net."""
    image, requests, payloads, _ = request_payloads(SEED + 21)
    argmax_shift_decode.launches = 0
    got = evaluate(Config(**dict(vars(args), ckpt=last_path,
                                 result_path=os.path.join(root, f"{name}_entry.json"))),
                   device=device)
    eval_launches = argmax_shift_decode.launches
    worst = max(abs(float(got[k]) - stats[k]) for k in stats)
    serve_args = serve_entry.parse_serve_args(["--config", recipe, "--ckpt", last_path,
                                               "--batch-size", str(BATCH_SIZE)])
    service = serve_entry.build_service(serve_args, batch_size=BATCH_SIZE, device=device)
    try:
        service.predict(payloads[-1])  # warm-up
        torch.cuda.synchronize()
        argmax_shift_decode.launches = 0
        start = time.perf_counter()
        answer = service.predict(payloads[-1])
        serve_ms = (time.perf_counter() - start) * 1e3
        serve_launches = argmax_shift_decode.launches
    finally:
        service.close()
    check_preds(np.asarray(answer["predictions"], np.float32), requests[-1])
    print(f"{name}'s last checkpoint: through the eval entry max |diff| against the "
          f"callback's stats {worst:.2e} (tolerance {ENTRY_STATS_ATOL}), decode kernel "
          f"launches {eval_launches}; through the serving entry a 40-box request in "
          f"{serve_ms:.3f} ms (warm, one run; the service's latency_ms "
          f"{answer['latency_ms']:.3f}), decode kernel launches {serve_launches}")
    if worst > ENTRY_STATS_ATOL:
        raise AssertionError(f"{name}'s last checkpoint's stats differ from the callback's")
    if eval_launches != val_batches or serve_launches != -(-40 // BATCH_SIZE):
        raise AssertionError(f"{name}: {eval_launches} decode launches for {val_batches} "
                             f"eval batches, {serve_launches} for 40 boxes")
    del service
    torch.cuda.empty_cache()
    return {"eval_launches": eval_launches, "serve_launches": serve_launches,
            "serve_40_ms": serve_ms}


def vitpose_recipes(root: str, data: dict, device: torch.device) -> dict:
    """Phase 21: vitpose_s_tpu.yaml and vitpose_l_tpu.yaml (layer decay 0.8,
    batch 64) through the train entry as parsed, random weights, on
    ``data`` (64 synthetic frames) for 2 epochs, evaluating after the last on
    16 frames; overridden: the data paths, ``num_epochs``, ``warmup``,
    ``val_interval`` and ``ckpt_save_dir``. Per recipe: img/s of epoch 2, the
    step median, the peak memory; it holds finite losses and one decode
    launch per val batch. Then each last checkpoint through the eval and
    serving entries (``check_recipe_checkpoint``). vitpose_h_tpu.yaml trains
    in phase 27, sharded."""
    out = {}
    for arch in ("s", "l"):
        name = f"vitpose_{arch}_tpu"
        ckpt_dir = os.path.join(root, name)
        args = recipe_args(VITPOSE_YAML[arch], data, ckpt_dir, device,
                           f"num_epochs={VIT_SMALL_EPOCHS}", f"warmup={VIT_SMALL_WARMUP}",
                           f"val_interval={VIT_SMALL_EPOCHS}")
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
        losses = [e["loss"] for e in epochs]
        val_batches = -(-VIT_SMALL_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
        evals = [e for e in epochs if e["metrics"]]
        print(f"{name} ({args.backbone_name}, {args.amp_level}, batch {args.batch_size}, "
              f"grad_accum_steps {getattr(args, 'grad_accum_steps', 1)}, parallel_mode "
              f"{getattr(args, 'parallel_mode', 'data')}, optimizer_setting "
              f"{args.optimizer_setting}): epoch 2 {rate:.1f} img/s with the loader feeding the "
              f"step, step median {epochs[-1]['step_median_s'] * 1e3:.1f} ms; {result['step']} "
              f"steps and the evaluation in {train_s:.1f} s; peak "
              f"torch.cuda.max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); losses "
              f"{losses}; decode kernel launches {launches}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}'s losses are not finite: {losses}")
        if launches != len(evals) * val_batches or not evals:
            raise AssertionError(f"{len(evals)} evaluations of {val_batches} batches made "
                                 f"{launches} decode launches")
        stats = {k: float(v) for k, v in evals[-1]["metrics"].items()}
        torch.cuda.empty_cache()
        checked = check_recipe_checkpoint(name, VITPOSE_YAML[arch], args,
                                          os.path.join(ckpt_dir, f"{name}_last.ckpt"), stats,
                                          val_batches, root, device)
        out[name] = {"launches": launches, "images_per_sec": rate, "peak_bytes": peak,
                     "step_median_ms": epochs[-1]["step_median_s"] * 1e3, **checked}
    return out


def first_batch(loader) -> dict:
    """``loader``'s first batch. Its producer thread makes the next batches
    ahead and, once the iteration is closed, stops after the batch it is
    making: it is waited for here, so that the draws of that batch's train
    augmentations from numpy's global stream end here and not inside a run
    that seeds the stream after this."""
    before = set(threading.enumerate())
    batches = iter(loader)
    batch = next(batches)
    batches.close()
    for thread in set(threading.enumerate()) - before:
        if thread.name == "loader-prefetch":
            thread.join()
    return batch


def check_topdown_device_targets(args: Config, device: torch.device) -> dict:
    """Phases 22-23: one batch of the ``device_pipeline: true`` loader (the
    host stops at the affine crop), its targets rendered on the card by
    ``build_topdown_preprocess`` against the recipe's host target transform
    on the same warped keypoints: the weights bit for bit; SimCC's labels
    within ``SIMCC_TARGET_RTOL`` of each label, the regression targets bit for
    bit. Also times both per batch."""
    transforms, target_kwargs = strip_host_target_transform(args.train_transforms)
    np.random.seed(SEED)
    dataset = create_dataset(args.train_root, args.train_label,
                             dataset_format=args.dataset_format, is_train=True,
                             config=args.dataset_setting)
    loader = create_pipeline(dataset, transforms, method="topdown", batch_size=args.batch_size,
                             is_train=True, normalize=False, config=args.dataset_setting,
                             num_workers=args.num_parallel_workers, seed=SEED,
                             final_columns=["image", "keypoints"])
    batch = first_batch(loader)
    preprocess = build_topdown_preprocess(
        args.dataset_setting["image_size"], args.dataset_setting["heatmap_size"],
        args.normalize_mean, args.normalize_std, **target_kwargs)
    inputs = [torch.from_numpy(batch[c]).to(device) for c in ("image", "keypoints")]
    _, target, weight = (t.cpu() for t in preprocess(*inputs))
    device_ms = time_ms(lambda: preprocess(*inputs), queued=False, iters=5, repeats=3)
    name = kwargs = None
    for t in args.train_transforms:  # the host target transform the loader left out
        if (t if isinstance(t, str) else next(iter(t))).endswith("_target"):
            name, kwargs = (t, {}) if isinstance(t, str) else next(iter(t.items()))
    host = entrypoint("transform", name)(is_train=True, config=args.dataset_setting,
                                         **(kwargs or {}))
    start = time.perf_counter()
    want = [host.transform({"keypoints": k}) for k in batch["keypoints"]]
    host_ms = (time.perf_counter() - start) * 1e3
    want_t = np.stack([w["target"] for w in want])
    want_w = np.stack([w["target_weight"] for w in want])
    err = float(np.abs(target.numpy() - want_t).max())
    rel = float((np.abs(target.numpy() - want_t) / np.maximum(np.abs(want_t), 1e-30)).max())
    weights_equal = np.array_equal(weight.numpy(), want_w)
    exact = np.array_equal(target.numpy(), want_t)
    print(f"{name} on the card [{', '.join(map(str, target.shape))}] against the host "
          f"transform on the same warped keypoints: max |diff| {err:.3e}, max relative "
          f"{rel:.3e}, bit for bit {exact}; weights equal {weights_equal} ({int(want_w.sum())} of "
          f"{want_w.size} joints weighted); the device preprocess {device_ms:.3f} ms per batch of "
          f"{len(want)} (CUDA events, calls back to back), the host targets {host_ms:.1f} ms on "
          f"one thread")
    simcc = target_kwargs.get("target_type") == "simcc"
    if not weights_equal or not want_w.sum() or (rel > SIMCC_TARGET_RTOL if simcc else not exact):
        raise AssertionError(f"{name}: the device targets differ from the host transform's")
    return {"max_abs_err": err, "device_ms": device_ms, "host_ms": host_ms}


def compare_family_with_cpu(predictor: TopDownPredictor, cpu_predictor: TopDownPredictor, image,
                            boxes, answers, regression: bool) -> dict:
    """Phases 22-23: the 5-box request on the card against the CPU, at the
    precision the predictor serves in (TF32 off). The head's outputs within
    ``HEATMAP_RTOL`` of their largest value. SimCC: every joint whose top two
    logits on both axes lead by more than twice that decodes to the same
    bins, so within ``EVAL_XY_ATOL`` px; each score (the softmax peak) within
    4 times the logits' bound of the largest. Regression: each joint within
    ``EVAL_XY_ATOL`` px plus twice ``mu``'s bound times its crop's size in
    pixels (``mu`` is in crop units); each score (1 - mean sigma) within
    sigma's bound."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if any(tf32):
        raise AssertionError("the predictor did not serve in full float32")
    with torch.inference_mode():
        x_gpu, _, _ = predictor.preprocess(image, boxes)
        x_cpu, _, _ = cpu_predictor.preprocess(image, boxes)
        out_gpu = [t.cpu() for t in predictor.net(x_gpu)]
        out_cpu = list(cpu_predictor.net(x_cpu))
    tols = [HEATMAP_RTOL * float(c.abs().max()) for c in out_cpu]
    errs = [float((g - c).abs().max()) for g, c in zip(out_gpu, out_cpu)]
    names = ("mu", "sigma") if regression else ("x logits", "y logits")
    print("card-vs-CPU head outputs: " + "; ".join(
        f"{n} max |diff| {e:.3e}, tolerance {t:.3e}" for n, e, t in zip(names, errs, tols)))
    if any(e > t for e, t in zip(errs, tols)):
        raise AssertionError("GPU and CPU head outputs disagree beyond the tolerance")
    preds_gpu, preds_cpu = answers
    xy_err = np.abs(preds_gpu[..., :2] - preds_cpu[..., :2]).max(-1)
    score_err = float(np.abs(preds_gpu[..., 2] - preds_cpu[..., 2]).max())
    if regression:
        sides = np.array([cpu_predictor.pixel_std * max(
            box_to_center_scale(b, cpu_predictor.image_size, cpu_predictor.pixel_std,
                                cpu_predictor.scale_padding)[1]) for b in boxes])
        bound = EVAL_XY_ATOL + 2 * tols[0] * sides[:, None]
        qualified = np.ones_like(xy_err, bool)
        score_tol = tols[1]
    else:
        gap = None
        for c in out_cpu:
            top2 = torch.topk(c, 2, dim=-1).values
            g = ((top2[..., 0] - top2[..., 1]) > 2 * max(tols)).numpy()
            gap = g if gap is None else gap & g
        qualified = gap
        bound = np.full_like(xy_err, EVAL_XY_ATOL)
        score_tol = 4 * max(tols) * float(np.abs(preds_cpu[..., 2]).max())
    same = xy_err <= bound
    print(f"card-vs-CPU keypoints: {int(qualified.sum())} of {qualified.size} joints qualified; "
          f"{int(same[qualified].sum())} of them within their bound (max |diff| "
          f"{float(xy_err[qualified].max()):.3e} px, smallest bound {float(bound.min()):.3e}); "
          f"scores max |diff| {score_err:.3e} (tolerance {score_tol:.3e})")
    if not qualified.any() or not same[qualified].all():
        raise AssertionError("keypoints differ beyond their bound")
    if score_err > score_tol:
        raise AssertionError(f"scores differ by {score_err}")
    return {"xy_err": float(xy_err[qualified].max()), "score_err": score_err}


def serve_family(recipe: str, ckpt: str, device: torch.device, regression: bool) -> dict:
    """Phases 22-23: ``recipe`` with ``ckpt`` through the serving entry over
    HTTP on 127.0.0.1: ``GET /healthz``, then 1, 5 and 40 boxes (no decode
    launch: the family decodes with plain PyTorch), each timed over
    ``REPEATS`` runs; the 5-box answer against the same service on the CPU
    (``compare_family_with_cpu``). No thread of the phase is left."""
    threads_before = set(threading.enumerate())
    image, requests, payloads, _ = request_payloads(SEED + 22)
    name = os.path.basename(recipe)
    args = serve_entry.parse_serve_args(["--config", recipe, "--ckpt", ckpt,
                                         "--batch-size", str(BATCH_SIZE)])
    service = serve_entry.build_service(args, batch_size=args.batch_size, device=device)
    http = HttpService(service)
    try:
        with urllib.request.urlopen(http.url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health != {"status": "ok", "mode": "topdown", "num_joints": 17}:
            raise AssertionError(f"unexpected /healthz answer {health}")
        post(http.url + "/predict", payloads[-1])  # warm-up
        torch.cuda.synchronize()
        argmax_shift_decode.launches = 0
        answers = []
        for payload, boxes in zip(payloads, requests):
            preds = np.asarray(post(http.url + "/predict", payload)["predictions"], np.float32)
            check_preds(preds, boxes, in_window=not regression)
            answers.append(preds)
        launches = argmax_shift_decode.launches
        print(f"serving entry, {name}: GET /healthz {health}; decode kernel launches {launches} "
              f"for requests of {[len(b) for b in requests]} boxes")
        if launches:
            raise AssertionError(f"{name} served through the heatmap decode kernel")
        medians = time_requests(http.url, payloads, requests)
    finally:
        http.close()
    cpu_service = serve_entry.build_service(args, batch_size=args.batch_size,
                                            device=torch.device("cpu"))
    cpu_answer = np.asarray(cpu_service.predict(payloads[1])["predictions"], np.float32)
    cpu_service.close()
    compared = compare_family_with_cpu(service.predictor, cpu_service.predictor, image,
                                       requests[1], (answers[1], cpu_answer), regression)
    left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
    if left:
        raise AssertionError(f"the serving phase left threads running: {left}")
    return {"latency_ms": medians, **compared}


def compare_rle_step_with_cpu(device: torch.device) -> dict:
    """Phase 23: one step of resnet50_rle_tpu.yaml's net, loss and optimizer
    at full width (ResNet-50 + ``rle_head``), batch ``TRAIN_CPU_BATCH``,
    float64, the yaml's lr held constant, on the card and on the port on the
    CPU from the same weights (``random_weights_``, the head's Linear layers
    then drawn at 1/sqrt(fan-in) so that ``mu`` and ``sigma`` sit in the
    range a trained head gives): the loss, every gradient and every
    BatchNorm running statistic within ``TRAIN_F64_RTOL`` of each tensor's
    largest, as phase 11 holds HRNet. Also prints the update's largest
    card-CPU difference in units of lr."""
    cpu = torch.device("cpu")
    args = train_entry.parse_train_args(["--config", RLE_YAML])
    w, h = args.dataset_setting["image_size"]
    rng = np.random.RandomState(SEED + 23)
    image = torch.from_numpy(rng.standard_normal((TRAIN_CPU_BATCH, 3, h, w)))
    target = torch.from_numpy(rng.uniform(0, 1, (TRAIN_CPU_BATCH, args.num_joints, 2)))
    weight = torch.from_numpy(
        (rng.uniform(0, 1, (TRAIN_CPU_BATCH, args.num_joints)) < 0.8).astype(np.float64))
    net = create_network(args.backbone_name, args.head_name, num_joints=args.num_joints,
                         backbone_args=args.backbone_setting, head_args=args.head_setting)
    random_weights_(net, device)
    with torch.no_grad():
        for layer in (net.head.fc_coord, net.head.fc_sigma):
            fan_in = layer.weight.shape[1]
            layer.weight.copy_(torch.from_numpy(
                rng.standard_normal(tuple(layer.weight.shape)) / np.sqrt(fan_in)))
            layer.bias.zero_()
    net.double()
    runs = {}
    for side, side_net, dev in (("gpu", net, device), ("cpu", copy.deepcopy(net).cpu(), cpu)):
        optimizer = create_optimizer(side_net, args.optimizer, learning_rate=args.lr,
                                     weight_decay=args.weight_decay,
                                     filter_bias_and_bn=args.filter_bias_and_bn,
                                     **args.optimizer_setting)
        step = build_train_step(create_network_with_loss(
            side_net, create_loss(args.loss, **args.loss_setting),
            has_extra_inputs=args.loss_with_extra_input), optimizer)
        start = {k: p.detach().to("cpu", copy=True) for k, p in side_net.named_parameters()}
        loss = step(image.to(dev), target.to(dev), weight.to(dev))
        grads, stats = _grads_and_stats(side_net)
        moved = {k: p.detach().cpu() - start[k] for k, p in side_net.named_parameters()}
        runs[side] = (loss.cpu(), grads, stats, moved)
        del step, optimizer
    del net
    torch.cuda.empty_cache()
    gpu, on_cpu = runs["gpu"], runs["cpu"]
    loss_err = float(((gpu[0] - on_cpu[0]).abs() / on_cpu[0].abs()).max())
    grads, stats = _errors(gpu[1], on_cpu[1]), _errors(gpu[2], on_cpu[2])
    update_lr = max(float((gpu[3][k] - on_cpu[3][k]).abs().max()) for k in gpu[3]) / args.lr
    print(f"phase 23 RLE step card-vs-CPU, float64, batch {TRAIN_CPU_BATCH}, lr {args.lr} "
          f"constant: loss {gpu[0].tolist()} against the CPU's {on_cpu[0].tolist()} "
          f"({loss_err:.3e}); {len(grads)} gradients {_summary(grads)}; {len(stats)} running "
          f"statistics {max(stats.values()):.3e} (bound {TRAIN_F64_RTOL} each); the update's "
          f"largest card-CPU difference {update_lr:.3e} lr")
    if max(loss_err, max(grads.values()), max(stats.values())) > TRAIN_F64_RTOL:
        raise AssertionError("phase 23: the card's float64 RLE step disagrees with the CPU's")
    return {"loss_rel_err": loss_err, "grad_rel_err": max(grads.values()),
            "stats_rel_err": max(stats.values()), "update_max_lr": update_lr}


def family_training(root: str, data: dict, device: torch.device, recipe: str) -> dict:
    """Phase 22 (``SIMCC_YAML``) or 23 (``RLE_YAML``): the recipe as parsed
    (ResNet-50 at 256x192, O2, batch 128, adamw, host targets) through the
    train entry on phase 12's data, evaluating after the last epoch (hflip
    TTA on); the last checkpoint through the eval entry; one batch of device
    targets against the host's, then a run with ``device_pipeline: true``;
    the serving entry. No decode launch anywhere: SimCC and RLE decode with
    plain PyTorch, as the JAX package decodes them with plain XLA.

    Phase 23 first holds one float64 step on the card against the CPU
    (``compare_rle_step_with_cpu``), then trains with ``RLE_WORKERS`` loader
    worker and cuDNN's deterministic algorithms (the previous setting
    restored after the phase): with more workers the threads draw the
    augmentations from numpy's global stream in the order they reach it, as
    the JAX package's loader does, so no two runs train on the same batches
    (tests/test_torch_loader_threads.py), and RLE's first 20 steps at the
    full lr once rose instead of falling (``RLE_WORKERS``). Both runs then
    train on the same batches, so their per-step losses must be equal."""
    name = os.path.splitext(os.path.basename(recipe))[0]
    regression = recipe == RLE_YAML
    options = (f"num_parallel_workers={RLE_WORKERS}",) if regression else ()
    ckpt_dir = os.path.join(root, name)
    deterministic = torch.backends.cudnn.deterministic
    try:
        step = compare_rle_step_with_cpu(device) if regression else None
        torch.backends.cudnn.deterministic = deterministic or regression
        args = recipe_args(recipe, data, ckpt_dir, device, f"num_epochs={FAMILY_EPOCHS}",
                           f"warmup={ENTRY_WARMUP}", f"val_interval={FAMILY_EPOCHS}", *options)
        host = train_recipe(args, name)
        val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
        print(f"{name}: {host['evaluations']} evaluation(s) of {val_batches} batch(es), hflip "
              f"TTA {args.eval_setting['hflip_tta']}; stats {json.dumps(host['stats'])}")
        if host["launches"] or host["evaluations"] != 1 or not host["stats"]["AP"] >= 0:
            raise AssertionError(f"{name}: {host['evaluations']} evaluations, "
                                 f"{host['launches']} decode launches")
        last = os.path.join(ckpt_dir, f"{name}_last.ckpt")
        evaluated = eval_recipe_checkpoint(root, args, host, last, device, name)
        del host["seen"]
        torch.cuda.empty_cache()

        device_args = recipe_args(recipe, data, os.path.join(root, f"{name}_device"), device,
                                  f"num_epochs={FAMILY_DEVICE_EPOCHS}", f"warmup={ENTRY_WARMUP}",
                                  "val_while_train=False", "device_pipeline=True", *options)
        targets = check_topdown_device_targets(device_args, device)
        on_device = train_recipe(device_args, f"{name}, device_pipeline: true")
        del on_device["seen"]
        torch.cuda.empty_cache()
        if regression:
            same = on_device["step_losses"] == host["step_losses"]
            print(f"{name}: {RLE_WORKERS} loader worker, cuDNN's deterministic algorithms; the "
                  f"device_pipeline run's {len(on_device['step_losses'])} per-step losses equal "
                  f"to the host run's: {same}")
            if not same:
                raise AssertionError(f"{name}: the two runs' per-step losses differ on the same "
                                     "batches")
        served = serve_family(recipe, last, device, regression)
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {"host": host, "device": on_device, "targets": targets, "eval": evaluated,
            "served": served, "step": step}


def mpii_decode_bound_ms(n: int) -> float:
    """argmax_shift_decode's least time at MPII's [n, 16, 64, 64]: one read of
    the float32 heatmaps and one write of the coordinates and maxima."""
    k, h, w = MPII_HEATMAP
    return 4 * (n * k * h * w + n * k * 3) / HBM_BYTES_PER_MS


def mpii_decode(device: torch.device) -> dict:
    """Phase 24, the decode kernel at MPII's heatmaps [N, 16, 64, 64] (a
    4096-float row: two passes of the vector loads), shift on as the yaml
    sets it: both wrappers bitwise against their plain versions at N = 32
    and 128, on random heatmaps and on exact ties, the whole decoder with its
    back-projection on; then the kernel's device time warm and cold in L2,
    the whole decoder's, the plain version's, and ``torch.max(x.view(N*K,
    H*W), dim=1)`` as the library call, beside the bound."""
    rng = np.random.RandomState(SEED + 24)
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    pixel_std = 200.0
    kw = dict(shift=True, to_original=True, use_udp=False, pixel_std=pixel_std)
    out = {"max_abs_err": 0.0}
    for n in (BATCH_SIZE, 128):
        shape = (n,) + MPII_HEATMAP
        for label, hm in (("random", rng.randn(*shape)), ("exact ties", rng.randint(0, 3, shape))):
            x = on_device(hm, device)
            crops = crop_inputs(rng, n, device)
            runs = [("argmax_shift_decode", argmax_shift_decode(x, True),
                     argmax_shift_decode_plain(x, True)),
                    ("decode_heatmap", decode_heatmap(x, *crops, **kw),
                     decode_heatmap_plain(x, *crops, **kw))]
            torch.cuda.synchronize()
            for what, got, want in runs:
                equal = all(bitwise_equal(g, w) for g, w in zip(got, want))
                for g, w in zip(got, want):
                    out["max_abs_err"] = max(out["max_abs_err"], float((g - w).abs().max()))
                print(f"decode [{', '.join(map(str, shape))}] {label}, shift on, {what}"
                      f"{', back-projection on' if what == 'decode_heatmap' else ''}: bitwise "
                      f"equal {equal}")
                if not equal:
                    raise AssertionError(f"decode kernel ({what}) differs from the plain version "
                                         f"at {shape}, {label}")
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
        crops = crop_inputs(rng, n, device)
        cold = [torch.randn(shape, generator=gen, device=device) for _ in range(COLD_HEATMAPS)]
        warm = time_ms(lambda: argmax_shift_decode(x, True), True)
        cold_ms = time_ms(cycling(lambda h: argmax_shift_decode(h, True), cold), True)
        plain = time_ms(lambda: argmax_shift_decode_plain(x, True), True, iters=PLAIN_ITERS)
        decoder = time_ms(lambda: decode_heatmap(x, *crops, **kw), True)
        library = time_ms(lambda: torch.max(x.view(n * MPII_HEATMAP[0], -1), dim=1), True)
        bound = mpii_decode_bound_ms(n)
        print(f"decode [{', '.join(map(str, shape))}] shift on, device time: kernel {warm:.5f} ms "
              f"warm in L2, {cold_ms:.5f} ms cold ({COLD_HEATMAPS} heatmaps, "
              f"{COLD_HEATMAPS * x.numel() * 4 / 1e6:.1f} MB in turn); the whole decoder "
              f"(back-projection on) {decoder:.5f} ms; plain argmax + shift {plain:.5f} ms; "
              f"library call torch.max(x.view(N*K, H*W), dim=1) {library:.5f} ms; bound "
              f"{bound:.5f} ms (HBM bytes): kernel at {bound / warm:.3f} of it warm, "
              f"{bound / cold_ms:.3f} cold")
        out[n] = {"ms": warm, "cold_ms": cold_ms, "decoder_ms": decoder, "plain_ms": plain,
                  "library_ms": library, "bound_ms": bound}
        del cold
    return out


def mpii_training(root: str, device: torch.device) -> dict:
    """Phase 24: hrnet_w32_mpii_tpu.yaml as parsed (HRNet-W32 at 256x256, 16
    joints, O2, batch 128, adamw, host targets; the decode's shift on;
    ``topdown_keypoint`` with PCKh and EPE) through the train entry on
    synthetic MPII frames, evaluating after the last epoch: one decode launch
    per eval batch; its last checkpoint through the eval entry (the
    callback's PCKh and EPE, one launch per batch) and a 40-box request
    through the serving entry (one launch per 32-crop chunk)."""
    data = {"train": mpii.write_split(os.path.join(root, "mpii", "train"), MPII_TRAIN_IMAGES,
                                      mpii.TRAIN_SEED, MPII_PEOPLE),
            "val": mpii.write_split(os.path.join(root, "mpii", "val"), MPII_VAL_IMAGES,
                                    mpii.VAL_SEED, MPII_PEOPLE)}
    name = "hrnet_w32_mpii_tpu"
    ckpt_dir = os.path.join(root, name)
    args = recipe_args(MPII_YAML, data, ckpt_dir, device, f"num_epochs={MPII_EPOCHS}",
                       f"warmup={ENTRY_WARMUP}", f"val_interval={MPII_EPOCHS}")
    trained = train_recipe(args, name)
    val_batches = -(-MPII_VAL_IMAGES * MPII_PEOPLE // args.batch_size)
    print(f"{name}: {trained['evaluations']} evaluation(s) of {val_batches} batches, decode "
          f"kernel launches {trained['launches']}; PCKh@{args.eval_setting['pck_thr']} "
          f"{trained['stats']['PCK']:.6f}, EPE {trained['stats']['EPE']:.4f} px")
    if trained["launches"] != trained["evaluations"] * val_batches or not trained["evaluations"]:
        raise AssertionError(f"{trained['evaluations']} evaluations of {val_batches} batches "
                             f"made {trained['launches']} decode launches")
    if not (0.0 <= trained["stats"]["PCK"] <= 1.0 and np.isfinite(trained["stats"]["EPE"])):
        raise AssertionError(f"{name}'s stats are out of range: {trained['stats']}")
    last = os.path.join(ckpt_dir, f"{name}_last.ckpt")
    evaluated = eval_recipe_checkpoint(root, args, trained, last, device, name)
    if evaluated["launches"] != val_batches:
        raise AssertionError(f"{val_batches} eval batches made {evaluated['launches']} decode "
                             "launches")
    del trained["seen"]
    torch.cuda.empty_cache()

    _, requests, payloads, _ = request_payloads(SEED + 24)
    serve_args = serve_entry.parse_serve_args(["--config", MPII_YAML, "--ckpt", last,
                                               "--batch-size", str(BATCH_SIZE)])
    service = serve_entry.build_service(serve_args, batch_size=BATCH_SIZE, device=device)
    try:
        service.predict(payloads[-1])  # warm-up
        torch.cuda.synchronize()
        argmax_shift_decode.launches = 0
        start = time.perf_counter()
        answer = service.predict(payloads[-1])
        serve_ms = (time.perf_counter() - start) * 1e3
        serve_launches = argmax_shift_decode.launches
    finally:
        service.close()
    check_preds(np.asarray(answer["predictions"], np.float32), requests[-1],
                num_joints=args.num_joints, dataset_setting=args.dataset_setting)
    print(f"{name} through the serving entry: a 40-box request in {serve_ms:.3f} ms (warm, one "
          f"run; the service's latency_ms {answer['latency_ms']:.3f}), {args.num_joints} joints "
          f"per box, decode kernel launches {serve_launches}")
    if serve_launches != -(-40 // BATCH_SIZE):
        raise AssertionError(f"40 boxes made {serve_launches} decode launches")
    return {"trained": trained, "eval": evaluated, "serve_ms": serve_ms,
            "launches": trained["launches"], "eval_launches": evaluated["launches"],
            "serve_launches": serve_launches}

class _FirstRecords:
    """The first ``n`` records of a dataset: a loader over it gives one batch
    of ``n`` and ends, so its random draws end with that batch."""

    def __init__(self, dataset, n: int) -> None:
        self.dataset, self.n = dataset, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        return self.dataset[i]


def check_full_mode_batch(args: Config, device: torch.device) -> dict:
    """Phase 25: the first batch of 128 records of phase 12's train split,
    with the recipe's augmentations from one seed at one worker, through the
    host pipeline (cv2 crop, host Gaussian) and through full mode (source
    patches bucketed to 64, warp matrices, keypoints); full mode's
    preprocess on the card against the host's crops (within
    ``FULL_HOST_ATOL``: cv2 4.x rounds each sample coordinate to 1/32 px and
    the result to uint8) and targets (within 1e-5), and against the same
    preprocess on the CPU (crops within ``FULL_CROP_ATOL``, targets within
    1e-5). Returns the errors and the batch's bytes in both modes."""
    dataset = create_dataset(args.train_root, args.train_label,
                             dataset_format=args.dataset_format, is_train=True,
                             config=args.dataset_setting)["dataset"]
    first = _FirstRecords(dataset, args.batch_size)
    kwargs = dict(method=args.pipeline_method, batch_size=args.batch_size, is_train=True,
                  normalize=False, config=args.dataset_setting, seed=SEED, num_workers=1)
    np.random.seed(SEED)
    (host,) = list(create_pipeline(first, args.train_transforms, **kwargs,
                                   final_columns=["image", "target", "target_weight"]))
    transforms, target_kwargs = strip_host_target_transform(args.train_transforms)
    np.random.seed(SEED)
    (full,) = list(create_pipeline(first, to_matrix_transforms(transforms), **kwargs,
                                   final_columns=DEVICE_FULL_FINAL_COLUMNS,
                                   image_bucket=FULL_BUCKET))
    preprocess = build_topdown_full_preprocess(
        image_size=args.dataset_setting["image_size"],
        heatmap_size=args.dataset_setting["heatmap_size"],
        normalize_mean=args.normalize_mean, normalize_std=args.normalize_std, **target_kwargs)
    inputs = [torch.from_numpy(full[c]) for c in DEVICE_FULL_FINAL_COLUMNS]
    on_card = [t.to(device) for t in inputs]
    gpu = [t.cpu() for t in preprocess(*on_card)]
    cpu = preprocess(*inputs)
    # the device's share of full mode: its preprocess against device_pipeline
    # true's (normalize and targets of the host's uint8 crops), and the warp alone
    w, h = args.dataset_setting["image_size"]
    crops = torch.from_numpy(host["image"]).to(device)
    encode = build_topdown_preprocess(
        image_size=args.dataset_setting["image_size"],
        heatmap_size=args.dataset_setting["heatmap_size"],
        normalize_mean=args.normalize_mean, normalize_std=args.normalize_std, **target_kwargs)
    calls = {"full": lambda: preprocess(*on_card),
             "warp": lambda: affine_warp(on_card[0], on_card[1], (h, w)),
             "true": lambda: encode(crops, on_card[2])}
    timing = {k: {"ms": time_ms(fn, queued=True, iters=10, repeats=5),
                  "ops": len(device_ops(fn))} for k, fn in calls.items()}
    print(f"full mode's preprocess of a batch of {args.batch_size} on the card: "
          f"{timing['full']['ms']:.3f} ms device time, {timing['full']['ops']} device operations "
          f"(the warp alone {timing['warp']['ms']:.3f} ms, {timing['warp']['ops']} operations); "
          f"device_pipeline true's {timing['true']['ms']:.3f} ms, {timing['true']['ops']} "
          f"operations")
    std = torch.tensor(args.normalize_std) * 255.0
    mean = torch.tensor(args.normalize_mean) * 255.0

    def pixels(crops):  # normalized NCHW -> NHWC on the 0-255 scale
        return crops.permute(0, 2, 3, 1) * std + mean

    host_target = torch.from_numpy(host["target"]).permute(0, 3, 1, 2)
    crop_err = (pixels(gpu[0]) - torch.from_numpy(host["image"]).float()).abs()
    errs = {
        "crop_vs_host": float(crop_err.max()),
        "crop_vs_host_mean": float(crop_err.mean()),
        "crop_vs_host_over_1": float((crop_err > 1.0).float().mean()),
        "target_vs_host": float((gpu[1] - host_target).abs().max()),
        "weight_vs_host": float((gpu[2] - torch.from_numpy(host["target_weight"])).abs().max()),
        "crop_vs_cpu": float((pixels(gpu[0]) - pixels(cpu[0])).abs().max()),
        "target_vs_cpu": float((gpu[1] - cpu[1]).abs().max()),
    }
    # host targets' batch: float32 crops (normalized on the host), targets, weights
    host_bytes = 4 * host["image"].size + host["target"].nbytes + host["target_weight"].nbytes
    full_bytes = sum(full[c].nbytes for c in full)
    print(f"full mode, first batch ({args.batch_size} records, frames bucketed to "
          f"{FULL_BUCKET}: {tuple(full['image'].shape)} uint8, {full_bytes} B against "
          f"{host_bytes} B of float32 crops and targets): the card's crops against the host "
          f"cv2 {cv2.__version__} crop {errs['crop_vs_host']:.4f} (tolerance "
          f"{FULL_HOST_ATOL:.4f}), mean {errs['crop_vs_host_mean']:.4f}, share over 1.0 "
          f"{errs['crop_vs_host_over_1']:.3e}; targets "
          f"{errs['target_vs_host']:.3e}, weights {errs['weight_vs_host']:.3e} (tolerance "
          f"{FULL_TARGET_ATOL}); against the CPU: crops {errs['crop_vs_cpu']:.3e} (tolerance "
          f"{FULL_CROP_ATOL}), targets {errs['target_vs_cpu']:.3e}")
    if not (errs["crop_vs_host"] <= FULL_HOST_ATOL and errs["crop_vs_cpu"] <= FULL_CROP_ATOL
            and max(errs["target_vs_host"], errs["weight_vs_host"],
                    errs["target_vs_cpu"]) <= FULL_TARGET_ATOL):
        raise AssertionError(f"full mode's first batch disagrees: {errs}")
    return dict(errs, full_batch_bytes=full_bytes, host_batch_bytes=host_bytes,
                preprocess=timing)


def check_trace(trace_dir: str, steps: range) -> dict:
    """Phase 25: the profiled run's trace: one Chrome trace file under
    ``trace_dir`` holding CUDA kernel events and the steps of ``steps`` only."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"{trace_dir} holds {files}, not one trace")
    path = os.path.join(trace_dir, files[0])
    # a scan of the text: the file holds ~1.7 million events (457 MB), which
    # json.load takes many seconds and gigabytes to build
    with open(path) as f:
        text = f.read()
    events = len(re.findall(r'"ph":\s*"', text))
    kernels = len(re.findall(r'"cat":\s*"kernel"', text))
    traced = sorted({int(n) for n in re.findall(r'"name":\s*"train step (\d+)"', text)})
    del text
    print(f"full mode's epoch-2 trace: {os.path.getsize(path)} B, {events} events, "
          f"{kernels} CUDA kernel events, train steps {traced[0] if traced else None}-"
          f"{traced[-1] if traced else None}")
    if not kernels or traced != list(steps):
        raise AssertionError(f"the trace holds {kernels} kernel events and steps {traced}, "
                             f"not epoch 2's {list(steps)}")
    return {"trace_bytes": os.path.getsize(path), "events": events, "kernels": kernels}


def convert_round_trip(root: str, args: Config, ckpt: str, device: torch.device) -> dict:
    """Phase 25: the backbone of a run's last checkpoint written as a published
    torch ``.pth`` (its torch names under ``state_dict``, with a classifier),
    through ``python3 -m mindpose_tpu_torch.tools.convert_ckpt --check`` and
    ``load_pretrained_backbone`` into a fresh net of ``args`` on the card:
    every backbone tensor equal to the checkpoint's, bit for bit."""
    state = load_checkpoint(ckpt)["net"]
    backbone = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    src = os.path.join(root, "backbone_published.pth")
    torch.save({"state_dict": dict(backbone, **{"fc.weight": torch.zeros(1000, 2048),
                                                "fc.bias": torch.zeros(1000)})}, src)
    out = os.path.join(root, "backbone_converted.pth")
    convert_ckpt.main(["--src", src, "--arch", args.backbone_name, "--out", out, "--check"])
    net = create_network(args.backbone_name, args.head_name, num_joints=args.num_joints,
                         backbone_args=args.backbone_setting,
                         head_args=args.head_setting).to(device)
    count = load_pretrained_backbone(out, net)
    loaded = net.backbone.state_dict()
    same = all(torch.equal(loaded[k].cpu(), v) for k, v in backbone.items()
               if not k.endswith("num_batches_tracked"))
    w, h = args.dataset_setting["image_size"]
    with torch.no_grad():
        heat = net.eval()(torch.zeros(1, 3, h, w, device=device))
    print(f"convert_ckpt round trip: {len(backbone)} backbone tensors of the full-mode run's "
          f"last checkpoint as a .pth, converted with --check, {count} loaded on "
          f"{next(net.parameters()).device}; equal to the checkpoint's: {same}; a forward "
          f"{tuple(heat.shape)}, finite {bool(torch.isfinite(heat).all())}")
    if not (same and count and torch.isfinite(heat).all()):
        raise AssertionError("the converted backbone did not load as it was written")
    return {"tensors": count}


def input_modes_training(root: str, data: dict, device: torch.device) -> dict:
    """Phase 25: hrnet_w32_tpu.yaml (full width, O2, batch 128, adamw) through
    the train entry on phase 12's data, 3 epochs of 10 steps each, evaluating
    after the last, in two input modes beside phase 12's host targets:
    ``device_pipeline: true``; ``device_pipeline: full`` with ``image_bucket`` 64, the decode
    cache, frame-grouped shuffling, patch-grouped batching and ``profile:
    true`` (``INPUT_MODES``). First full mode's first batch
    (``check_full_mode_batch``). Each run holds finite, falling losses, AP above 0 and one decode launch per
    val batch; the full run's epoch-2 trace holds CUDA kernels. Then a
    ``convert_ckpt`` round trip of the full run's backbone. Returns each run's
    numbers, the decode launches and the checks'."""
    base = recipe_args(RECIPE_YAML, data, os.path.join(root, "input_check"), device)
    first = check_full_mode_batch(base, device)
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // base.batch_size)
    runs, launches = {}, 0
    for mode, options in INPUT_MODES.items():  # host targets: phase 12's run
        ckpt_dir = os.path.join(root, f"input_{mode}")
        args = recipe_args(RECIPE_YAML, data, ckpt_dir, device, f"num_epochs={INPUT_EPOCHS}",
                           f"warmup={INPUT_WARMUP}", f"val_interval={INPUT_EPOCHS}", *options)
        run = train_recipe(args, f"input mode {mode}")
        epochs = run["result"]["epochs"]
        last = epochs[-1]  # the last epoch: no profiler in any mode
        cache = run["result"]["decode_cache"]
        run.update(
            batch_bytes=sum(e["batch_bytes"] for e in epochs[1:]) / sum(e["steps"]
                                                                        for e in epochs[1:]),
            last_images_per_sec=last["images_per_sec"],
            last_step_median_ms=last["step_median_s"] * 1e3,
            last_wait_per_step_ms=last["wait_total_s"] / last["steps"] * 1e3,
            cache_hit_rate=cache["hits"] / (cache["hits"] + cache["misses"]) if cache else None,
            decode_cache=cache)
        print(f"input mode {mode}: {run['batch_bytes']:.0f} B handed to the step per batch; "
              f"epoch {len(epochs)} {run['last_images_per_sec']:.1f} img/s, step median "
              f"{run['last_step_median_ms']:.1f} ms, wait {run['last_wait_per_step_ms']:.1f} "
              f"ms per step; decode cache {cache} (hit rate {run['cache_hit_rate']}); AP "
              f"{run['stats'].get('AP')}; decode launches {run['launches']}")
        if not (run["evaluations"] == 1 and run["stats"]["AP"] > 0
                and run["launches"] == val_batches):
            raise AssertionError(f"input mode {mode}: {run['evaluations']} evaluations, AP "
                                 f"{run['stats'].get('AP')}, {run['launches']} decode launches "
                                 f"for {val_batches} val batch(es)")
        if mode == "full":
            steps = epochs[0]["steps"]
            run["trace"] = check_trace(os.path.join(ckpt_dir, "trace"),
                                       range(steps, 2 * steps))
            run["converted"] = convert_round_trip(
                root, args, os.path.join(ckpt_dir, "hrnet_w32_tpu_last.ckpt"), device)
        launches += run["launches"]
        del run["seen"], run["result"]
        runs[mode] = run
        torch.cuda.empty_cache()
    return {"first_batch": first, "runs": runs, "launches": launches}



def _statistics(net: nn.Module) -> dict:
    """Each BatchNorm running mean and variance of ``net``, by state_dict name, on the host."""
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _digest(net: nn.Module) -> str:
    """sha256 of every tensor of ``net``'s state_dict, in order: equal replicas, equal digests."""
    h = hashlib.sha256()
    for value in net.state_dict().values():
        h.update(value.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def ddp_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phase 26 (a), one rank (a fresh interpreter): HRNet-W32 at full width,
    from the one process's state (``start.pt``: its BatchNorm statistics
    depend on the TF32 setting of the forward that drew them), through the
    recipe's step at O0 (float32, TF32 off, cuDNN's deterministic
    algorithms) in a gloo group on the one card, ``DDP_RANK_BATCH`` crops of
    the batch each; per step the
    loss, the running statistics and the digest of the state, and at the
    end the parameters (``ddp_rank{rank}.pt``)."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.deterministic = True  # as the one process it is held to
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    net = hrnet_w32_net().to(device)
    net.load_state_dict(torch.load(os.path.join(out_dir, "start.pt")))
    step = recipe_step(net, "O0")
    if not isinstance(step.module, nn.parallel.DistributedDataParallel):
        raise AssertionError("the step in a process group is not data-parallel")
    image, keypoints = train_batch(np.random.RandomState(SEED + 26), world * DDP_RANK_BATCH,
                                   device)
    shard = slice(rank * DDP_RANK_BATCH, (rank + 1) * DDP_RANK_BATCH)
    steps = []
    for _ in range(DDP_STEPS):
        loss = step(image[shard], keypoints[shard])
        steps.append({"loss": loss.cpu(), "stats": _statistics(net), "digest": _digest(net)})
    torch.save({"steps": steps, "params": {n: p.detach().cpu() for n, p in
                                           net.named_parameters()}},
               os.path.join(out_dir, f"ddp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def start_ddp_ranks(root: str, device: torch.device, background: Background) -> dict:
    """Phase 26 (a)'s two rank processes (``ddp_rank``), started on
    ``background`` from the state of a fresh full-width net (drawn with
    cuDNN's deterministic algorithms, ``start.pt``), which
    ``ddp_on_one_card`` then steps as the one process they are held to."""
    out_dir = os.path.join(root, "ddp_ranks")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    commands = [[sys.executable, os.path.abspath(__file__), "--ddp-rank", str(rank),
                 str(DDP_WORLD), str(port), out_dir] for rank in range(DDP_WORLD)]
    logs = [os.path.join(out_dir, f"rank{rank}.log") for rank in range(DDP_WORLD)]
    start = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = training_net(device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.save(net.state_dict(), os.path.join(out_dir, "start.pt"))  # the ranks' start
    return {"out_dir": out_dir, "net": net, "start": start,
            "future": background.submit("phase 26 (a)'s two ranks", run_processes, commands,
                                        logs, DDP_TIMEOUT_S, "phase 26 (a)")}


def ddp_on_one_card(device: torch.device, started: dict) -> dict:
    """Phase 26 (a): two ranks on the one card over gloo (``ddp_rank``),
    against one process at ``accum_steps=2`` on the same batch of
    ``DDP_WORLD * DDP_RANK_BATCH`` crops, ``DDP_STEPS`` steps each at the yaml's lr
    (constant), all with cuDNN's deterministic algorithms: otherwise two
    processes' float32 gradients of one batch differ by up to 2.6e-5 of a
    tensor's largest entry (measured), and five Adam steps of a randomly
    initialised net carry that into differences of up to 6.8e-3 in the
    parameters. The two ranks' states are bitwise equal after every step;
    the parameters agree with the one process's within 1e-5, or twice the
    summed lr where a gradient of a step was below 1e-4 of its tensor's
    largest (Adam moves such an element about lr either way with the sign
    of its float32 gradient); the running statistics follow the formula of
    tests/test_torch_ddp.py: per step, m prev + ((1 - m) s_1 + (1 - m) s_2)
    / 2 from the ranks' own prev, with (1 - m) s_1 = A1 - m prev_1 and
    (1 - m) s_2 = A2 - m A1 from the one process's statistics after its
    first (A1) and second (A2) microbatch, within ``DDP_STATS_RTOL`` of
    each tensor's largest. The ranks were started by ``start_ddp_ranks``."""
    out_dir, net, ranks, start = (started[k] for k in ("out_dir", "net", "future", "start"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    # the one process, on the same card
    step = recipe_step(net, "O0", accum_steps=DDP_WORLD)
    image, keypoints = train_batch(np.random.RandomState(SEED + 26),
                                   DDP_WORLD * DDP_RANK_BATCH, device)
    bns = {m: n for n, m in net.named_modules() if isinstance(m, nn.BatchNorm2d)}
    seen = []

    def record(module, _, __):
        if len(seen) < len(bns):  # the first microbatch's forward
            seen.append((bns[module], module.running_mean.detach().cpu().clone(),
                         module.running_var.detach().cpu().clone()))

    hooks = [m.register_forward_hook(record) for m in bns]
    params = dict(net.named_parameters())
    tiny = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in params.items()}
    reference = []
    for _ in range(DDP_STEPS):
        before = _statistics(net)
        seen.clear()
        step(image, keypoints)
        for n, p in params.items():
            tiny[n] |= p.grad.abs() < 1e-4 * p.grad.abs().max()
        first = {}
        for name, mean, var in seen:
            first[f"{name}.running_mean"], first[f"{name}.running_var"] = mean, var
        reference.append({"before": before, "first": first, "after": _statistics(net)})
    for h in hooks:
        h.remove()
    torch.backends.cudnn.deterministic = deterministic
    ranks.result()
    rank_s = time.perf_counter() - start
    got = [torch.load(os.path.join(out_dir, f"ddp_rank{r}.pt")) for r in range(DDP_WORLD)]
    for i in range(DDP_STEPS):
        a, b = got[0]["steps"][i], got[1]["steps"][i]
        if a["digest"] != b["digest"] or not torch.equal(a["loss"], b["loss"]):
            raise AssertionError(f"phase 26 (a): the ranks differ after step {i}")
    lr = HRNET_W32["lr"]
    worst, loose, beyond, equal = 0.0, 0, 0, True
    for n, p in params.items():
        diff = (got[0]["params"][n].to(device) - p.detach()).abs()
        equal = equal and not bool(diff.any())
        tol = torch.where(tiny[n], 2.0 * lr * DDP_STEPS, 1e-5)
        beyond += int((diff > tol).sum())
        loose += int((diff > 1e-5).sum())
        worst = max(worst, float(diff.max()))
    m = 0.9  # flax's momentum: running = 0.9 running + 0.1 batch
    prev = reference[0]["before"]
    stats_err, gap = 0.0, 0.0
    for i, ref in enumerate(reference):
        ranks_stats = got[0]["steps"][i]["stats"]
        for name, value in ranks_stats.items():
            a1, a2 = ref["first"][name], ref["after"][name]
            want = m * prev[name] + (a1 - m * ref["before"][name] + a2 - m * a1) / 2
            scale = float(want.abs().max())
            stats_err = max(stats_err, float((value - want).abs().max()) / scale)
            gap = max(gap, float((value - a2).abs().max()) / scale)
        prev = ranks_stats
    losses = [float(s["loss"].sum()) for s in got[0]["steps"]]
    print(f"DDP, 2 ranks on one card over gloo (HRNet-W32, float32 O0, {DDP_RANK_BATCH} crops "
          f"a rank, {DDP_STEPS} steps at lr {lr}): ranks bitwise equal after every step; "
          f"losses {losses}; parameters against one process at accum_steps=2: max |diff| "
          f"{worst:.3e} (bitwise equal: {equal}), {loose} elements beyond 1e-5, {beyond} beyond "
          f"the bound (1e-5, or "
          f"{2.0 * lr * DDP_STEPS:g} where a gradient was below 1e-4 of its tensor's largest); "
          f"running statistics against the formula {stats_err:.3e} of each tensor's largest "
          f"(tolerance {DDP_STATS_RTOL}), against the one process's own {gap:.3e}; "
          f"{rank_s:.1f} s from the ranks' start (beside earlier phases) to the one process's "
          f"end")
    if beyond or stats_err > DDP_STATS_RTOL or not gap > 10 * stats_err:
        raise AssertionError("phase 26 (a): the two ranks do not match one process at "
                             "accum_steps=2")
    return {"param_max_diff": worst, "params_equal": equal, "beyond_1e-5": loose,
            "stats_rel_err": stats_err,
            "stats_gap": gap, "seconds": rank_s}


class _ProfiledStep:
    """The train entry's step with calls ``first`` to ``first + DDP_PROFILED_STEPS
    - 1`` (from 0; the last of epoch 1) under torch.profiler: per step, the all-reduces issued
    (host ranges whose name holds ``all_reduce``), the nccl kernels' device
    time and count (a group of one rank may launch none) and the
    device-to-device copies' (DDP's gradient buckets) go to ``out``."""

    def __init__(self, step, first: int, out: dict) -> None:
        self.step, self.first, self.out = step, first, out
        self.calls = 0
        self.prof = None

    @property
    def count(self) -> int:
        return self.step.count

    def __call__(self, *batch):
        call, self.calls = self.calls, self.calls + 1
        if call == self.first:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
        loss = self.step(*batch)
        if call == self.first + DDP_PROFILED_STEPS - 1:
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            events = trace_events(self.prof)
            ops = [e for e in events if e[1]]
            issued = [e for e in events if not e[1] and "all_reduce" in e[0].lower()]
            nccl = [e for e in ops if "nccl" in e[0].lower()]
            copies = [e for e in ops if "dtod" in e[0].lower().replace(" ", "")]

            def per_step_ms(evs):
                return sum(end - start for _, _, start, end in evs) / 1e3 / DDP_PROFILED_STEPS

            self.out.update(
                all_reduces=len(issued) / DDP_PROFILED_STEPS,
                all_reduce_names=sorted({e[0] for e in issued}),
                nccl_ms=per_step_ms(nccl), nccl_kernels=len(nccl) / DDP_PROFILED_STEPS,
                nccl_names=sorted({e[0] for e in nccl}),
                dtod_ms=per_step_ms(copies), dtod_copies=len(copies) / DDP_PROFILED_STEPS,
                data_parallel=isinstance(self.step.module, nn.parallel.DistributedDataParallel))
        return loss


def torchrun_entry(out_dir: str, argv: list) -> None:
    """Phase 26 (b), in the process torchrun starts: the train entry's
    ``train`` on ``argv`` (its process group from torchrun's variables),
    the decode kernel's launches counted and epoch 1's last steps
    profiled; writes ``entry.json``."""
    args = train_entry.parse_train_args(argv)
    profiled = {}
    build_step = train_entry.build_train_step
    steps_per_epoch = {}

    def build_train_step(*a, **kw):
        return _ProfiledStep(build_step(*a, **kw), steps_per_epoch["n"] - DDP_PROFILED_STEPS,
                             profiled)

    pipeline = train_entry.create_pipeline

    def create_pipeline(*a, **kw):
        loader = pipeline(*a, **kw)
        if kw.get("is_train") and "n" not in steps_per_epoch:
            steps_per_epoch["n"] = len(loader)
        return loader

    train_entry.build_train_step = build_train_step
    train_entry.create_pipeline = create_pipeline
    argmax_shift_decode.launches = 0
    try:
        result = train_entry.train(args)
    finally:
        train_entry.build_train_step = build_step
        train_entry.create_pipeline = pipeline
    record = {"launches": argmax_shift_decode.launches, "epochs": result["epochs"],
              "step": result["step"], "world": dist.get_world_size(),
              "backend": dist.get_backend(), "device": str(torch.cuda.current_device()),
              "profiled": profiled}
    with open(os.path.join(out_dir, "entry.json"), "w") as f:
        json.dump(record, f, default=float)


def torchrun_entries(jobs_path: str) -> None:
    """Phases 26 (b) and 27 (b), the one process torchrun starts for both:
    the DDP run (``torchrun_entry``), then the FSDP run
    (``torchrun_fsdp_entry``) in the same process group, as ``jobs_path``
    (JSON) gives their directories and command lines."""
    with open(jobs_path) as f:
        jobs = json.load(f)
    torchrun_entry(jobs["ddp"]["dir"], jobs["ddp"]["argv"])
    gc.collect()
    torch.cuda.empty_cache()
    torchrun_fsdp_entry(jobs["fsdp"]["dir"], jobs["fsdp"]["argv"])
    dist.destroy_process_group()


def launch_entries(root: str, data: dict, vit_data: dict) -> float:
    """Phases 26 (b) and 27 (b): one ``python3 -m torch.distributed.run
    --nproc_per_node=1`` (nccl, world size 1) whose process trains
    hrnet_w32_tpu.yaml through DDP on phase 12's data, then
    vitpose_h_tpu.yaml sharded on phase 21's data (``torchrun_entries``);
    ``ddp_entry`` and ``fsdp_entry`` read what it wrote. Returns its seconds
    with the start."""
    jobs = {"ddp": {"dir": os.path.join(root, "ddp_entry"), "argv": entry_argv(
                RECIPE_YAML, data, os.path.join(root, "ddp_entry"), f"num_epochs={DDP_EPOCHS}",
                f"warmup={INPUT_WARMUP}", f"val_interval={DDP_EPOCHS}")},
            "fsdp": {"dir": os.path.join(root, "fsdp_entry"), "argv": entry_argv(
                VITPOSE_YAML["h"], vit_data, os.path.join(root, "fsdp_entry"),
                *FSDP_OPTIONS)}}
    for job in jobs.values():
        os.makedirs(job["dir"], exist_ok=True)
    jobs_path = os.path.join(root, "torchrun_jobs.json")
    with open(jobs_path, "w") as f:
        json.dump(jobs, f)
    start = time.perf_counter()
    run_processes([[sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=1",
                    "--master_addr=127.0.0.1", f"--master_port={free_port()}",
                    os.path.abspath(__file__), "--torchrun-entries", jobs_path]],
                  [os.path.join(root, "torchrun.log")], DDP_TIMEOUT_S + FSDP_TIMEOUT_S,
                  "phases 26 (b) and 27 (b)")
    seconds = time.perf_counter() - start
    print(f"torchrun (one process: the DDP run, then the FSDP run): {seconds:.1f} s with the "
          f"start")
    return seconds


def ddp_entry(root: str, device: torch.device, phase12: dict) -> dict:
    """Phase 26 (b): hrnet_w32_tpu.yaml as parsed through the train entry
    under ``python3 -m torch.distributed.run --nproc_per_node=1`` (nccl,
    world size 1, DDP over the one card; ``launch_entries``), on phase 12's
    data, ``DDP_EPOCHS`` epochs of 10 steps, evaluating after the last.
    It holds finite, falling losses, AP above 0 and one decode launch per
    val batch, and that the profiled step issued all-reduces; it prints the
    img/s of epochs 2-3 beside phase 12's host targets without DDP, and per
    step the all-reduces issued, the nccl kernels' device time (none ran in
    a group of one rank on the H100: 0.0000 ms) and DDP's device-to-device
    copies (torch.profiler, epoch 1's last step)."""
    with open(os.path.join(root, "ddp_entry", "entry.json")) as f:
        run = json.load(f)
    epochs = run["epochs"]
    rate = entry_epochs("DDP entry (torchrun, 1 rank, nccl)", epochs)
    last = epochs[-1]
    evals = [e for e in epochs if e["metrics"]]
    ap = float(evals[-1]["metrics"]["AP"]) if evals else 0.0
    losses = [e["loss"] for e in epochs]
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // HRNET_W32["batch_size"])
    prof = run["profiled"]
    print(f"DDP entry (torchrun --nproc_per_node=1, backend {run['backend']}, world "
          f"{run['world']}, cuda:{run['device']}): epoch {len(epochs)} "
          f"{last['images_per_sec']:.1f} img/s "
          f"(step median {last['step_median_s'] * 1e3:.1f} ms, wait "
          f"{last['wait_total_s'] / last['steps'] * 1e3:.1f} ms a step), epochs 2-{len(epochs)} "
          f"{rate:.1f}; without DDP: phase 12's epochs 2-{ENTRY_EPOCHS} "
          f"{phase12['images_per_sec']:.1f}; per step of epoch 1's last (torch.profiler, "
          f"{DDP_PROFILED_STEPS} step(s)): {prof['all_reduces']:.1f} all-reduces issued "
          f"({prof['all_reduce_names']}), nccl kernels {prof['nccl_ms']:.4f} ms of device time "
          f"({prof['nccl_kernels']:.1f} kernels: {prof['nccl_names']}), device-to-device copies "
          f"{prof['dtod_ms']:.4f} ms ({prof['dtod_copies']:.1f}); AP {ap:.6f}; losses {losses}; "
          f"decode kernel launches {run['launches']}")
    if not (run["backend"] == "nccl" and run["world"] == 1 and prof["data_parallel"]):
        raise AssertionError("phase 26 (b): the entry did not train through DDP over nccl")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 26 (b): the losses are not finite or did not fall: {losses}")
    if not (len(evals) == 1 and ap > 0 and run["launches"] == val_batches):
        raise AssertionError(f"phase 26 (b): {len(evals)} evaluations, AP {ap}, "
                             f"{run['launches']} decode launches for {val_batches} val batch(es)")
    if not prof["all_reduces"] >= 1:
        raise AssertionError("phase 26 (b): the profiled steps issued no all-reduce")
    return {"launches": run["launches"], "images_per_sec": rate,
            "last_images_per_sec": last["images_per_sec"], "ap": ap,
            "all_reduces_per_step": prof["all_reduces"], "nccl_ms_per_step": prof["nccl_ms"],
            "nccl_kernels_per_step": prof["nccl_kernels"], "dtod_ms_per_step": prof["dtod_ms"]}


def vitpose_h_args(device: torch.device) -> Config:
    """vitpose_h_tpu.yaml as the train entry parses it, on ``device``."""
    return train_entry.parse_train_args(["--config", VITPOSE_YAML["h"], "--device",
                                         str(device)])


def vitpose_h_step(args: Config, accum_steps: int):
    """vitpose_h_tpu.yaml's net (ViT-H/16 + the deconv head) at full width,
    cut to ``FSDP_DEPTH`` encoder blocks, torch's initialisation from
    ``SEED`` (on the CPU: the same weights in every process), in float64,
    through the recipe's step at O0: the device preprocess (its crops and
    targets cast to float64), joint_mse with target weights, adamw with the
    recipe's layer decay at its constant lr. Within a process group the net is sharded
    over a mesh of model = the world first. Returns (net, optimizer, step)."""
    with torch.device("meta"):  # the recipe's backbone: its widths only
        full = create_backbone(args.backbone_name, **args.backbone_setting)
    torch.manual_seed(SEED)
    backbone = ViT(hidden_dim=full.hidden_dim, depth=FSDP_DEPTH,
                   num_heads=full.blocks[0].attn.num_heads,
                   image_size=args.dataset_setting["image_size"])
    net = Net(backbone, create_head(args.head_name, in_channels=full.hidden_dim,
                                    num_joints=args.num_joints,
                                    **args.head_setting)).to(args.device, torch.float64)
    if dist.is_initialized():
        shard_net(net, create_mesh(dist.get_world_size(), "cuda"))
    optimizer = create_optimizer(net, args.optimizer, learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 filter_bias_and_bn=args.filter_bias_and_bn,
                                 **args.optimizer_setting)
    ds = args.dataset_setting
    _, target_kwargs = strip_host_target_transform(args.train_transforms)
    render = build_topdown_preprocess(ds["image_size"], ds["heatmap_size"],
                                      args.normalize_mean, args.normalize_std, **target_kwargs)

    def preprocess(*batch):  # crops and targets in the net's float64
        return tuple(t.double() for t in render(*batch))

    nwl = create_network_with_loss(net, create_loss(args.loss, **args.loss_setting),
                                   has_extra_inputs=args.loss_with_extra_input)
    return net, optimizer, build_train_step(nwl, optimizer, preprocess=preprocess,
                                            amp_level="O0", accum_steps=accum_steps)


def vit_batch(n: int, device: torch.device):
    """``train_batch``'s crops and keypoints at vitpose_h_tpu.yaml's 256x192."""
    return train_batch(np.random.RandomState(SEED + 27), n, device)


def local_bytes(tensors) -> tuple:
    """(bytes this rank holds, bytes of the whole tensors) of ``tensors``,
    sharded (``DTensor``) or not."""
    mine = whole = 0
    for t in tensors:
        local = t.to_local() if isinstance(t, DTensor) else t
        mine += local.numel() * local.element_size()
        whole += t.numel() * t.element_size()
    return mine, whole


def moments(optimizer) -> list:
    return [s[k] for s in optimizer.state.values() for k in ("exp_avg", "exp_avg_sq")]


def fsdp_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """Phase 27 (a), one rank (a fresh interpreter): ``vitpose_h_step``
    sharded over the ranks (gloo on the one card), ``FSDP_RANK_BATCH`` crops
    of the batch each, ``FSDP_STEPS`` steps; per step the loss, after the
    first the rank's shard of each reduced gradient with its dim, at the end
    the local and whole bytes of the parameters and of the AdamW moments
    (``fsdp_rank{rank}.pt``). The shards are not gathered here: the state
    dict's gather (``full_state``) runs DTensor's functional collectives,
    which end in a segmentation fault over gloo on CUDA tensors (torch
    2.11.0+cu128); FSDP's own collectives run."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    net, optimizer, step = vitpose_h_step(vitpose_h_args(device), accum_steps=1)
    if not is_sharded(net):
        raise AssertionError("phase 27 (a): the net was not sharded")
    image, keypoints = vit_batch(world * FSDP_RANK_BATCH, device)
    shard = slice(rank * FSDP_RANK_BATCH, (rank + 1) * FSDP_RANK_BATCH)
    losses, grads = [], None
    for _ in range(FSDP_STEPS):
        losses.append(step(image[shard], keypoints[shard]).cpu())
        if grads is None:
            grads = {n: (p.grad.to_local().cpu(), p.grad.placements[-1].dim)
                     for n, p in net.named_parameters()}
    torch.save({"losses": losses, "grads": grads, "params": local_bytes(net.parameters()),
                "moments": local_bytes(moments(optimizer)),
                "peak": torch.cuda.max_memory_allocated()},
               os.path.join(out_dir, f"fsdp_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def start_fsdp_ranks(root: str, background: Background) -> dict:
    """Phase 27 (a)'s two rank processes (``fsdp_rank``), started on
    ``background`` beside phase 26 (a)'s, which they need nothing from."""
    out_dir = os.path.join(root, "fsdp_ranks")
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    commands = [[sys.executable, os.path.abspath(__file__), "--fsdp-rank", str(rank),
                 str(FSDP_WORLD), str(port), out_dir] for rank in range(FSDP_WORLD)]
    logs = [os.path.join(out_dir, f"rank{rank}.log") for rank in range(FSDP_WORLD)]
    return {"out_dir": out_dir, "start": time.perf_counter(),
            "future": background.submit("phase 27 (a)'s two ranks", run_processes, commands,
                                        logs, FSDP_TIMEOUT_S, "phase 27 (a)")}


def fsdp_on_one_card(device: torch.device, ranks: dict) -> dict:
    """Phase 27 (a): ViT-H at full width, cut to ``FSDP_DEPTH`` blocks,
    sharded over two ranks on the one card over gloo (``fsdp_rank``),
    against one process on the whole batch, ``FSDP_STEPS`` steps of the
    recipe's adamw with layer decay in float64. The deconv head's BatchNorm
    takes the global batch's statistics under FSDP, as one process on the
    whole batch takes them (one process at ``accum_steps=2``, each
    microbatch with its own statistics, is another step: its gradients lay
    up to 0.19 of a tensor's largest entry away, measured); the sharded
    step's reduce-scatter then averages the two ranks' gradients. Held: each
    step's loss of the ranks against the one process's within
    ``FSDP_LOSS_RTOL`` (the later ones after the sharded AdamW update with
    layer decay), and the first step's gradients, put together from the
    ranks' shards, within ``FSDP_GRAD_RTOL`` of each tensor's largest
    (float64 sums in another order). Each rank's parameters and AdamW
    moments are printed beside the whole ones. ``ranks`` are the rank
    processes ``start_fsdp_ranks`` started beside earlier phases."""
    out_dir = ranks["out_dir"]
    args = vitpose_h_args(device)
    # the one process, on the same card
    net, optimizer, step = vitpose_h_step(args, accum_steps=1)
    image, keypoints = vit_batch(FSDP_WORLD * FSDP_RANK_BATCH, device)
    losses, grads = [], None
    for _ in range(FSDP_STEPS):
        losses.append(step(image, keypoints).cpu())
        if grads is None:
            grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    whole = {"params": local_bytes(net.parameters()),
             "moments": local_bytes(moments(optimizer))}
    ranks["future"].result()
    seconds = time.perf_counter() - ranks["start"]
    got = [torch.load(os.path.join(out_dir, f"fsdp_rank{r}.pt")) for r in range(FSDP_WORLD)]
    grad_err, worst_name, equal = 0.0, "", True
    for n, g in grads.items():
        # the reduced gradient from the ranks' shards, in rank order along its dim
        reduced = torch.cat([r["grads"][n][0] for r in got], dim=got[0]["grads"][n][1])
        diff = (reduced.to(device) - g).abs()
        equal = equal and not bool(diff.any())
        err = float(diff.max() / g.abs().max().clamp_min(1e-30))
        if err > grad_err:
            grad_err, worst_name = err, n
    rank_losses = [float(x.sum()) for x in got[0]["losses"]]
    one_losses = [float(x.sum()) for x in losses]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(rank_losses, one_losses))
    ranks_equal = all(torch.equal(a, b) for a, b in zip(got[0]["losses"], got[1]["losses"]))
    sizes = "; ".join(
        f"rank {r}: parameters {g['params'][0]} of {g['params'][1]} B, AdamW moments "
        f"{g['moments'][0]} of {g['moments'][1]} B, peak {g['peak'] / 2**30:.2f} GiB"
        for r, g in enumerate(got))
    print(f"FSDP, 2 ranks on one card over gloo (ViT-H/16 at full width, {FSDP_DEPTH} of its "
          f"32 blocks, + deconv head, {sum(g.numel() for g in grads.values())} parameters, "
          f"float64, "
          f"{FSDP_RANK_BATCH} crops a rank, {FSDP_STEPS} steps with layer decay): {sizes}; one "
          f"process holds {whole['params'][0]} B of parameters and {whole['moments'][0]} B of "
          f"moments; losses of the ranks {rank_losses} (equal on both: {ranks_equal}), of the "
          f"one process on the {FSDP_WORLD * FSDP_RANK_BATCH} crops {one_losses}, at worst "
          f"{loss_err:.3e} apart "
          f"(tolerance {FSDP_LOSS_RTOL}); the first step's reduced gradients against the one "
          f"process's {grad_err:.3e} of each tensor's largest at worst ({worst_name}; "
          f"tolerance {FSDP_GRAD_RTOL}; bitwise equal: {equal}); {seconds:.1f} s from the ranks' "
          f"start (beside phase 26 (a)'s and earlier phases) to the one process's end")
    for g in got:
        if not (g["params"][0] * FSDP_WORLD <= g["params"][1] + 2**20
                and g["moments"][0] * FSDP_WORLD <= g["moments"][1] + 2**21):
            raise AssertionError("phase 27 (a): a rank holds more than its share")
    if not ranks_equal or loss_err > FSDP_LOSS_RTOL or grad_err > FSDP_GRAD_RTOL:
        raise AssertionError("phase 27 (a): the two sharded ranks do not match one process on "
                             "the whole batch")
    return {"grad_rel_err": grad_err, "grads_equal": equal, "loss_rel_err": loss_err,
            "rank_param_bytes": got[0]["params"], "rank_moment_bytes": got[0]["moments"],
            "seconds": seconds}


def torchrun_fsdp_entry(out_dir: str, argv: list) -> None:
    """Phase 27 (b), in the process torchrun starts: the train entry's ``train``
    on ``argv`` (its process group from torchrun's variables), the decode
    kernel's launches counted, the sharded net's and its optimizer's local
    bytes and the bytes of rank 0's unsharded eval copy recorded; writes
    ``entry.json``."""
    args = train_entry.parse_train_args(argv)
    seen = {}
    shard, build_step = train_entry.shard_net, train_entry.build_train_step
    make_callback = train_entry.EvalCallback

    def shard_net_recorded(net, mesh):
        seen["net"], seen["mesh"] = net, dict(zip(mesh.mesh_dim_names, mesh.shape))
        return shard(net, mesh)

    def build_train_step_recorded(nwl, optimizer, *a, **kw):
        seen["optimizer"] = optimizer
        return build_step(nwl, optimizer, *a, **kw)

    def callback_recorded(*a, **kw):
        seen["callback"] = make_callback(*a, **kw)
        return seen["callback"]

    train_entry.shard_net, train_entry.build_train_step = (shard_net_recorded,
                                                           build_train_step_recorded)
    train_entry.EvalCallback = callback_recorded
    argmax_shift_decode.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        result = train_entry.train(args)
    finally:
        train_entry.shard_net, train_entry.build_train_step = shard, build_step
        train_entry.EvalCallback = make_callback
    eval_copy = seen["callback"].eval_net
    record = {"launches": argmax_shift_decode.launches, "epochs": result["epochs"],
              "step": result["step"], "world": dist.get_world_size(),
              "backend": dist.get_backend(), "sharded": is_sharded(seen["net"]),
              "mesh": seen["mesh"], "params": local_bytes(seen["net"].parameters()),
              "moments": local_bytes(moments(seen["optimizer"])),
              "eval_copy": local_bytes([*eval_copy.parameters(), *eval_copy.buffers()]),
              "peak": torch.cuda.max_memory_allocated()}
    with open(os.path.join(out_dir, "entry.json"), "w") as f:
        json.dump(record, f, default=float)


def fsdp_entry(root: str, data: dict, device: torch.device) -> dict:
    """Phase 27 (b): vitpose_h_tpu.yaml as parsed (``parallel_mode: fsdp``,
    batch 32 in 4 microbatches, O2, layer decay 0.8) through the train entry
    under ``python3 -m torch.distributed.run --nproc_per_node=1`` (nccl,
    world size 1: the net sharded over a mesh of one; ``launch_entries``),
    on phase 21's data, ``FSDP_EPOCHS`` epoch(s), evaluating after the last
    through rank 0's unsharded copy. It holds: nccl, world 1, the net
    sharded, finite losses, one decode launch per val batch; then the last
    checkpoint, gathered from the shards, through the eval and serving
    entries (``check_recipe_checkpoint``), which load it strictly into
    unsharded nets."""
    name = "vitpose_h_tpu"
    ckpt_dir = os.path.join(root, "fsdp_entry")
    with open(os.path.join(ckpt_dir, "entry.json")) as f:
        run = json.load(f)
    epochs = run["epochs"]
    rate = entry_epochs(f"{name} FSDP entry (torchrun, 1 rank, nccl)", epochs)
    losses = [e["loss"] for e in epochs]
    evals = [e for e in epochs if e["metrics"]]
    args = recipe_args(VITPOSE_YAML["h"], data, ckpt_dir, device, *FSDP_OPTIONS)
    val_batches = -(-VIT_SMALL_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    print(f"{name} FSDP entry (torchrun --nproc_per_node=1, backend {run['backend']}, world "
          f"{run['world']}, mesh {run['mesh']}, sharded {run['sharded']}): epoch {len(epochs)} "
          f"{rate:.1f} img/s, step median {epochs[-1]['step_median_s'] * 1e3:.1f} ms; "
          f"parameters {run['params'][0]} of {run['params'][1]} B, AdamW moments "
          f"{run['moments'][0]} of {run['moments'][1]} B on the rank, and its unsharded "
          f"eval copy's parameters and buffers {run['eval_copy'][0]} B; peak "
          f"torch.cuda.max_memory_allocated {run['peak']} B ({run['peak'] / 2**30:.2f} GiB); "
          f"losses {losses}; decode kernel launches {run['launches']}")
    if not (run["backend"] == "nccl" and run["world"] == 1 and run["sharded"]):
        raise AssertionError("phase 27 (b): the entry did not train sharded over nccl")
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 27 (b): the losses are not finite: {losses}")
    if not (len(evals) == 1 and run["launches"] == val_batches):
        raise AssertionError(f"phase 27 (b): {len(evals)} evaluations, {run['launches']} decode "
                             f"launches for {val_batches} val batch(es)")
    stats = {k: float(v) for k, v in evals[-1]["metrics"].items()}
    checked = check_recipe_checkpoint(name, VITPOSE_YAML["h"], args,
                                      os.path.join(ckpt_dir, f"{name}_last.ckpt"), stats,
                                      val_batches, root, device)
    return {"launches": run["launches"], **checked, "images_per_sec": rate,
            "peak_bytes": run["peak"]}


def distill_training(root: str, data: dict, device: torch.device) -> dict:
    """Phase 28: hrnet_w32_tpu.yaml as parsed, as the student of an HRNet-W48
    teacher (torch's initialisation from a seed, its BatchNorm statistics
    taken from one batch of crops; written as a port checkpoint with
    ``save_checkpoint``), through the train entry with
    ``distill_setting``, ``loss: joint_mse_distill`` (alpha 0.5), one epoch
    of phase 12's data, evaluating after it. It holds finite losses, both
    loss components logged and above 0, one decode launch per val batch,
    and the teacher's heatmaps that the preprocess appended to the last
    microbatch equal to a plain forward of the teacher on that microbatch's
    image within ``DISTILL_HEAT_RTOL`` of their largest (cuDNN may pick
    another algorithm for the second call)."""
    ckpt_dir = os.path.join(root, "distill")
    os.makedirs(ckpt_dir, exist_ok=True)
    teacher_path = os.path.join(ckpt_dir, f"{DISTILL_TEACHER}_teacher.ckpt")
    torch.manual_seed(SEED + 28)
    teacher = create_network(DISTILL_TEACHER, HRNET_W32["head_name"],
                             num_joints=HRNET_W32["num_joints"]).to(device)
    # BatchNorm statistics from the data (one train-mode forward at momentum
    # 1), as a trained teacher has: at their initial 0 and 1 the eval-mode
    # activations grow through the stages to heatmaps of ~1e6
    crops = recipe_preprocess()(*train_batch(np.random.RandomState(SEED + 28), 32, device))[0]
    norms = [m for m in teacher.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for m in norms:
            m.momentum = 1.0
        teacher.train()(crops)
        for m in norms:
            m.momentum = 0.1
    save_checkpoint(teacher_path, teacher)
    del teacher
    setting = {"teacher_backbone": DISTILL_TEACHER, "teacher_head": HRNET_W32["head_name"],
               "teacher_ckpt": teacher_path}
    args = recipe_args(RECIPE_YAML, data, ckpt_dir, device, "num_epochs=1",
                       f"warmup={INPUT_WARMUP}", "val_interval=1", "loss=joint_mse_distill",
                       f"loss_setting={{'use_target_weight': True, 'alpha': {DISTILL_ALPHA}}}",
                       f"distill_setting={setting!r}")
    seen = {}
    make = train_entry.build_teacher_preprocess

    def build_teacher_preprocess(teacher, base_preprocess=None):
        preprocess = make(teacher, base_preprocess)

        def recorded(*cols):
            out = preprocess(*cols)
            seen.update(teacher=teacher, image=out[0], heat=out[-1])
            return out

        return recorded

    train_entry.build_teacher_preprocess = build_teacher_preprocess
    torch.cuda.reset_peak_memory_stats()
    argmax_shift_decode.launches = 0
    start = time.perf_counter()
    try:
        result = train_entry.train(args)
    finally:
        train_entry.build_teacher_preprocess = make
    seconds = time.perf_counter() - start
    launches = argmax_shift_decode.launches
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        plain = seen["teacher"](seen["image"].float())
    heat_err = float((plain - seen["heat"]).abs().max() / plain.abs().max())
    with open(os.path.join(ckpt_dir, "summary", "metrics.jsonl")) as f:
        (record,) = [json.loads(line) for line in f]
    (epoch,) = result["epochs"]
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    print(f"distillation (hrnet_w32_tpu.yaml student, {DISTILL_TEACHER} teacher from a port "
          f"checkpoint, alpha {DISTILL_ALPHA}): {epoch['steps']} steps, "
          f"{epoch['images_per_sec']:.1f} img/s, step median {epoch['step_median_s'] * 1e3:.1f} "
          f"ms; loss {epoch['loss']:.6g} = task {record['train/loss_0']:.6g} + distill "
          f"{record['train/loss_1']:.6g} (the epoch's mean components); AP "
          f"{float(epoch['metrics']['AP']):.6f}; the appended teacher heatmaps "
          f"{tuple(seen['heat'].shape)} {seen['heat'].dtype} against a plain teacher forward "
          f"{heat_err:.3e} of their largest (bitwise equal: "
          f"{bool(torch.equal(plain, seen['heat']))}); peak torch.cuda.max_memory_allocated "
          f"{peak} B ({peak / 2**30:.2f} GiB); decode kernel launches {launches}; "
          f"{seconds:.1f} s")
    if not (np.isfinite(epoch["loss"]) and record["train/loss_0"] > 0
            and record["train/loss_1"] > 0):
        raise AssertionError(f"phase 28: the loss components are not both logged and positive: "
                             f"{record}")
    if heat_err > DISTILL_HEAT_RTOL or seen["heat"].dtype != torch.float32:
        raise AssertionError("phase 28: the appended heatmaps are not the teacher's float32 ones")
    if launches != val_batches:
        raise AssertionError(f"phase 28: {launches} decode launches for {val_batches} val "
                             f"batch(es)")
    return {"launches": launches, "heat_rel_err": heat_err, "seconds": seconds,
            "images_per_sec": epoch["images_per_sec"]}


def remat_step(device: torch.device) -> dict:
    """Phase 29: the recipe's step (batch 128, O2, constant lr) on HRNet-W32
    with and without ``remat``, from the same weights on the same batch.
    The first step of each runs with cuDNN's deterministic algorithms and
    their loss, gradients and running statistics are held equal within
    ``REMAT_RTOL`` of each tensor's largest; then ``REMAT_TIMED_STEPS``
    steps each are timed (CUDA events) with the peak of
    ``torch.cuda.max_memory_allocated`` over them."""
    plain = training_net(device)
    remat = create_network(HRNET_W32["backbone_name"], HRNET_W32["head_name"],
                           num_joints=HRNET_W32["num_joints"],
                           backbone_args=dict(HRNET_W32["backbone_setting"], remat=True),
                           head_args=HRNET_W32["head_setting"]).to(device)
    remat.load_state_dict(plain.state_dict())
    image, keypoints = train_batch(np.random.RandomState(SEED + 29),
                                   HRNET_W32["batch_size"], device)
    runs = {}
    for label, net in (("plain", plain), ("remat", remat)):
        step = recipe_step(net, "O2")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        loss = step(image, keypoints)
        torch.backends.cudnn.deterministic = deterministic
        first = {"loss": loss.detach().clone(),
                 "grads": {n: p.grad.detach().clone() for n, p in net.named_parameters()},
                 "stats": _statistics(net)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(REMAT_TIMED_STEPS):
            step(image, keypoints)
        end.record()
        torch.cuda.synchronize()
        runs[label] = dict(first, ms=begin.elapsed_time(end) / REMAT_TIMED_STEPS,
                           peak=torch.cuda.max_memory_allocated())
        del step
        torch.cuda.empty_cache()
    a, b = runs["plain"], runs["remat"]

    def rel(x, y):
        return float((x.float() - y.float()).abs().max() / y.float().abs().max().clamp_min(1e-30))

    loss_err = rel(b["loss"], a["loss"])
    grad_err = max(rel(b["grads"][n], g) for n, g in a["grads"].items())
    stats_err = max(rel(b["stats"][n], v) for n, v in a["stats"].items())
    equal = (torch.equal(a["loss"], b["loss"])
             and all(torch.equal(b["grads"][n], g) for n, g in a["grads"].items()))
    print(f"remat (hrnet_w32_tpu.yaml step, batch {HRNET_W32['batch_size']}, O2): loss "
          f"{float(a['loss'].sum()):.6g} plain, remat against it {loss_err:.3e}; gradients "
          f"{grad_err:.3e} and running statistics after one update {stats_err:.3e} of each "
          f"tensor's largest (tolerance {REMAT_RTOL}; bitwise equal: {equal}); step "
          f"{a['ms']:.1f} ms plain, {b['ms']:.1f} ms remat ({b['ms'] / a['ms']:.3f}x), peak "
          f"torch.cuda.max_memory_allocated {a['peak']} B ({a['peak'] / 2**30:.2f} GiB) plain, "
          f"{b['peak']} B ({b['peak'] / 2**30:.2f} GiB) remat ({b['peak'] / a['peak']:.3f}x), "
          f"{REMAT_TIMED_STEPS} steps each (CUDA events)")
    if max(loss_err, grad_err, stats_err) > REMAT_RTOL:
        raise AssertionError("phase 29: the remat step differs from the plain one")
    return {"grad_rel_err": grad_err, "ms": a["ms"], "remat_ms": b["ms"], "peak": a["peak"],
            "remat_peak": b["peak"]}


def resident_bytes(build) -> tuple:
    """(what ``build()`` returns, the device memory it holds once built:
    ``torch.cuda.memory_allocated`` after against before). Garbage of
    earlier phases (reference cycles) is collected first, or its release
    during the build would count against it."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    built = build()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return built, torch.cuda.memory_allocated() - before


def request_peak_bytes(predictor: TopDownPredictor, image, boxes) -> int:
    """The device memory one request allocates at its peak, above what was held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    predictor(image, boxes)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - held


def int8_heatmaps(predictor: TopDownPredictor, x: torch.Tensor) -> torch.Tensor:
    """The heatmaps that an int8 predictor's forward computes for crops ``x``:
    its net under its dequantized weights."""
    weights = dequantize_variables(predictor._forward.quantized)
    with torch.inference_mode():
        return torch.func.functional_call(predictor.net, weights, (x,))


def compare_int8_with_dequantized(qp: TopDownPredictor, deq: TopDownPredictor, image,
                                  boxes, got: np.ndarray, want: np.ndarray) -> float:
    """The int8 predictor's keypoints against a float32 predictor's on the
    dequantized weights: bitwise, or else every joint whose heatmap peak leads
    its runner-up by more than twice the heatmaps' largest gap equal, the
    scores within that gap. Returns the keypoints' largest |diff|."""
    gap = float(np.abs(got - want).max())
    if bitwise_equal(torch.from_numpy(got), torch.from_numpy(want)):
        return gap
    with torch.inference_mode():
        x, _, _ = deq.preprocess(image, boxes)
        heat_deq = deq.net(x)
    heat_err = float((int8_heatmaps(qp, x) - heat_deq).abs().max())
    top2 = torch.topk(heat_deq.flatten(2), 2, dim=2).values.cpu()
    clear = ((top2[..., 0] - top2[..., 1]) > 2 * heat_err).numpy()
    xy_err = np.abs(got[..., :2] - want[..., :2]).max(-1)
    score_err = float(np.abs(got[..., 2] - want[..., 2]).max())
    print(f"int8 against dequantized float32, {len(boxes)} boxes: not bitwise; keypoints max "
          f"|diff| {gap:.3e}; heatmaps max |diff| {heat_err:.3e}; {int(clear.sum())} of "
          f"{clear.size} joints lead by more than twice that, max |diff| among them "
          f"{float(xy_err[clear].max()) if clear.any() else 0.0:.3e} px; scores {score_err:.3e}")
    if not (clear.any() and (xy_err[clear] == 0).all() and score_err <= heat_err):
        raise AssertionError("int8 serving disagrees with the dequantized weights beyond the "
                             "heatmaps' own difference")
    return gap


def int8_serving(root: str, device: torch.device) -> dict:
    """Phase 30: hrnet_w32_tpu.yaml's net at full width (random weights from a
    numpy seed, saved as a port checkpoint) through the serving entry with and
    without ``--quantize int8``."""
    net = training_net(device)
    ckpt = os.path.join(root, "hrnet_w32_random.ckpt")
    save_checkpoint(ckpt, net)
    del net
    torch.cuda.empty_cache()
    argv = ["--config", RECIPE_YAML, "--ckpt", ckpt, "--batch-size", str(BATCH_SIZE)]
    float_service, float_bytes = resident_bytes(lambda: serve_entry.build_service(
        serve_entry.parse_serve_args(argv), batch_size=BATCH_SIZE, device=device))
    int8_args = serve_entry.parse_serve_args(argv + ["--quantize", "int8"])
    int8_service, int8_bytes = resident_bytes(lambda: serve_entry.build_service(
        int8_args, batch_size=BATCH_SIZE, device=device))
    fp, qp = float_service.predictor, int8_service.predictor
    qb, fb = quantized_bytes(qp.qstate)
    n_quantized = sum(isinstance(v, QTensor) for v in qp.qstate.values())
    print(f"int8 weights: {n_quantized} tensors quantized, {qb:,} B of int8 and scales against "
          f"{fb:,} B of float32 ({qb / fb:.4f}); resident on the card "
          f"(torch.cuda.memory_allocated): int8 predictor {int8_bytes:,} B, float32 "
          f"{float_bytes:,} B ({int8_bytes / float_bytes:.4f})")
    if not (qb * 3 < fb and qb <= int8_bytes < float_bytes - (fb - qb) // 2):
        raise AssertionError("the int8 predictor does not hold its weights as int8")

    deq_net = copy.deepcopy(fp.net)
    deq_net.load_state_dict(dequantize_variables(qp.qstate), strict=True)
    setting = {k: HRNET_W32[k] for k in ("dataset_setting", "decoder_setting", "normalize_mean",
                                         "normalize_std", "decoder_name")}
    deq = TopDownPredictor(deq_net, batch_size=BATCH_SIZE, device=device, **setting)
    image, requests, payloads, chunks = request_payloads(SEED + 30)
    for predictor in (fp, qp, deq):
        predictor(image, requests[0])  # warm-up
    torch.cuda.synchronize()
    argmax_shift_decode.launches = 0
    answers = [qp(image, boxes) for boxes in requests]
    launches = argmax_shift_decode.launches
    print(f"int8 serving: decode kernel launches {launches} for requests of "
          f"{[len(b) for b in requests]} boxes ({chunks} chunks)")
    if launches != chunks:
        raise AssertionError(f"{chunks} chunks made {launches} decode launches")
    gaps = []
    for boxes, got in zip(requests, answers):
        check_preds(got, boxes)
        gaps.append(compare_int8_with_dequantized(qp, deq, image, boxes, got, deq(image, boxes)))
    print(f"int8 against float32 on the dequantized weights, 1/5/40 boxes: keypoints max "
          f"|diff| {gaps} (0.0 is bit for bit)")
    # and one request over HTTP through the entry's service
    http = HttpService(int8_service)
    try:
        over_http = serve_request(http.url, payloads[1], requests[1])
    finally:
        http.close()
    if not bitwise_equal(torch.from_numpy(over_http), torch.from_numpy(answers[1])):
        raise AssertionError("the int8 service over HTTP answers otherwise than its predictor")

    cpu_qp = TopDownPredictor(copy.deepcopy(deq_net).cpu(), batch_size=BATCH_SIZE,
                              quantize="int8", device=torch.device("cpu"), **setting)
    cpu_deq = TopDownPredictor(copy.deepcopy(deq_net).cpu(), batch_size=BATCH_SIZE,
                               device=torch.device("cpu"), **setting)
    print("int8 on the card against int8 on the CPU (heatmaps through the dequantized weights, "
          "which the int8 forward computes with):")
    compare_with_cpu(deq, cpu_deq, image, requests[1],
                     answers=(answers[1], cpu_qp(image, requests[1])))

    ms = {}
    for boxes in requests:
        runs = {"float32": [], "int8": []}
        for r in range(REPEATS):
            order = (("float32", fp), ("int8", qp)) if r % 2 == 0 else (("int8", qp),
                                                                         ("float32", fp))
            for name, predictor in order:
                start = time.perf_counter()
                predictor(image, boxes)
                runs[name].append((time.perf_counter() - start) * 1e3)
        ms[len(boxes)] = {name: statistics.median(v) for name, v in runs.items()}
        print(f"request {len(boxes)} boxes over {REPEATS} runs each, interleaved: int8 median "
              f"{ms[len(boxes)]['int8']:.3f} ms (min {min(runs['int8']):.3f}, max "
              f"{max(runs['int8']):.3f}); float32 median {ms[len(boxes)]['float32']:.3f} ms "
              f"(min {min(runs['float32']):.3f}, max {max(runs['float32']):.3f})")
    peaks = {name: request_peak_bytes(p, image, requests[2]) for name, p in (("float32", fp),
                                                                               ("int8", qp))}
    print(f"a 40-box request's peak device memory above what the predictor holds: int8 "
          f"{peaks['int8']:,} B, float32 {peaks['float32']:,} B")
    # the dequantize alone, as every forward runs it: one multiply per weight
    dequant_ms = time_ms(lambda: dequantize_variables(qp._forward.quantized), queued=True,
                         iters=10, repeats=5)
    print(f"the dequantize of every int8 weight ({n_quantized} tensors, device time per "
          f"forward): {dequant_ms:.4f} ms; its bound {(qb + fb) / HBM_BYTES_PER_MS:.4f} ms "
          f"(bytes: int8 and scales read, float32 written)")
    float_service.close()
    int8_service.close()
    return {"launches": launches, "ckpt": ckpt, "quantized_bytes": qb, "float_bytes": fb,
            "resident_bytes": {"int8": int8_bytes, "float32": float_bytes}, "ms": ms,
            "peak_bytes": peaks, "dequant_ms": dequant_ms}


def host_us_per_call(fn, calls: int = 200) -> float:
    """The host's time per call of ``fn``, the calls issued back to back
    behind a busy-wait on the card (so that the host never waits on it)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def export_serving(root: str, ckpt: str, tool_recipe: str, tool_ckpt: str,
                   device: torch.device) -> dict:
    """Phase 31: hrnet_w32_tpu.yaml's net at full width (phase 30's random
    weights) exported on the card with a symbolic batch, loaded from the
    bytes alone, and called at batches it was not traced at; beside it, the
    export tool with ``--selftest`` in a process of its own on
    ``tool_recipe`` with ``tool_ckpt``. Both are mostly host work, so they
    overlap; the tool is waited for before anything here is timed."""
    out = os.path.join(root, os.path.splitext(os.path.basename(tool_recipe))[0] + ".pt2")
    tool_start = time.perf_counter()
    tool = subprocess.Popen(
        [sys.executable, "-m", "mindpose_tpu_torch.tools.export", "--config", tool_recipe,
         "--ckpt", tool_ckpt, "--out", out, "--selftest"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        with torch.device("meta"):
            net = create_network(HRNET_W32["backbone_name"], HRNET_W32["head_name"],
                                 num_joints=HRNET_W32["num_joints"])
        state = load_checkpoint(ckpt)["net"]
        net = net.to_empty(device="cpu")
        net.load_state_dict(state, strict=True)
        net = net.to(device).eval()
        decoder = create_decoder(HRNET_W32["decoder_name"], **HRNET_W32["decoder_setting"])
        eval_net = create_eval_network(net, decoder, output_raw=True)
        image_hw = tuple(HRNET_W32["dataset_setting"]["image_size"][::-1])
        start = time.perf_counter()
        program = trace_eval_net(eval_net, image_hw)
        trace_s = time.perf_counter() - start
        start = time.perf_counter()
        blob = save_program(program)
        save_s = time.perf_counter() - start
        start = time.perf_counter()
        serve = load_serving_fn(blob)
        load_s = time.perf_counter() - start
        tool_log, _ = tool.communicate(timeout=900)
    finally:
        if tool.poll() is None:
            tool.kill()
            tool.communicate()
    tool_s = time.perf_counter() - tool_start
    ops = [str(n.target) for n in program.graph.nodes if "mindpose" in str(n.target)]
    print(f"export of HRNet-W32 + decode, batch symbolic (traced at 2): torch.export "
          f"{trace_s:.2f} s, save {save_s:.2f} s, load {load_s:.2f} s (beside the tool's "
          f"process); artifact {len(blob):,} B; decode nodes {ops}")
    if ops != ["mindpose.decode_heatmap.default"]:
        raise AssertionError(f"the program's decode nodes are {ops}")
    lines = [ln for ln in tool_log.splitlines() if "wrote" in ln or "selftest" in ln
             or "exporting" in ln]
    print(f"tools/export.py --selftest on {os.path.basename(tool_recipe)} (its amp_level, bf16 "
          f"autocast at O1-O3) in a process of its own, {tool_s:.1f} s from its start to its "
          f"end: exit {tool.returncode}")
    print("\n".join(lines))
    if tool.returncode or not any("selftest ok" in ln for ln in lines):
        print(tool_log[-6000:])
        raise AssertionError("tools/export.py --selftest failed")

    direct = ServingModule(net, decoder, output_raw=True)
    rng = np.random.RandomState(SEED + 31)
    launches = 0
    for n in (1, 5, BATCH_SIZE):
        inputs = [torch.from_numpy(a).to(device) for a in (
            rng.standard_normal((n, 3) + image_hw).astype(np.float32),
            rng.uniform(100, 500, (n, 2)).astype(np.float32),
            rng.uniform(0.5, 2.0, (n, 2)).astype(np.float32),
            rng.uniform(0.5, 1.0, n).astype(np.float32))]
        serve(*inputs)  # warm-up
        torch.cuda.synchronize()
        argmax_shift_decode.launches = 0
        (preds, boxes), heat = serve(*inputs)
        torch.cuda.synchronize()
        call_launches = argmax_shift_decode.launches
        launches += call_launches
        with torch.inference_mode():
            (want, want_boxes), want_heat = direct(*inputs)
        heat_err = float((heat - want_heat).abs().max())
        tol = HEATMAP_RTOL * float(want_heat.abs().max())
        top2 = torch.topk(want_heat.flatten(2), 2, dim=2).values
        clear = ((top2[..., 0] - top2[..., 1]) > 2 * tol).cpu().numpy()
        xy_err = (preds[..., :2] - want[..., :2]).abs().amax(-1).cpu().numpy()
        score_err = float((preds[..., 2] - want[..., 2]).abs().max())
        same = bitwise_equal(preds, want) and bitwise_equal(boxes, want_boxes)
        print(f"artifact at batch {n}: {call_launches} decode launch; against the direct forward "
              f"and decode: heatmaps max |diff| {heat_err:.3e} (tolerance {tol:.3e}), keypoints "
              f"{'bit for bit' if same else f'max |diff| {float(xy_err.max()):.3e} px'}, "
              f"{int(clear.sum())} of {clear.size} joints clear of the tolerance")
        if call_launches != 1:
            raise AssertionError(f"a call of the artifact made {call_launches} decode launches")
        if not same and not (heat_err <= tol and (xy_err[clear] == 0).all() and score_err <= tol
                             and torch.allclose(boxes, want_boxes, rtol=1e-6, atol=0)):
            raise AssertionError("the artifact disagrees with the direct forward")
    runs = {"artifact": [], "direct": []}
    for r in range(REPEATS):
        for name in (("artifact", "direct") if r % 2 == 0 else ("direct", "artifact")):
            start = time.perf_counter()
            with torch.inference_mode():
                result = serve(*inputs) if name == "artifact" else direct(*inputs)
            result[0][0].cpu()
            runs[name].append((time.perf_counter() - start) * 1e3)
    ms = {name: statistics.median(v) for name, v in runs.items()}
    print(f"batch {BATCH_SIZE} over {REPEATS} calls each, interleaved, to the keypoints on the "
          f"host: artifact median {ms['artifact']:.3f} ms, direct {ms['direct']:.3f} ms")

    # the op layer's cost on the host: the decoder's op against the kernel's
    # launch through ctypes alone, at the served chunk
    x = want_heat.contiguous()
    crops = [t.contiguous() for t in inputs[1:]]
    op_us = host_us_per_call(lambda: decode_heatmap(x, *crops, shift=False, to_original=True,
                                                    use_udp=False, pixel_std=200.0))
    raw_us = host_us_per_call(lambda: cuda_decode._decode_heatmap_cuda(
        x, *crops, False, True, False, 200.0))
    print(f"decode_heatmap's host time per call: {op_us:.2f} us through the torch.library op, "
          f"{raw_us:.2f} us calling its CUDA implementation directly (the dispatcher's share "
          f"{op_us - raw_us:.2f} us)")
    return {"launches": launches, "trace_s": trace_s, "save_s": save_s, "load_s": load_s,
            "bytes": len(blob), "ms": ms, "op_us": op_us, "raw_us": raw_us, "tool_s": tool_s}


DEMO_IMAGES = 4  # phase 32: frames of phase 12's val split, and a clip of 2 x 4 frames


def demos(root: str, data: dict, topdown_ckpt: str, bottomup_ckpt: str,
          device: torch.device) -> dict:
    """Phase 32: tools/demo.py top-down (hrnet_w32_tpu.yaml, whole image as the
    box) and bottom-up (higher_hrnet_w32_tpu.yaml) on frames of phase 12's
    val split, and tools/demo_video.py on a clip that cv2 writes from them,
    with checkpoints that earlier phases wrote."""
    image_dir = os.path.join(root, "demo_in")
    os.makedirs(image_dir, exist_ok=True)
    names = sorted(os.listdir(data["val"][0]))[:DEMO_IMAGES]
    frames = []
    for name in names:
        frame = cv2.imread(os.path.join(data["val"][0], name))
        cv2.imwrite(os.path.join(image_dir, os.path.splitext(name)[0] + ".png"), frame)
        frames.append(frame)
    out = {}
    for label, recipe, ckpt in (("top-down", RECIPE_YAML, topdown_ckpt),
                                ("bottom-up", HIGHER_YAML, bottomup_ckpt)):
        out_dir = os.path.join(root, f"demo_out_{label}")
        argmax_shift_decode.launches = 0
        cuda_grouping.match_by_tag_batch.launches = 0
        start = time.perf_counter()
        demo_tool.main(["--config", recipe, "--ckpt", ckpt, "--image-dir", image_dir,
                        "--output-dir", out_dir])
        seconds = time.perf_counter() - start
        written = sorted(os.listdir(out_dir))
        out[label] = {"launches": argmax_shift_decode.launches, "seconds": seconds,
                      "grouping_launches": cuda_grouping.match_by_tag_batch.launches}
        print(f"tools/demo.py {label}: {len(written)} images written in {seconds:.2f} s; decode "
              f"kernel launches {out[label]['launches']}, grouping kernel launches "
              f"{out[label]['grouping_launches']}")
        want = (DEMO_IMAGES, 0) if label == "top-down" else (0, DEMO_IMAGES)
        if len(written) != DEMO_IMAGES or (out[label]["launches"],
                                           out[label]["grouping_launches"]) != want:
            raise AssertionError(f"tools/demo.py {label} wrote {written} with launches "
                                 f"{out[label]}")
    h, w = frames[0].shape[:2]
    clip, video_out = os.path.join(root, "demo_clip.mp4"), os.path.join(root, "demo_video.mp4")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    for frame in frames + frames[::-1]:
        writer.write(cv2.resize(frame, (w, h)))
    writer.release()
    argmax_shift_decode.launches = 0
    start = time.perf_counter()
    demo_video_tool.main(["--config", RECIPE_YAML, "--ckpt", topdown_ckpt, "--video", clip,
                          "--output", video_out])
    seconds = time.perf_counter() - start
    cap = cv2.VideoCapture(video_out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    out["video"] = {"launches": argmax_shift_decode.launches, "seconds": seconds, "frames": n}
    print(f"tools/demo_video.py top-down, One-Euro smoothing on: {n} frames written in "
          f"{seconds:.2f} s; decode kernel launches {out['video']['launches']}")
    if n != 2 * DEMO_IMAGES or out["video"]["launches"] != n:
        raise AssertionError(f"tools/demo_video.py: {out['video']}")
    return {"launches": out["top-down"]["launches"] + out["video"]["launches"],
            "grouping_launches": out["bottom-up"]["grouping_launches"], "runs": out}


VISUAL_SAMPLES = 2  # phase 33 (a): samples of each visualisation tool
RESIZE_EVAL_IMAGES = 8  # phase 33 (b): frames of phase 12's val split, batch 1
RESIZE_SIZE = 512  # bottomup_resize's short side (its default): 512x704 for 360x480 frames
PHOTOMETRIC_TRAIN_IMAGES = 192  # phase 33 (c): 384 records, 3 steps of 128
PHOTOMETRIC_VAL_IMAGES = 16
NATIVE_STATS_ATOL = 1e-9  # the stats with the native library on against off


def visual_tools(root: str, data: dict, topdown_ckpt: str, bottomup_ckpt: str) -> dict:
    """Phase 33 (a): the three visualisation tools on VISUAL_SAMPLES samples
    each: ground truth (hrnet_w32_tpu.yaml's train loader on phase 12's data,
    no net), top-down predictions (phase 12's last checkpoint: one decode
    launch per sample) and AE predictions (higher_hrnet_w32_tpu.yaml, phase
    17's checkpoint: one grouping launch per sample), on the current card."""
    (train_root, train_label), (val_root, val_label) = data["train"], data["val"]
    paths = [f"train_root={train_root}", f"train_label={train_label}",
             f"val_root={val_root}", f"val_label={val_label}"]
    out = {}
    for label, tool, recipe, ckpt in (
            ("gt", visual_gt_tool, RECIPE_YAML, None),
            ("topdown", visual_topdown_tool, RECIPE_YAML, topdown_ckpt),
            ("ae", visual_ae_tool, HIGHER_YAML, bottomup_ckpt)):
        out_dir = os.path.join(root, f"visual_{label}")
        argmax_shift_decode.launches = 0
        cuda_grouping.match_by_tag_batch.launches = 0
        start = time.perf_counter()
        results = tool.main(["--config", recipe, *(["--ckpt", ckpt] if ckpt else []),
                             "--num-samples", str(VISUAL_SAMPLES), "--output-dir", out_dir,
                             "--cfg-options", *paths])
        seconds = time.perf_counter() - start
        written = sorted(os.listdir(out_dir))
        out[label] = {"launches": argmax_shift_decode.launches, "seconds": seconds,
                      "grouping_launches": cuda_grouping.match_by_tag_batch.launches}
        print(f"visual {label}: {len(written)} images written in {seconds:.2f} s; decode kernel "
              f"launches {out[label]['launches']}, grouping kernel launches "
              f"{out[label]['grouping_launches']}")
        want = {"gt": (0, 0), "topdown": (VISUAL_SAMPLES, 0), "ae": (0, VISUAL_SAMPLES)}[label]
        if len(written) != VISUAL_SAMPLES or (out[label]["launches"],
                                              out[label]["grouping_launches"]) != want:
            raise AssertionError(f"visual {label} wrote {written} with launches {out[label]}")
        for path in written:
            image = cv2.imread(os.path.join(out_dir, path))
            if image is None or image.size == 0:
                raise AssertionError(f"visual {label}: {path} is not an image")
        if label == "topdown":
            for r in results:
                ok = r["preds"].shape == (HRNET_W32["num_joints"], 3) and np.isfinite(
                    r["preds"]).all() and (r["preds"][:, :2] >= 0).all() and (
                    r["preds"][:, 0] < HRNET_W32["dataset_setting"]["heatmap_size"][0]).all()
                if not ok:
                    raise AssertionError(f"visual topdown: keypoints off the heatmap {r['preds']}")
    return out


def resize_evaluation(root: str, data: dict, ckpt: str, device: torch.device) -> dict:
    """Phase 33 (b): phase 17's checkpoint (higher_hrnet_w32_tpu.yaml at full
    width) through the eval entry on RESIZE_EVAL_IMAGES frames of phase 12's
    val split, with ``bottomup_resize`` as the val transform: inputs whose
    sides are multiples of 64 and not square, batch 1 (the batch rule), one
    grouping launch per frame."""
    val_root, val_label = data["val"]
    with open(val_label) as f:
        coco = json.load(f)
    kept = {im["id"] for im in coco["images"][:RESIZE_EVAL_IMAGES]}
    subset = dict(coco, images=[im for im in coco["images"] if im["id"] in kept],
                  annotations=[a for a in coco["annotations"] if a["image_id"] in kept])
    label = os.path.join(root, "resize_val.json")
    with open(label, "w") as f:
        json.dump(subset, f)
    args = parse_args(["--config", HIGHER_YAML, "--ckpt", ckpt, "--cfg-options",
                       f"val_root={val_root}", f"val_label={label}",
                       f"val_transforms=[{{'bottomup_resize': {{'size': {RESIZE_SIZE}}}}}]",
                       f"result_path={os.path.join(root, 'resize_result.json')}"])
    timings = {}
    cuda_grouping.match_by_tag_batch.launches = 0
    start = time.perf_counter()
    stats = evaluate(args, device=device, timings=timings)
    seconds = time.perf_counter() - start
    launches = cuda_grouping.match_by_tag_batch.launches
    loader = create_pipeline(create_dataset(val_root, label, dataset_format=args.dataset_format,
                                            is_train=False, config=args.dataset_setting),
                             args.val_transforms, method="bottomup", batch_size=args.batch_size,
                             is_train=False, config=args.dataset_setting)
    shape = next(iter(loader))["image"].shape
    print(f"bottom-up eval with bottomup_resize (size {RESIZE_SIZE}): {timings['records']} "
          f"images in {timings['batches']} batches of input {shape[1]}x{shape[2]}, "
          f"{seconds:.2f} s; grouping kernel launches {launches}; AP "
          f"{float(stats['AP']):.6f}; stats {json.dumps({k: float(v) for k, v in stats.items()})}")
    values = np.array([float(v) for v in stats.values()])
    if len(values) != 10 or not (np.isfinite(values) & (values >= -1) & (values <= 1)).all():
        raise AssertionError(f"phase 33 (b): malformed COCO stats {stats}")
    if not (launches == timings["batches"] == timings["records"] == RESIZE_EVAL_IMAGES):
        raise AssertionError(f"phase 33 (b): {launches} grouping launches for "
                             f"{timings['batches']} batches of {RESIZE_EVAL_IMAGES} frames")
    if shape[1] % 64 or shape[2] % 64 or shape[1] == shape[2]:
        raise AssertionError(f"phase 33 (b): bottomup_resize gave {shape}")
    return {"launches": launches, "ap": float(stats["AP"]), "seconds": seconds}


def photometric_training(root: str, device: torch.device) -> dict:
    """Phase 33 (c): hrnet_w32_tpu.yaml as parsed (full width, O2, batch 128)
    through the train entry with ``topdown_photometric_distortion`` after
    its first train transform, one epoch of 3 steps on synthetic COCO,
    evaluating after it: finite losses, the transform applied to every
    trained record, one decode launch per val batch."""
    data = write_synthetic_coco(os.path.join(root, "photometric"), PHOTOMETRIC_TRAIN_IMAGES,
                                PHOTOMETRIC_VAL_IMAGES, ENTRY_PEOPLE)
    transforms = [HRNET_W32["train_transforms"][0], "topdown_photometric_distortion",
                  *HRNET_W32["train_transforms"][1:]]
    args = recipe_args(RECIPE_YAML, data, os.path.join(root, "photometric_ckpt"), device,
                       "num_epochs=1", "warmup=1",
                       "val_interval=1", f"train_transforms={transforms!r}")
    distortion = entrypoint("transform", "topdown_photometric_distortion")
    calls = []
    transform = distortion.transform

    def counted(self, state):
        calls.append(1)
        return transform(self, state)

    distortion.transform = counted
    argmax_shift_decode.launches = 0
    start = time.perf_counter()
    try:
        result = train_entry.train(args)
    finally:
        distortion.transform = transform
    seconds = time.perf_counter() - start
    (epoch,) = result["epochs"]
    launches = argmax_shift_decode.launches
    val_batches = -(-PHOTOMETRIC_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    print(f"hrnet_w32_tpu with topdown_photometric_distortion: {epoch['steps']} steps, loss "
          f"{epoch['loss']:.6g}, {epoch['images_per_sec']:.1f} img/s, AP "
          f"{float(epoch['metrics']['AP']):.6f}; the transform ran on {len(calls)} records; "
          f"decode kernel launches {launches}; {seconds:.1f} s")
    if not (epoch["steps"] == PHOTOMETRIC_TRAIN_IMAGES * ENTRY_PEOPLE // args.batch_size
            and np.isfinite(epoch["loss"])):
        raise AssertionError(f"phase 33 (c): {epoch['steps']} steps, loss {epoch['loss']}")
    if len(calls) < epoch["images"] or launches != val_batches:
        raise AssertionError(f"phase 33 (c): the transform ran {len(calls)} times for "
                             f"{epoch['images']} records; {launches} decode launches")
    return {"launches": launches, "seconds": seconds, "steps": epoch["steps"]}


def native_evaluator(root: str, phase8: dict, gpu: str) -> dict:
    """Phase 33 (d): phase 8's first pass's evaluator (its records, OKS-NMS
    and COCOeval) again on the same results, with the native COCO library on
    and then off (``set_native_enabled``): the host seconds of each and the
    stats, within NATIVE_STATS_ATOL of each other."""
    kept = phase8["evaluator_inputs"]
    label = os.path.join(root, "phase8_val.json")
    with open(label, "w") as f:
        json.dump(kept["annotations"], f)
    args = kept["args"]
    seconds, stats = {}, {}
    try:
        for on in (True, False):
            native.set_native_enabled(on)
            evaluator = create_evaluator(
                label, name=args.eval_method, metric=args.eval_metric,
                config=args.eval_setting, dataset_config=args.dataset_setting,
                num_joints=args.num_joints,
                result_path=os.path.join(root, f"phase8_native_{on}.json"))
            start = time.perf_counter()
            stats[on] = evaluator(copy.deepcopy(kept["outputs"]))
            seconds[on] = time.perf_counter() - start
    finally:
        native.set_native_enabled(True)
    worst = max(abs(float(stats[True][k]) - float(stats[False][k])) for k in stats[True])
    print(f"evaluator on phase 8's first pass ({len(kept['outputs'])} records): native library "
          f"on {seconds[True]:.3f} s, off {seconds[False]:.3f} s "
          f"({seconds[False] / seconds[True]:.2f}x); phase 8's own {kept['eval_s']:.3f} s; stats "
          f"max |diff| {worst:.2e} (tolerance {NATIVE_STATS_ATOL}); {gpu}")
    if worst > NATIVE_STATS_ATOL:
        raise AssertionError("phase 33 (d): the stats with the native library on and off differ")
    return {"on_s": seconds[True], "off_s": seconds[False]}


EXPERIMENT_TRAIN_IMAGES = 8  # phase 34: frames of 2 persons: 16 records, one step of 16
EXPERIMENT_VAL_IMAGES = 4
EXPERIMENT_BATCH = 16
ABLATION_ITERS = "1"  # phase 34: timed calls after the warm one
BU_ABLATION_BATCH = "8"  # phase 34: ablate_bottomup's and ablate_bu_loss's batch (default 24)
ACCURACY_PROTOCOL = {"train_images", "val_images", "people_per_img", "epochs", "batch_size",
                     "backbone", "tta", "det_noise", "paired"}
GROUPING_PROTOCOL = {"train_images", "val_images", "people_per_img", "epochs",
                     "steps_per_epoch", "batch_size", "model", "hflip_tta", "multiscale_tta",
                     "refine_missing_joint"}


def check_rows(name: str, rows: list) -> None:
    """An ablation's rows: each with finite positive times and a scalar that is
    a number (inf where a chain's squared gradient norm overflows float32, as
    the JAX program's does: C=128 and 256 chains of depth 8 at the tools'
    weights), never NaN."""
    if not rows:
        raise AssertionError(f"{name}: no rows")
    for row in rows:
        ms = [v for k, v in row.items() if k == "ms" or k.endswith("_ms")]
        values = [v for k, v in row.items() if k == "value" or k.endswith("_value")]
        if not ms or not all(np.isfinite(m) and m > 0 for m in ms) or any(
                v is not None and np.isnan(v) for v in values):
            raise AssertionError(f"{name}: a row without a finite time or with a NaN: {row}")


def experiment_tools(root: str, gpu: str) -> dict:
    """Phase 34: the 14 experiment and ablation tools' ``main`` in this process,
    at full width and their smallest counts, on the current card.

    (a) ablate_accuracy (the plain arm, one seed, one epoch of one step of
    HRNet-W32 at batch 16, 4 val frames): JAX's report keys and at least one
    decode launch; (b) exp_grouping (HigherHRNet-W32 at 256, one step, the
    same checkpoint grouped by the host Hungarian and by the kernel): JAX's
    keys and at least one grouping launch, all in the device arm; (c)
    exp_warmstart (one step on domain A, the export to a MindSpore .ckpt, the
    convert_ckpt CLI in a process of its own, one step from scratch and one
    from the converted backbone): JAX's keys, and the converted file equal
    to the exported tensors bit for bit; (d) the eleven ablations and probes
    at their full shapes with one warm call and two timed calls (probe_layout:
    100 steps, best of 2): finite times, no NaN scalar. Prints each tool's
    seconds and rows beside the card's name and power limit."""
    from mindpose_tpu_torch.models.convert_source import normalize_source_keys
    from mindpose_tpu_torch.tools import (
        ablate_accuracy, ablate_bottomup, ablate_bu_backbone, ablate_bu_loss, ablate_conv_bwd,
        ablate_conv_chain, ablate_conv_layout, ablate_conv_shape, ablate_s2d_head, ablate_step,
        exp_grouping, exp_warmstart, probe_layout, profile_parts)

    out = {"seconds": {}}
    small = ["--train-images", str(EXPERIMENT_TRAIN_IMAGES),
             "--val-images", str(EXPERIMENT_VAL_IMAGES)]

    def timed(name, fn):
        argmax_shift_decode.launches = 0
        cuda_grouping.match_by_tag_batch.launches = 0
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - start
        launches = (argmax_shift_decode.launches, cuda_grouping.match_by_tag_batch.launches)
        torch.cuda.empty_cache()
        print(f"phase 34 {name}: {out['seconds'][name]:.1f} s; decode kernel launches "
              f"{launches[0]}, grouping kernel launches {launches[1]}")
        return result, launches

    acc, (out["accuracy_launches"], _) = timed("ablate_accuracy", lambda: ablate_accuracy.main([
        "--arms", "plain", "--seeds", "0", "--epochs", "1", "--batch-size",
        str(EXPERIMENT_BATCH), "--people", "2", *small,
        "--data-root", os.path.join(root, "ablate_accuracy"),
        "--out", os.path.join(root, "ablate_accuracy.json")]))
    if (set(acc) != {"protocol", "runs", "summary"} or set(acc["protocol"]) != ACCURACY_PROTOCOL
            or [r["label"] for r in acc["runs"]] != ["plain"]
            or not 0.0 <= acc["runs"][0]["AP"] <= 1.0 or out["accuracy_launches"] < 1):
        raise AssertionError(f"phase 34 (a): {acc} with {out['accuracy_launches']} launches")

    grp, (_, out["grouping_launches"]) = timed("exp_grouping", lambda: exp_grouping.main([
        "--seeds", "0", "--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "8",
        "--people", "2", *small, "--data-root", os.path.join(root, "exp_grouping"),
        "--out", os.path.join(root, "exp_grouping.json")]))
    if (set(grp) != {"protocol", "runs", "max_abs_delta"}
            or set(grp["protocol"]) != GROUPING_PROTOCOL or len(grp["runs"]) != 1
            or out["grouping_launches"] < 1):
        raise AssertionError(f"phase 34 (b): {grp} with {out['grouping_launches']} launches")

    warm_root = os.path.join(root, "exp_warmstart")
    warm, (out["warmstart_launches"], _) = timed("exp_warmstart", lambda: exp_warmstart.main([
        "--epochs", "1", "--pretrain-epochs", "1", "--batch-size", str(EXPERIMENT_BATCH),
        "--seeds", "0", "--eval-every", "1", *small, "--data-root", warm_root,
        "--out", os.path.join(root, "exp_warmstart.json")]))
    stem = os.path.join(warm_root, f"{warm['protocol']['arch']}_domain_a")
    exported = normalize_source_keys(convert_ckpt.load_source(stem + ".ckpt"))
    converted = torch.load(stem + ".pth")
    bitwise = set(exported) == set(converted) and all(
        np.array_equal(converted[k].numpy(), exported[k]) for k in converted)
    print(f"phase 34 exp_warmstart: {len(converted)} converted tensors bit for bit equal to "
          f"the exported ones: {bitwise}")
    if (set(warm) != {"protocol", "runs", "summary"} or len(warm["runs"]) != 2
            or not bitwise or out["warmstart_launches"] < 1):
        raise AssertionError(f"phase 34 (c): {warm['runs']}, bitwise {bitwise}")

    iters = ["--iters", ABLATION_ITERS]
    ablations = [
        ("ablate_step", ablate_step, iters), ("profile_parts", profile_parts, iters),
        ("ablate_bottomup", ablate_bottomup, iters + ["--batch", BU_ABLATION_BATCH]),
        ("ablate_bu_backbone", ablate_bu_backbone, iters),
        ("ablate_bu_loss", ablate_bu_loss, iters + ["--batch", BU_ABLATION_BATCH]),
        ("ablate_conv_chain", ablate_conv_chain, iters),
        ("ablate_conv_bwd", ablate_conv_bwd, iters),
        ("ablate_conv_layout", ablate_conv_layout, iters),
        ("ablate_conv_shape", ablate_conv_shape, iters),
        ("ablate_s2d_head", ablate_s2d_head, iters),
        ("probe_layout", probe_layout, ["--reps", ABLATION_ITERS]),
    ]
    out["rows"] = {}
    for name, tool, argv in ablations:
        rows, _ = timed(name, lambda: tool.main(argv))
        check_rows(name, rows)
        out["rows"][name] = rows
    print(f"phase 34: the ablations' rows above; {gpu}")
    return out


BENCH_E2E_IMAGES = "4"  # phase 35: 32 records, one batch of 32 an epoch
BENCH_E2E_BATCH = "32"
BENCH_ITERS = "1"  # phase 35: timed calls of the serving, variant and budget tools (least)
# phase 35 (a): tools/bench.py's parts with their loops cut to their least
# (keyword -> value over each default): the train step's 3 loops of 1 step
# (20), the bottom-up step's of 1 (10), e2e 2 epochs, the first untimed (4);
# the decode at its defaults
BENCH_CUTS = {"bench_train_step": {"iters": 1}, "bench_bottomup_step": {"iters": 1},
              "bench_e2e_encode": {"epochs": 2}}
BENCH_TIMEOUT_S = 600
VARIANT_BATCH = "32"  # phase 35: bench_variant's batch (its default, 128, is bench's step)
BU_VARIANT_BATCH = "8"  # bench_bu_variant's (its default, 24, is bench's bottom-up step)
SERVE_PRESETS = ("resnet50", "hrnet_w32", "vit_b", "simcc", "rle")
HEATMAP_PRESETS = {"resnet50", "hrnet_w32", "vit_b"}  # decode through the kernel
# tools/bench.py's extra keys: the JAX benchmark's, without its TPU-only
# decode_pallas_* arm and its regression guard, with the decode launches
BENCH_EXTRA = {
    "train_images_per_sec", "train_images_per_sec_per_chip", "step_time_ms", "batch_per_chip",
    "n_devices", "decode_p50_ms", "decode_amortized_ms", "decode_amortized_spread_ms",
    "decode_batch", "decode_kernel_launches", "higher_hrnet_train_images_per_sec_per_chip",
    "higher_hrnet_step_time_ms", "higher_hrnet_batch_per_chip", "e2e_images_per_sec",
    "e2e_mode", "e2e_records_per_epoch", "e2e_epoch_rates", "e2e_mb_per_batch",
    "e2e_wire_mb_per_s", "link_mb_per_s", "link_mb_per_s_pre_post", "e2e_link_utilization"}
BUDGET_MAX_PCT = 105.0


def start_bench(root: str, background: Background):
    """Phase 35 (a): ``tools/bench.py``'s ``main`` whole in a process of its
    own on ``background``, its loops cut (``BENCH_CUTS``), its output to a
    log; ``bench_report`` reads it once the process has ended."""
    code = ("import functools, json; from mindpose_tpu_torch.tools import bench\n"
            f"for name, kw in json.loads({json.dumps(BENCH_CUTS)!r}).items():\n"
            "    fn = getattr(bench, name)\n"
            "    setattr(bench, name, functools.update_wrapper(functools.partial(fn, **kw), fn))\n"
            "bench.main()\n")
    out_dir = os.path.join(root, "bench")
    os.makedirs(out_dir, exist_ok=True)

    def run():
        start = time.perf_counter()
        (log,) = run_processes([[sys.executable, "-c", code]], [os.path.join(out_dir, "log")],
                               BENCH_TIMEOUT_S, "phase 35 (a): tools/bench.py")
        return log, time.perf_counter() - start

    return background.submit("phase 35 (a): tools/bench.py", run, serial=True)


def bench_report(started) -> dict:
    """Phase 35 (a), once ``start_bench``'s process has ended: each part's
    seconds, then its last line, which must parse with ``value`` > 0,
    ``vs_baseline`` 1.0, the extra keys ``BENCH_EXTRA``, no ``*_error`` key,
    and the decode kernel launched by ``bench_decode``. Returns the report."""
    log, seconds = started.result()
    lines = [ln for ln in log.splitlines() if ln.strip()]
    for line in lines:  # each part's seconds, from its standard error
        if "| bench: " in line:
            print(f"phase 35 {line.split('| ', 1)[1]}")
    report = json.loads(next(ln for ln in reversed(lines) if ln.startswith("{")))
    extra = report["extra"]
    errors = sorted(k for k in extra if k == "error" or k.endswith("_error"))
    print(f"phase 35 bench: {seconds:.1f} s from its start to its end, in a process of its own "
          f"beside the main process's phases, sharing the card with them")
    print(f"phase 35 bench: {json.dumps(report)}")
    if (set(report) != {"metric", "value", "unit", "vs_baseline", "extra"}
            or not report["value"] > 0 or report["vs_baseline"] != 1.0 or errors
            or set(extra) != BENCH_EXTRA or extra["decode_kernel_launches"] < 1):
        raise AssertionError(f"phase 35 (a): {report}")
    return report


def bench_tools(root: str, gpu: str) -> dict:
    """Phase 35: the six bench tools on the current card, at full width.

    (a) ``tools/bench.py`` runs in a process of its own (``start_bench``,
    ``bench_report``); here (b) ``bench_serve``, the five presets at 1, 8
    and 32 boxes, ``BENCH_ITERS`` timed requests each, float32, then
    hrnet_w32 with int8 weights: p50 <= p90 <= p99, and decode launches for
    the heatmap presets only; (c) ``bench_e2e`` in host, encode and full
    mode (4 frames: one batch of 32 an epoch, 2 epochs, its least), then
    ``--bytes-only`` over the five modes and ``--loader-only``; (d)
    ``bench_variant`` (base, bn4, bnfrozen; batch 32) and ``bench_bu_variant``
    (base, bnfrozen, remat; batch 8) at ``BENCH_ITERS`` timed steps; (e)
    ``budget_table`` at ``BENCH_ITERS`` timed calls: every row with FLOPs or
    bytes, its shares of the eager program's bound and of the shape-derived
    least bytes' roofline bound in (0, 105], and the least bytes no more
    than the counted ones. Prints each tool's rows and seconds beside the
    card's name and power limit. Returns the decode launches of (b)."""
    from mindpose_tpu_torch.tools import (
        bench_bu_variant, bench_e2e, bench_serve, bench_variant, budget_table)

    out = {"seconds": {}, "launches": 0}

    def timed(name, fn):
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - start
        torch.cuda.empty_cache()
        print(f"phase 35 {name}: {out['seconds'][name]:.1f} s")
        return result

    out["serve"] = {}
    for name, quantize in [(p, "") for p in SERVE_PRESETS] + [("hrnet_w32", "int8")]:
        label = f"{name}{'+' + quantize if quantize else ''}"
        argmax_shift_decode.launches = 0
        served = timed(f"bench_serve {label}", lambda: bench_serve.main([
            "--models", name, "--batch-sizes", "1,8,32", "--iters", BENCH_ITERS,
            *(["--quantize", quantize] if quantize else [])]))
        rows = served["models"][name]
        launches = argmax_shift_decode.launches
        out["launches"] += launches
        out["serve"][label] = {"rows": rows, "launches": launches}
        ordered = all(0 < r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"] for r in rows.values())
        if (served["backend"] != "gpu" or list(rows) != ["batch1", "batch8", "batch32"]
                or not ordered or (launches > 0) != (name in HEATMAP_PRESETS)):
            raise AssertionError(f"phase 35 (b) {label}: {served} with {launches} launches")
        print(f"phase 35 bench_serve {label}: decode kernel launches {launches}")

    e2e_root = os.path.join(root, "bench_e2e")
    img_root, ann = bench_e2e.make_synth_coco(e2e_root, int(BENCH_E2E_IMAGES))
    data = ["--data-root", img_root, "--ann", ann, "--batch-size", BENCH_E2E_BATCH]
    e2e = timed("bench_e2e", lambda: bench_e2e.main([*data, "--epochs", "2"]))
    sized = timed("bench_e2e --bytes-only", lambda: bench_e2e.main(
        [*data, "--bytes-only", "--modes", ",".join(bench_e2e.MODES + bench_e2e.BYTES_MODES)]))
    loaded = timed("bench_e2e --loader-only", lambda: bench_e2e.main(
        [*data, "--loader-only", "--epochs", "2"]))
    if (list(e2e["e2e_summary"]) != list(bench_e2e.MODES)
            or not all(r["e2e_images_per_sec"] > 0 and r["e2e_link_utilization"] > 0
                       for r in e2e["results"])
            or len(sized["results"]) != 5 or len(loaded["results"]) != 3):
        raise AssertionError(f"phase 35 (c): {e2e} {sized} {loaded}")
    out["e2e"] = {"e2e": e2e["results"], "bytes": sized["results"], "loader": loaded["results"]}

    variants = timed("bench_variant", lambda: bench_variant.main(
        ["--variants", "base,bn4,bnfrozen", "--batch", VARIANT_BATCH, "--iters", BENCH_ITERS]))
    bu_variants = timed("bench_bu_variant", lambda: bench_bu_variant.main(
        ["--variants", "base,bnfrozen,remat", "--batch", BU_VARIANT_BATCH,
         "--iters", BENCH_ITERS]))
    check_rows("bench_variant", variants)
    check_rows("bench_bu_variant", [{"ms": r["higher_hrnet_step_time_ms"]} for r in bu_variants])
    out["variants"], out["bu_variants"] = variants, bu_variants

    budget = timed("budget_table", lambda: budget_table.main(
        ["--iters", BENCH_ITERS, "--out", os.path.join(root, "budget.json")]))
    for row in budget["rows"]:
        if (not (row["flops"] > 0 or row["bytes"] > 0)
                or not 0 < row["pct_of_bound"] <= BUDGET_MAX_PCT
                or not 0 < row["pct_of_min_bound"] <= BUDGET_MAX_PCT
                or not 0 < row["min_bytes"] <= row["bytes"]):
            raise AssertionError(f"phase 35 (e): {row}")
    out["budget"] = budget
    print(f"phase 35: the bench tools' rows above; budget_table on {budget['gpu']}; {gpu}")
    return out


def radial_cosines(optimizer, before: list):
    """Per projected filter of ``optimizer`` (a ``RadialAdamW``), the largest
    |<u, w>| / (|u| |w|) over its output channels, u the update's Adam part
    (the decay taken out) read back from the weights ``before`` the step and
    now: w_after = w - lr (u + weight_decay w). None where the step's rate
    is 0 (the schedule's first step), which moves nothing."""
    out = []
    groups = [g for g in optimizer.param_groups if g.get("radial_dim") is not None]
    for group, weights in zip(groups, before):
        keep = group["radial_dim"]
        if group["lr"] == 0:
            continue
        for p, w in zip(group["params"], weights):
            w = w.double()
            u = (w - p.detach().double()) / group["lr"] - group["weight_decay"] * w
            dims = tuple(d for d in range(w.dim()) if d != keep)
            dot = (u * w).sum(dims)
            norms = (u * u).sum(dims).sqrt() * (w * w).sum(dims).sqrt()
            out.append((dot.abs() / norms.clamp_min(1e-300)).max())
    return torch.stack(out).cpu() if out else None


def projected_weights(optimizer) -> list:
    """Copies of the projected filters of ``optimizer``, per projected group."""
    return [[p.detach().clone() for p in g["params"]] for g in optimizer.param_groups
            if g.get("radial_dim") is not None]


def divergent_step_with_cpu(device: torch.device) -> dict:
    """Phase 36 (a): one step of each ``DIVERGENT_CASES`` on the full-width net
    at batch ``TRAIN_CPU_BATCH``, float64, constant lr, on the card and on the
    CPU from the same weights: the loss, gradients and running statistics
    within ``TRAIN_F64_RTOL`` of each tensor's largest; the parameters after
    the update within ``close_update``'s bounds (Adam's first update is lr
    g / (|g| + eps): a gradient within rounding of 0 may move its element up
    to 2 lr the other way); with the projection, each projected filter's
    update orthogonal to it on both."""
    cpu = torch.device("cpu")
    lr = HRNET_W32["lr"]
    image, keypoints = train_batch(np.random.RandomState(SEED + 36), TRAIN_CPU_BATCH, cpu)
    preprocess = recipe_preprocess()
    out = {}
    for name, (knobs, radial) in DIVERGENT_CASES.items():
        gpu_net = training_net(device, **knobs).double()
        runs = {}
        for side, net, dev in (("gpu", gpu_net, device), ("cpu", copy.deepcopy(gpu_net).cpu(), cpu)):
            optimizer = recipe_optimizer(net, radial_projection=radial)
            step = build_train_step(
                recipe_net_with_loss(net), optimizer,
                preprocess=lambda *b: tuple(t.double() for t in preprocess(*b)))
            start = {k: p.detach().to("cpu", torch.float64, copy=True)
                     for k, p in net.named_parameters()}
            before = projected_weights(optimizer)
            loss = step(image.to(dev), keypoints.to(dev))
            grads, stats = _grads_and_stats(net)
            moved = {k: p.detach().double().cpu() - start[k] for k, p in net.named_parameters()}
            cos = float(radial_cosines(optimizer, before).max()) if radial else 0.0
            runs[side] = (loss.double().cpu(), grads, stats, moved, cos)
            del step, optimizer
        del gpu_net
        torch.cuda.empty_cache()
        gpu, cpu_run = runs["gpu"], runs["cpu"]
        loss_err = float(((gpu[0] - cpu_run[0]).abs() / cpu_run[0].abs()).max())
        grads = _errors(gpu[1], cpu_run[1])
        stats = _errors(gpu[2], cpu_run[2])
        diff = {k: (gpu[3][k] - cpu_run[3][k]).abs() for k in gpu[3]}
        max_lr = max(float(d.max()) for d in diff.values()) / lr
        mean_lr = sum(float(d.sum()) for d in diff.values()) / sum(
            d.numel() for d in diff.values()) / lr
        # Adam's first step moves each element by about lr
        step_lr = min(max(float(m.abs().max()) for m in run[3].values()) / lr
                      for run in (gpu, cpu_run))
        print(f"phase 36 (a) {name}, float64, batch {TRAIN_CPU_BATCH}, lr {lr}: loss "
              f"{gpu[0].tolist()} against the CPU's {cpu_run[0].tolist()} ({loss_err:.3e}); "
              f"{len(grads)} gradients {_summary(grads)}; {len(stats)} running statistics "
              f"{max(stats.values()):.3e} (bound {TRAIN_F64_RTOL} each); the largest move "
              f"{step_lr:.4f} lr; the update card-CPU: max {max_lr:.3e} lr, mean "
              f"{mean_lr:.3e} lr (bounds 2.02, 1e-2)"
              + (f"; projected filters' largest |cos(u, w)|: card {gpu[4]:.3e}, CPU "
                 f"{cpu_run[4]:.3e} (bound {RADIAL_COS_BOUND})" if radial else ""))
        if max(loss_err, max(grads.values()), max(stats.values())) > TRAIN_F64_RTOL:
            raise AssertionError(f"phase 36 (a) {name}: the card's float64 step disagrees with "
                                 "the CPU's")
        if (step_lr < 0.5 or max_lr > 2.02 or mean_lr > 1e-2
                or max(gpu[4], cpu_run[4]) > RADIAL_COS_BOUND):
            raise AssertionError(f"phase 36 (a) {name}: the update disagrees or is not "
                                 "projected")
        out[name] = {"loss_rel_err": loss_err, "grad_rel_err": max(grads.values()),
                     "stats_rel_err": max(stats.values()), "update_max_lr": max_lr,
                     "update_mean_lr": mean_lr, "cos": max(gpu[4], cpu_run[4])}
    return out


def divergent_entry(root: str, data: dict, device: torch.device) -> dict:
    """Phase 36 (b): hrnet_w32_tpu.yaml through the train entry with
    ``DIVERGENT_BACKBONE``, the radial projection and ``allow_divergent_knobs:
    true`` (batch 128, O2), one epoch of phase 12's data, evaluating after it.
    The entry's net and optimizer are recorded: every BatchNorm of the
    backbone in the mode, a ``RadialAdamW``, and at each step each projected
    filter's update orthogonal to it (``radial_cosines``, read by the
    optimizer's step hooks). Holds finite losses and one decode launch per
    val batch."""
    from mindpose_tpu_torch.models.common import BatchNorm2d
    from mindpose_tpu_torch.optim.optim_factory import RadialAdamW

    ckpt_dir = os.path.join(root, "divergent")
    args = recipe_args(RECIPE_YAML, data, ckpt_dir, device, "num_epochs=1",
                       f"warmup={INPUT_WARMUP}", "val_interval=1", "allow_divergent_knobs=True",
                       f"backbone_setting={DIVERGENT_BACKBONE!r}",
                       "optimizer_setting={'radial_projection': True}")
    seen = {"cos": []}
    make = train_entry.create_optimizer

    def create_optimizer_(*a, **kw):
        optimizer = make(*a, **kw)
        seen["optimizer"] = optimizer
        optimizer.register_step_pre_hook(
            lambda opt, *_: seen.update(before=projected_weights(opt)))
        def after(opt, *_):
            cos = radial_cosines(opt, seen["before"])
            if cos is not None:
                seen["cos"].append(cos.max())

        optimizer.register_step_post_hook(after)
        return optimizer

    train_entry.create_optimizer = create_optimizer_
    argmax_shift_decode.launches = 0
    start = time.perf_counter()
    try:
        with recording_entry(train_entry) as recorded:
            result = train_entry.train(args)
    finally:
        train_entry.create_optimizer = make
    seconds = time.perf_counter() - start
    launches = argmax_shift_decode.launches
    (epoch,) = result["epochs"]
    modes = {(m.stats_frac, m.grad_stats) for m in recorded["net"].backbone.modules()
             if isinstance(m, BatchNorm2d)}
    cos = float(torch.stack(seen["cos"]).max())
    projected = sum(len(g["params"]) for g in seen["optimizer"].param_groups
                    if g.get("radial_dim") is not None)
    val_batches = -(-ENTRY_VAL_IMAGES * ENTRY_PEOPLE // args.batch_size)
    print(f"phase 36 (b) the train entry, {DIVERGENT_BACKBONE}, radial projection, "
          f"allow_divergent_knobs: {epoch['steps']} steps, {epoch['images_per_sec']:.1f} img/s, "
          f"step median {epoch['step_median_s'] * 1e3:.1f} ms; loss {epoch['loss']:.6g}; AP "
          f"{float(epoch['metrics']['AP']):.6f}; backbone BatchNorm modes {sorted(modes)}; "
          f"{type(seen['optimizer']).__name__} projecting {projected} filters, largest "
          f"|cos(u, w)| over the {len(seen['cos'])} steps at a rate above 0 {cos:.3e} (bound "
          f"{RADIAL_COS_BOUND}); "
          f"decode kernel launches {launches} for {val_batches} val batch(es); {seconds:.1f} s")
    if not np.isfinite(epoch["loss"]) or modes != {(DIVERGENT_BACKBONE["bn_stats_frac"],
                                                    DIVERGENT_BACKBONE["bn_grad_stats"])}:
        raise AssertionError(f"phase 36 (b): loss {epoch['loss']}, BatchNorm modes {modes}")
    # the schedule's first step has rate 0 and moves nothing
    if (not isinstance(seen["optimizer"], RadialAdamW) or len(seen["cos"]) != epoch["steps"] - 1
            or not cos <= RADIAL_COS_BOUND):
        raise AssertionError(f"phase 36 (b): the updates are not projected ({cos})")
    if launches != val_batches:
        raise AssertionError(f"phase 36 (b): {launches} decode launches for {val_batches} val "
                             f"batch(es)")
    return {"launches": launches, "cos": cos, "seconds": seconds, "loss": epoch["loss"],
            "images_per_sec": epoch["images_per_sec"], "projected_filters": projected}


def time_divergent_variants(device: torch.device, gpu: str) -> dict:
    """Phase 36 (c): the recipe's step at batch 128, O2, constant lr, of each
    ``DIVERGENT_VARIANTS`` arm on a fresh full-width net (base first and
    last): ``DIVERGENT_WARMUP_STEPS`` warm-up steps, then
    ``DIVERGENT_TIMED_STEPS`` steps, each timed
    on the host clock up to a ``torch.cuda.synchronize``; the median ms."""
    n = HRNET_W32["batch_size"]
    image, keypoints = train_batch(np.random.RandomState(SEED + 1), n, device)
    out = {}
    for name in [*DIVERGENT_VARIANTS, "base"]:
        knobs, radial = DIVERGENT_VARIANTS[name]
        net = training_net(device, **knobs)
        step = recipe_step(net, HRNET_W32["amp_level"], radial_projection=radial)
        ms = []
        for _ in range(DIVERGENT_WARMUP_STEPS + DIVERGENT_TIMED_STEPS):
            start = time.perf_counter()
            loss = step(image, keypoints)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - start) * 1e3)
        if not bool(torch.isfinite(loss).all()):
            raise AssertionError(f"phase 36 (c) {name}: a non-finite loss")
        timed = ms[DIVERGENT_WARMUP_STEPS:]
        out.setdefault(name, []).append(statistics.median(timed))
        print(f"phase 36 (c) {name} ({knobs}, radial projection {radial}): B{n} "
              f"{HRNET_W32['amp_level']} step median {statistics.median(timed):.3f} ms over "
              f"{len(timed)} (min {min(timed):.3f}, max {max(timed):.3f}); "
              f"{n / statistics.median(timed) * 1e3:.1f} img/s")
        del step, net
        gc.collect()
        torch.cuda.empty_cache()
    base = statistics.mean(out["base"])
    print("phase 36 (c) against base (mean of its two runs, "
          + ", ".join(f"{b:.3f}" for b in out["base"]) + " ms): "
          + "; ".join(f"{k} {v[0]:.3f} ms ({v[0] / base:.3f}x)" for k, v in out.items()
                      if k != "base") + f"; {gpu}")
    return out


def divergent_knobs(root: str, data: dict, device: torch.device, gpu: str) -> dict:
    """Phase 36: (a), (b) and (c) of the divergent training knobs."""
    return {"with_cpu": divergent_step_with_cpu(device),
            "entry": divergent_entry(root, data, device),
            "ms": time_divergent_variants(device, gpu)}


def phases_process(phases: str, job_path: str) -> None:
    """Phases 34-35 ((b)-(e); (a) is ``start_bench``'s), 36 or 25 in a
    process of their own, started by ``run_phases`` beside the main
    process's phases: with the job's ``root`` (and ``data``, phase 12's, for
    36 and 25); writes the launch counts the kernels line takes to the job's
    ``out``."""
    with open(job_path) as f:
        job = json.load(f)
    device = torch.device("cuda", 0)
    gpu = gpu_name_and_power()
    print(f"phases {phases} beside the main process's phases on the same card: every time "
          f"below shares the card and the host's cores with them; {gpu}")
    start = time.perf_counter()
    if phases == "34-35":
        experiments = experiment_tools(job["root"], gpu)
        middle = time.perf_counter()
        print(f"time: phase 34 took {middle - start:.1f} s in its process")
        benched = bench_tools(job["root"], gpu)
        print(f"time: phase 35 (b)-(e) took {time.perf_counter() - middle:.1f} s in its process")
        result = {key: experiments[key] for key in
                  ("accuracy_launches", "warmstart_launches", "grouping_launches")}
        result["bench_tools_launches"] = benched["launches"]
    elif phases == "25":
        modes = input_modes_training(job["root"], job["data"], device)
        print(f"time: phase 25 took {time.perf_counter() - start:.1f} s in its process")
        result = {"input_modes_launches": modes["launches"]}
    elif phases == "36":
        divergent = divergent_knobs(job["root"], job["data"], device, gpu)
        print(f"time: phase 36 took {time.perf_counter() - start:.1f} s in its process")
        result = {"divergent_launches": divergent["entry"]["launches"]}
    else:
        raise ValueError(f"no phases {phases!r} run in a process of their own")
    with open(job["out"], "w") as f:
        json.dump(result, f)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    adopt_orphans()
    device = torch.device("cuda", 0)
    clock = {"start": time.perf_counter(), "last": time.perf_counter(), "background": None}

    def lap(phases: str) -> None:
        now = time.perf_counter()
        print(f"time: phases {phases} took {now - clock['last']:.1f} s "
              f"({now - clock['start']:.1f} s in all)")
        sharers = clock["background"].sharers(clock["last"], now) if clock["background"] else []
        if sharers:
            print(f"phases {phases} shared the card and the host's cores with: "
                  f"{'; '.join(sharers)} (each a process of its own): their times above are "
                  f"taken beside them")
        clock["last"] = now

    gpu = gpu_name_and_power()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    build_kernels()
    lap("1-2")

    decode_err = check_decode_bitwise(device)
    decode = time_decode(device)
    lap("3")

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
    lap("4-5")

    check_conv_chain(device)
    lap("6")
    probed = drive_probe(device)
    lap("7")

    evaluated = evaluation(net, device)
    del net
    torch.cuda.empty_cache()
    lap("8")

    phase9 = train_throughput(device)
    lap("9")

    # Phases 34-35 (b)-(e), 35 (a), 36, 26 (b)-27 (b) and 25 run in processes
    # of their own beside the main process's phases, never beside a phase
    # that times a kernel for the kernels line (3, 7, 8, 14, 16 and 24's
    # decode, which runs after 16) or beside phase 9, the one full timing of
    # the step; a lap over which one ran says so on a line of its own
    with contextlib.ExitStack() as stack:
        root = stack.enter_context(tempfile.TemporaryDirectory())
        pool, serial = ThreadPoolExecutor(3), ThreadPoolExecutor(1)
        for executor in (pool, serial):  # a failed phase ends the run without waiting
            stack.callback(executor.shutdown, wait=True, cancel_futures=True)
        background = clock["background"] = Background(pool, serial)
        tools = background.submit("phases 34-35 (b)-(e)", run_phases, "34-35", root, {})
        check_loss_falls(device)
        lap("10")
        compare_train_with_cpu(device)
        torch.cuda.empty_cache()
        lap("11")
        entry = train_through_entry(root, phase9, device)
        stop_worker_servers()
        torch.cuda.empty_cache()
        lap("12")
        trained = train_simple_baseline(root, entry["data"], device, UDP_YAML)
        torch.cuda.empty_cache()
        plain = train_simple_baseline(root, entry["data"], device, SB_YAML)
        torch.cuda.empty_cache()
        lap("13")
        sb_served = serve_simple_baseline(root, trained, device)  # before 14: no kernel timing
        torch.cuda.empty_cache()
        lap("15")
        tools = joined("phases 34-35 (b)-(e)", tools.result())  # before phase 14's timings
        lap("34-35 (b)-(e): the rest of their process")
        plain_eval = eval_checkpoint(root, plain, device, dark=False)
        sb_eval = eval_simple_baseline(root, trained, device)
        lap("14")
        grouped = check_grouping(device)
        lap("16")
        mpii_kernel = mpii_decode(device)
        lap("24 (a): the decode kernel at MPII's shapes")

        # phase 23 before the processes below start: its one loader thread
        # waited 0.9-1.9 s a step beside them
        rle = family_training(root, entry["data"], device, RLE_YAML)
        lap("23")

        # one at a time, in this order, beside phases 17-33: phase 36, the
        # torchrun process of 26 (b) and 27 (b) (on phase 21's data, written
        # here), tools/bench.py, phase 25
        vit_data = write_synthetic_coco(os.path.join(root, "vit_small"), VIT_SMALL_IMAGES,
                                        VIT_SMALL_VAL_IMAGES, ENTRY_PEOPLE)
        divergent = background.submit("phase 36", run_phases, "36", root,
                                      {"data": entry["data"]}, serial=True)
        torchrun = background.submit("phases 26 (b) and 27 (b): the torchrun process",
                                     launch_entries, root, entry["data"], vit_data, serial=True)
        bench = start_bench(root, background)
        inputs = background.submit("phase 25", run_phases, "25", root, {"data": entry["data"]},
                                   serial=True)
        bu_eval = bottomup_evaluation(root, device)
        lap("17")
        bu_served = serve_bottomup(root, bu_eval["ckpt"], device)
        torch.cuda.empty_cache()
        lap("18")
        bu_trained = bottomup_training(root, device)
        torch.cuda.empty_cache()
        lap("19")
        # phases 26 (a)'s and 27 (a)'s ranks start beside phase 20: they end
        # before 24 (b), whose MPII training takes the most memory of the
        # later phases
        ddp_ranks = start_ddp_ranks(root, device, background)
        fsdp_ranks = start_fsdp_ranks(root, background)
        vit = vitpose_training(root, entry["data"], device)
        torch.cuda.empty_cache()
        lap("20")
        vit_recipes = vitpose_recipes(root, vit_data, device)
        torch.cuda.empty_cache()
        lap("21")
        simcc = family_training(root, entry["data"], device, SIMCC_YAML)
        lap("22")
        mpii_run = mpii_training(root, device)
        torch.cuda.empty_cache()
        lap("24 (b)")
        ddp_on_one_card(device, ddp_ranks)
        torch.cuda.empty_cache()
        lap("26 (a)")
        fsdp_on_one_card(device, fsdp_ranks)
        torch.cuda.empty_cache()
        lap("27 (a)")
        distilled = distill_training(root, entry["data"], device)
        torch.cuda.empty_cache()
        lap("28")
        remat_step(device)
        torch.cuda.empty_cache()
        lap("29")
        int8 = int8_serving(root, device)
        torch.cuda.empty_cache()
        lap("30")
        exported = export_serving(root, int8["ckpt"], SB_YAML, plain["ckpt"], device)
        torch.cuda.empty_cache()
        lap("31")
        demoed = demos(root, entry["data"],
                       os.path.join(root, "entry", "hrnet_w32_tpu_last.ckpt"),
                       bu_eval["ckpt"], device)
        torch.cuda.empty_cache()
        lap("32")
        visual = visual_tools(root, entry["data"],
                              os.path.join(root, "entry", "hrnet_w32_tpu_last.ckpt"),
                              bu_eval["ckpt"])
        resized = resize_evaluation(root, entry["data"], bu_eval["ckpt"], device)
        torch.cuda.empty_cache()
        photometric = photometric_training(root, device)
        torch.cuda.empty_cache()
        native_evaluator(root, evaluated, gpu)
        lap("33")
        divergent = joined("phase 36", divergent.result())
        benched = bench_report(bench)
        torchrun.result()
        lap("36, 35 (a), 26 (b) and 27 (b): the rest of their processes")
        ddp = ddp_entry(root, device, entry)
        lap("26 (b)")
        fsdp = fsdp_entry(root, vit_data, device)
        torch.cuda.empty_cache()
        lap("27 (b)")
        input_modes = joined("phase 25", inputs.result())
        lap("25: the rest of its process")
    check_no_processes_left()
    print(f"time: the whole run took {time.perf_counter() - clock['start']:.1f} s by its clock")
    vit_launches = {"vitpose_b_tpu": {key: vit[key] for key in
                                      ("launches", "eval_launches", "serve_launches")},
                    **{name: {key: r[key] for key in
                              ("launches", "eval_launches", "serve_launches")}
                       for name, r in vit_recipes.items()},
                    # phase 27 (b): rank 0's callback, then the eval and serving entries
                    "vitpose_h_tpu": {key: fsdp[key] for key in
                                      ("launches", "eval_launches", "serve_launches")}}

    mpii_launches = {key: mpii_run[key] for key in ("launches", "eval_launches",
                                                    "serve_launches")}
    print(f"SimCC and RLE (phases 22-23): decode kernel launches "
          f"{simcc['host']['launches'] + rle['host']['launches']} (they decode without it); "
          f"MPII (phase 24): {mpii_launches}")

    # the conv chain's numbers at the train step's geometry (HRNet-W32 branch 0, batch 128)
    chain = next(r for r in probed["rows"] if r["b"] == HRNET_W32["batch_size"])
    warm_ms, plain_ms = decode[(BATCH_SIZE, False, True)]
    timed = grouped["timed"][str(BATCH_SIZE)]
    # phase 35: tools/bench.py's own process's and bench_serve's (phases 34-35's process)
    bench_launches = benched["extra"]["decode_kernel_launches"] + tools["bench_tools_launches"]
    kernels = [{
        "name": "argmax_shift_decode",
        "route": "cuda",
        "source": "mindpose_tpu_torch/csrc/decode.cu",
        "replaces": "mindpose_tpu/ops/pallas/decode.py:27",
        # serving's launches, evaluation's (phases 8 and 14), the training
        # entry's callbacks' (phases 12 and 13: one per eval batch), the DARK
        # evaluation's (phase 14), the serving entry's (phase 15),
        # ViTPose's (phases 20 and 21: callbacks, the eval entry, serving),
        # the later phases' below, and int8 serving's, the artifact's and the
        # demos' (phases 30-32)
        "launches": (served["launches"] + evaluated["launches"] + entry["launches"]
                     + trained["launches"] + plain["launches"] + plain_eval["launches"]
                     + sb_eval["launches"] + sb_eval["dark_launches"] + sb_served["launches"]
                     + sum(sum(r.values()) for r in vit_launches.values())
                     + sum(mpii_launches.values()) + input_modes["input_modes_launches"]
                     + ddp["launches"] + distilled["launches"] + int8["launches"]
                     + exported["launches"] + demoed["launches"]
                     + visual["topdown"]["launches"] + photometric["launches"]
                     + tools["accuracy_launches"] + tools["warmstart_launches"]
                     + bench_launches + divergent["divergent_launches"]),
        "vitpose_launches": vit_launches,
        # phase 24: the MPII callback's (1 per eval batch), the eval entry's
        # (1 per batch) and the serving entry's (1 per 32-crop chunk)
        "mpii_launches": mpii_launches,
        # phase 25: the callback's evaluation of each input mode's run (1 batch each)
        "input_modes_launches": input_modes["input_modes_launches"],
        # phase 26 (b): rank 0's callback under torchrun (1 per eval batch)
        "ddp_entry_launches": ddp["launches"],
        # phase 27 (b): rank 0's callback on its unsharded copy under torchrun
        # (1 per eval batch; also in vitpose_launches)
        "fsdp_entry_launches": fsdp["launches"],
        # phase 28: the distillation run's callback (1 per eval batch)
        "distill_launches": distilled["launches"],
        # phase 30: int8 serving (1 per 32-crop chunk); phase 31: the loaded
        # artifact (1 per call, batches 1, 5 and 32); phase 32: the top-down
        # demo (1 per image) and the video demo (1 per frame)
        "int8_launches": int8["launches"],
        "export_launches": exported["launches"],
        "demo_launches": demoed["launches"],
        # phase 33: the top-down visualisation tool (1 per sample) and the
        # photometric-distortion run's callback (1 per eval batch)
        "visual_launches": visual["topdown"]["launches"],
        "photometric_launches": photometric["launches"],
        # phase 34: ablate_accuracy's evaluation and exp_warmstart's (1 per eval batch)
        "experiment_launches": tools["accuracy_launches"] + tools["warmstart_launches"],
        # phase 35: bench_decode in tools/bench.py's process (1 per call:
        # 1 warm, 50 single, 5 x 100 back to back: 551) and bench_serve's
        # heatmap presets (1 per request of at most 32 boxes: a warm and
        # BENCH_ITERS timed requests at 1, 8 and 32 boxes, 6 for each of
        # resnet50, hrnet_w32, vit_b and hrnet_w32 int8; 9 each, and 688 in
        # all, before BENCH_ITERS went from 2 to 1), this phase's own count
        "bench_tools_launches": bench_launches,
        # phase 36 (b): the divergent knobs' run through the entry, its
        # callback's evaluation (1 per eval batch)
        "divergent_launches": divergent["divergent_launches"],
        "eval_launches": evaluated["launches"] + plain_eval["launches"] + sb_eval["launches"],
        "train_eval_launches": entry["launches"] + trained["launches"] + plain["launches"],
        "dark_launches": sb_eval["dark_launches"],
        "serve_entry_launches": sb_served["launches"],
        "eval_batches": evaluated["batches"],
        "max_abs_err": max(decode_err, mpii_kernel["max_abs_err"]),
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
        # phase 24, MPII's [N,16,64,64] with the shift on, N = 32 and 128:
        # the kernel warm and cold in L2, the whole decoder (back-projection
        # on), the plain version, torch.max and the bound
        "mpii_shift_on": {str(n): mpii_kernel[n] for n in (BATCH_SIZE, 128)},
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
    }, {
        "name": "tag_grouping",
        "route": "cuda",
        "source": "mindpose_tpu_torch/csrc/grouping.cu",
        # the JAX package's fixed-capacity matcher under jit; no Pallas kernel
        "replaces": "mindpose_tpu/ops/grouping.py:109",
        # bottom-up evaluation (phase 17: one per batch, the fixture's and the
        # recipe's), serving (phase 18: one per request) and the train entry's
        # callbacks (phase 19: one per eval batch), and the bottom-up demo
        # (phase 32: one per image)
        "launches": (bu_eval["launches"] + bu_served["launches"] + bu_trained["launches"]
                     + demoed["grouping_launches"] + visual["ae"]["grouping_launches"]
                     + resized["launches"] + tools["grouping_launches"]),
        "eval_launches": bu_eval["launches"],
        "serve_launches": bu_served["launches"],
        "train_eval_launches": bu_trained["launches"],
        "demo_launches": demoed["grouping_launches"],
        # phase 33: the AE visualisation tool (1 per sample) and the
        # bottom-up evaluation with bottomup_resize (1 per frame, batch 1)
        "visual_launches": visual["ae"]["grouping_launches"],
        "resize_eval_launches": resized["launches"],
        # phase 34: exp_grouping's device arm (1 per eval batch)
        "experiment_launches": tools["grouping_launches"],
        "resize_eval_ap": resized["ap"],
        "sets_checked": grouped["sets"],
        "max_abs_err": grouped["max_abs_err"],
        # per batch of 32 images at the recipe's settings (L=1, rounded norm),
        # the timed batch: the kernel's device time; the plain version's and
        # the host Hungarian's host time
        "ms": timed["ms"],
        "ms_batch_1": grouped["timed"]["1"]["ms"],
        "plain_ms": grouped["plain_ms"],
        # the larger of the bytes' time and the dependent chain's: the
        # largest image's LSAP iterations x the step floor
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": grouped["library_ms"],
        "bytes_bound_ms": timed["bytes_ms"],
        "chain_bound_ms": timed["chain_ms"],
        "step_floor_ms": grouped["step_floor_ms"],
        "max_iterations": timed["max_iterations"],
        # each kind of SETS, 32 images from a fresh RandomState(0): iterations
        # per image, and per batch of 1 and 32 the time, bound and share
        "kinds": {name: {"iterations_mean": r["iterations_mean"],
                         **{key: r[key] for key in ("1", str(BATCH_SIZE))}}
                  for name, r in grouped["kinds"].items()},
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
    if sys.argv[1:2] == ["--ddp-rank"]:  # phase 26 (a): one rank
        rank, world, port = map(int, sys.argv[2:5])
        ddp_rank(rank, world, port, sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--torchrun-entries"]:  # phases 26 (b), 27 (b): torchrun's process
        torchrun_entries(sys.argv[2])
        sys.exit(0)
    if sys.argv[1:2] == ["--fsdp-rank"]:  # phase 27 (a): one rank
        rank, world, port = map(int, sys.argv[2:5])
        fsdp_rank(rank, world, port, sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--phases"]:  # phases 34-35, 36 or 25 in a process of their own
        phases_process(sys.argv[2], sys.argv[3])
        sys.exit(0)
    try:
        code = main()
    finally:
        stop_worker_servers()
    sys.exit(code)
