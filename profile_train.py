#!/usr/bin/env python3
"""Where the PyTorch port's train-step time goes, on one CUDA GPU.

Usage (from the root of a checkout, on the machine chip_smoke.py runs on):

    python3 profile_train.py [--recipe configs/vitpose/vitpose_b_tpu.yaml] [--trace-dir DIR]

It builds chip_smoke.py's train step (hrnet_w32_tpu.yaml: full-width
HRNet-W32 + hrnet_head, adamw with the warmup multi-step schedule, O2, batch
128 of synthetic crops), or with ``--recipe`` a top-down recipe's own (its
net at full width with random weights from a numpy seed, the ViT's as
chip_smoke.py draws them; its optimizer, schedule, amp level, batch size,
``grad_accum_steps`` and targets; synthetic crops), and prints:
- over 20 steps without the profiler: the step time (host clock up to a
  device synchronisation) and the host's issue time (until the step's call
  returns, before that synchronisation), median, min and max;
- under torch.profiler over 3 steps, all from the one trace: the
  wall time of those steps, the device's busy time (the union of its kernel
  intervals) and so its busy share, the device span (first kernel start to
  last kernel end), device operations per step, the host's time inside CUDA
  launch calls, and device time by kind of kernel and by kernel name (a
  Chrome trace in DIR, if given).
The profiler records device activity only (CUPTI), not the host's operators,
so that it slows the host little; the wall time per step under it is printed
beside the step time without it. Annotation ranges (``Optimizer.step``) are
not kernels and are left out of the device time.
"""
import argparse
import os
import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from mindpose_tpu_torch.config import parse_args
from mindpose_tpu_torch.data.device_pipeline import (
    build_topdown_preprocess,
    strip_host_target_transform,
)
from mindpose_tpu_torch.models import create_loss, create_network_from_config
from mindpose_tpu_torch.models import create_network_with_loss
from mindpose_tpu_torch.models.backbones.vit import ViT
from mindpose_tpu_torch.optim import create_optimizer
from mindpose_tpu_torch.parallel import build_train_step
from mindpose_tpu_torch.scheduler import create_lr_scheduler

STEPS = 20
TRACED_STEPS = 3
# kinds of device operation, by the first pattern found in the kernel's name
KINDS = (
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("softmax", ("softmax",)),
    ("layer norm", ("layer_norm",)),
    ("gelu", ("gelu", "GeluCUDA")),
    ("convolutions and matmuls", ("conv", "xmma", "cutlass", "gemm", "sm90_", "dgrad", "wgrad",
                                  "fprop", "nvjet")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("elementwise", ("elementwise", "CatArray", "index")),
    ("memset / memcpy", ("Memset", "Memcpy", "memset", "memcpy")),
)


def kind_of(name: str) -> str:
    for kind, patterns in KINDS:
        if any(p in name for p in patterns):
            return kind
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def unprofiled(step, batch) -> None:
    issue, wall = [], []
    for _ in range(STEPS):
        start = time.perf_counter()
        step(*batch)
        issued = time.perf_counter()
        torch.cuda.synchronize()
        done = time.perf_counter()
        issue.append((issued - start) * 1e3)
        wall.append((done - start) * 1e3)
    for what, v in (("step", wall), ("host issue", issue)):
        print(f"{what} time over {STEPS} steps, no profiler: median {statistics.median(v):.3f} "
              f"ms (min {min(v):.3f}, max {max(v):.3f})")


def profiled(step, batch, trace_dir: str) -> None:
    steps = TRACED_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = busy_us(spans)
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    launches = [e.time_range.elapsed_us() for e in events
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                               "cuLaunchKernelEx")]
    print(f"{steps} steps under the profiler: wall {wall_us / steps / 1e3:.3f} ms per step, device "
          f"busy {busy / steps / 1e3:.3f} ms per step = {100 * busy / wall_us:.1f}% of the wall, "
          f"{100 * busy / span:.1f}% of the device span ({span / steps / 1e3:.3f} ms per step); "
          f"{len(kernels) / steps:.0f} device operations per step; host in "
          f"{len(launches) / steps:.0f} launch calls {sum(launches) / steps / 1e3:.3f} ms per step")
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        for table, key in ((by_kind, kind_of(e.name)), (by_name, e.name)):
            entry = table.setdefault(key, [0.0, 0])
            entry[0] += us
            entry[1] += 1
    total = sum(us for us, _ in by_kind.values())
    print("device time by kind, per step:")
    for kind, (us, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"   {us / steps / 1e3:9.3f} ms  {100 * us / total:5.1f}%  x{n / steps:.0f}  {kind}")
    print("kernels that take most device time, per step:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"   {us / steps / 1e3:9.3f} ms  x{n / steps:.0f}  [{kind_of(name)}]  {name[:100]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "train_step.json"))


def recipe_train_step(path: str, device: torch.device):
    """A top-down recipe's train step on the device and its batch size."""
    args = parse_args(["--config", path])
    ds = args.dataset_setting
    net = create_network_from_config(args)
    if isinstance(net.backbone, ViT):
        net.backbone.load_state_dict(
            cs.random_vit_backbone(args.backbone_name, ds["image_size"]).state_dict())
    net.to(device)
    optimizer = create_optimizer(net, args.optimizer, learning_rate=args.lr,
                                 weight_decay=args.weight_decay,
                                 filter_bias_and_bn=args.filter_bias_and_bn,
                                 **args.optimizer_setting)
    schedule = create_lr_scheduler(args.scheduler, lr=args.lr, total_epochs=args.num_epochs,
                                   steps_per_epoch=cs.STEPS_PER_EPOCH, warmup=args.warmup,
                                   **args.lr_scheduler_setting)
    _, target_kwargs = strip_host_target_transform(args.train_transforms)
    preprocess = build_topdown_preprocess(ds["image_size"], ds["heatmap_size"],
                                          args.normalize_mean, args.normalize_std,
                                          **target_kwargs)
    net_with_loss = create_network_with_loss(net, create_loss(args.loss, **args.loss_setting),
                                             has_extra_inputs=args.loss_with_extra_input)
    accum = int(getattr(args, "grad_accum_steps", 1) or 1)
    print(f"{os.path.basename(path)}: {args.backbone_name} + {args.head_name}, "
          f"{args.amp_level}, batch {args.batch_size} in {accum} microbatch(es), "
          f"{args.optimizer} {args.optimizer_setting}")
    return build_train_step(net_with_loss, optimizer, schedule, preprocess=preprocess,
                            accum_steps=accum, amp_level=args.amp_level), args.batch_size


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--recipe", default="", help="a top-down recipe's step instead")
    parser.add_argument("--trace-dir", default="", help="write a Chrome trace here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    device = torch.device("cuda", 0)
    print(f"gpu: {cs.gpu_name_and_power()}; torch {torch.__version__}")
    if args.recipe:
        step, batch_size = recipe_train_step(args.recipe, device)
    else:
        net = cs.training_net(device)
        step = cs.recipe_step(net, cs.HRNET_W32["amp_level"], cs.recipe_schedule())
        batch_size = cs.HRNET_W32["batch_size"]
    batch = cs.train_batch(np.random.RandomState(cs.SEED + 1), batch_size, device)
    for _ in range(cs.TRAIN_WARMUP_STEPS):
        step(*batch)
    unprofiled(step, batch)
    profiled(step, batch, args.trace_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
