"""Go/no-go: the hand-written CUDA conv chain against cuDNN at the C=32 geometries.

Counterpart of ``tools/ablate_pallas_chain.py``, which asked on the TPU
whether keeping a chain of 3x3 C=32 convs on chip beats XLA's per-conv
chain. The same question on one NVIDIA GPU: ``fused_conv_chain``
(``csrc/conv_chain.cu``, the tensor-core kernel at bf16) against
``conv_chain_plain`` (cuDNN through ``F.conv2d``, then ReLU), at the same
three geometries, depth 8, bf16, from the same numpy draws (``rand * 2 - 1``
inputs, ``rand * 0.1`` weights, one ``RandomState(0)`` drawn in geometry
order). For each it prints and records:
- the time per chain as a caller sees it (calls back to back) and the
  device time (calls queued behind a GPU busy-wait, so the host's ~25 us per
  Python call does not hide a ~0.1 ms kernel), CUDA events;
- the kernel's device time for each number of layers fused per launch in
  ``GROUPS`` (the wrapper runs ``FUSED_LAYERS``, one of them);
- TFLOP/s, the bound (``bound``: the chain's FLOP at 989 TFLOP/s dense
  bf16, which exceeds one pass over its bytes at 3.35 TB/s) and the
  fraction of it reached;
- reldiff = max|kernel - plain| / max|plain|.

Run on a machine with a CUDA GPU and the CUDA toolkit, from the root of a
checkout:

    python3 -m mindpose_tpu_torch.tools.ablate_conv_chain [--iters N] [--out PATH]

It writes its rows as JSON to ``chiprun_out/ablate_conv_chain.json`` unless
``--out`` says otherwise.
"""
import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.cuda.conv_chain import (
    FUSED_LAYERS, _launch, conv_chain_plain, fused_conv_chain, split_layers,
)

__all__ = ["DEPTH", "GEOMETRIES", "GROUPS", "PEAK_BF16_TFLOPS", "HBM_TB_S", "bound", "run",
           "time_ms"]

DEPTH = 8
# layers fused per launch, each timed
GROUPS = (1, 2, 4)
# H100 SXM (NVIDIA's data sheet, at 700 W): dense bf16 on the tensor cores, HBM3
PEAK_BF16_TFLOPS = 989.0
HBM_TB_S = 3.35
# (tag, batch, height, width, channels): the three C=32 geometries of the TPU probe
GEOMETRIES = (
    ("B24 128x128 (bottomup s1)", 24, 128, 128, 32),
    ("B24 256x256 (bu head chain)", 24, 256, 256, 32),
    ("B128 64x48 (topdown branch0)", 128, 64, 48, 32),
)
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "ablate_conv_chain.json"


def time_ms(fn, iters: int, queued: bool, repeats: int = 3) -> float:
    """Median over ``repeats`` of the time per call of ``iters`` calls (CUDA events).

    ``queued``: the calls wait behind a ~50 ms busy-wait on the GPU, so the
    host has queued them all before the first runs and the events time the
    device alone (as ``chip_smoke.time_ms(queued=True)``). Otherwise they
    run back to back as a caller issues them.
    """
    for _ in range(2):
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


def bound(b: int, h: int, w: int, c: int, depth: int = DEPTH) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take for
    a bf16 chain, the larger of its FLOP at the bf16 peak and one read of x
    and the weights plus one write of the output at the HBM rate."""
    flop_ms = 2 * b * h * w * 9 * c * c * depth / PEAK_BF16_TFLOPS / 1e9
    byte_ms = 2 * (2 * b * h * w * c + depth * 9 * c * c) / HBM_TB_S / 1e9
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms, "bytes")


def run(tag: str, b: int, h: int, w: int, c: int, rng: np.random.RandomState,
        iters: int = 10, device: torch.device = torch.device("cuda")) -> dict:
    """Draw one geometry's inputs from ``rng``, compare and time kernel and plain chain."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"the probe times the CUDA kernel; got device {device}")
    x = torch.from_numpy(rng.rand(b, h, w, c).astype(np.float32) * 2 - 1)
    ws = torch.from_numpy(rng.rand(DEPTH, 3, 3, c, c).astype(np.float32) * 0.1)
    x = x.to(device).bfloat16()
    ws = ws.to(device).bfloat16()
    gflop = 2 * b * h * w * 9 * c * c * DEPTH / 1e9

    bound_ms, bound_by = bound(b, h, w, c)
    group = FUSED_LAYERS

    plain = conv_chain_plain(x, ws).float()
    kernel = fused_conv_chain(x, ws).float()
    scale = float(plain.abs().max()) or 1.0
    max_abs_diff = float((kernel - plain).abs().max())
    reldiff = max_abs_diff / scale
    finite = bool(torch.isfinite(kernel).all())
    row = {"tag": tag, "b": b, "h": h, "w": w, "c": c, "depth": DEPTH, "gflop": gflop,
           "bound_ms": bound_ms, "bound_by": bound_by, "group": group, "max_abs_diff": max_abs_diff,
           "reldiff": reldiff, "finite": finite, "iters": iters}
    for queued, suffix in ((False, "ms"), (True, "device_ms")):
        row[f"plain_{suffix}"] = time_ms(lambda: conv_chain_plain(x, ws), iters, queued)
        row[f"kernel_{suffix}"] = time_ms(lambda: fused_conv_chain(x, ws), iters, queued)
    row["group_device_ms"] = {
        g: time_ms(lambda: _launch(x, ws, split_layers(DEPTH, g)), iters, queued=True)
        for g in GROUPS}
    for impl, ms, dev in (("cudnn chain", row["plain_ms"], row["plain_device_ms"]),
                          ("cuda kernel", row["kernel_ms"], row["kernel_device_ms"])):
        print(f"{tag:30s} {impl:12s} {ms:9.4f} ms per call, {dev:9.4f} ms device "
              f"{gflop / dev:7.2f} TFLOP/s, {bound_ms / dev:.3f} of the bound {bound_ms:.4f} ms",
              flush=True)
    print(f"{tag:30s} kernel device ms by layers per launch: "
          + ", ".join(f"g={g} {ms:.4f}" for g, ms in row["group_device_ms"].items())
          + f" (the rule takes g={group})", flush=True)
    print(f"{tag:30s} reldiff={reldiff:.3e} (max|plain| {scale:.4g}), kernel finite: {finite}",
          flush=True)
    row.update(kernel_tflops=gflop / row["kernel_device_ms"],
               plain_tflops=gflop / row["plain_device_ms"],
               kernel_bound_fraction=bound_ms / row["kernel_device_ms"],
               plain_bound_fraction=bound_ms / row["plain_device_ms"])
    return row


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=10, help="calls per timing")
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_conv_chain: no CUDA device; the probe runs only on a GPU", file=sys.stderr)
        return 1
    card = _card()
    print(f"gpu: {card}")
    rng = np.random.RandomState(0)
    rows = [run(*g, rng=rng, iters=args.iters) for g in GEOMETRIES]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"gpu": card, "rows": rows}, indent=2))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
