"""Go/no-go: the hand-written CUDA conv chain against cuDNN at the C=32 geometries.

Counterpart of ``tools/ablate_pallas_chain.py``, which asked on the TPU
whether keeping a chain of 3x3 C=32 convs on chip beats XLA's per-conv
chain. The same question on one NVIDIA GPU: ``fused_conv_chain``
(``csrc/conv_chain.cu``) against ``conv_chain_plain`` (cuDNN through
``F.conv2d``), at the same three geometries, depth 8, bf16, from the same
numpy draws (``rand * 2 - 1`` inputs, ``rand * 0.1`` weights, one
``RandomState(0)`` drawn in geometry order). For each it prints the time per
chain (CUDA events), TFLOP/s, and reldiff = max|kernel - plain| / max|plain|.

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

from ..ops.cuda.conv_chain import conv_chain_plain, fused_conv_chain

__all__ = ["DEPTH", "GEOMETRIES", "run", "time_ms"]

DEPTH = 8
# (tag, batch, height, width, channels): the three C=32 geometries of the TPU probe
GEOMETRIES = (
    ("B24 128x128 (bottomup s1)", 24, 128, 128, 32),
    ("B24 256x256 (bu head chain)", 24, 256, 256, 32),
    ("B128 64x48 (topdown branch0)", 128, 64, 48, 32),
)
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "ablate_conv_chain.json"


def time_ms(fn, iters: int, repeats: int = 3) -> float:
    """Median over ``repeats`` of the time per call of ``iters`` calls (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


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

    plain = conv_chain_plain(x, ws).float()
    kernel = fused_conv_chain(x, ws).float()
    scale = float(plain.abs().max()) or 1.0
    max_abs_diff = float((kernel - plain).abs().max())
    reldiff = max_abs_diff / scale
    finite = bool(torch.isfinite(kernel).all())
    plain_ms = time_ms(lambda: conv_chain_plain(x, ws), iters)
    kernel_ms = time_ms(lambda: fused_conv_chain(x, ws), iters)
    for impl, ms in (("cudnn chain", plain_ms), ("cuda kernel", kernel_ms)):
        print(f"{tag:30s} {impl:12s} {ms:9.3f} ms {gflop / ms:7.2f} TFLOP/s", flush=True)
    print(f"{tag:30s} reldiff={reldiff:.3e} (max|plain| {scale:.4g}), kernel finite: {finite}",
          flush=True)
    return {"tag": tag, "b": b, "h": h, "w": w, "c": c, "depth": DEPTH, "gflop": gflop,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "kernel_tflops": gflop / kernel_ms, "plain_tflops": gflop / plain_ms,
            "max_abs_diff": max_abs_diff, "reldiff": reldiff, "finite": finite, "iters": iters}


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
