"""Speed-of-light budget: per-part FLOPs / bytes / ridge class / bound on the H100.

Counterpart of ``tools/budget_table.py``. For each part of the HRNet-W32
256x192 train step at batch 128 (the stem, stages 1-4 and the head as
forward+backward programs with respect to their parameters and input, at
the widths of ``tools/profile_parts.py``'s decomposition; the ``joint_mse``
loss's backward; adamw over HRNet-W32's parameters; the full step) it
counts the FLOPs and the bytes of one call, times the call, and sets each
part against the roofline of the card:

    AI = FLOPs / bytes;  ridge = PEAK_FLOPS / PEAK_BW  (~295 FLOP/byte)
    bound_ms = max(FLOPs / PEAK_FLOPS, bytes / PEAK_BW)

with the H100's published dense peaks (SXM part at 700 W: 989 TFLOP/s in
bf16, 3.35 TB/s of HBM); the JSON names the card and its power limit as
``nvidia-smi`` reports them.

Two byte counts, two bounds. ``bytes`` is the eager program's own traffic
(below), so ``bound_ms`` and ``pct_of_bound`` (JAX's keys) give the share
of this implementation's bound, its eager traffic share: a fusion that
moves fewer bytes lowers the bound with the time. ``min_bytes`` is the
least the part's function needs, from the shapes: each input, parameter
and optimizer state read once and each gradient, updated parameter and
state written once, at the dtype it is stored in (a fwd+bwd part: 2 x (x +
parameters); the loss: the heatmaps, targets and weights and the heatmaps'
gradient; adamw: 7 x the parameters; the full step: the batch, and the
parameters, adamw's two states and BatchNorm's statistics read and
written). ``min_bound_ms`` = max(FLOPs / PEAK_FLOPS, min_bytes / PEAK_BW)
and ``pct_of_min_bound`` are the roofline share, which a fusion can raise.

How the counts differ from the JAX tool's. XLA's ``cost_analysis`` counts
the compiled program after fusion: every HLO operation's FLOPs
(elementwise ones included) and the bytes of each fused kernel's operands
and results. Here one eager call runs under
``torch.utils.flop_counter.FlopCounterMode``, which counts convolutions and
matrix products only (2 FLOPs a multiply-add; a backward adds the input's
and the weight's gradient, each as many as the forward), so the loss and
optimizer rows count no FLOPs and are bound by their bytes; and under a
``TorchDispatchMode`` that keys every tensor it sees by its storage and
counts each storage the call reads once and each it writes once (over the
extent of it the call touches): the guide's rule for a bound, and what HBM
must move whatever each kernel re-reads. Autocast's bf16 copies of the
weights and inputs, the activations kept for the backward and an eager
optimizer's temporaries are storages of their own and count. A stage
computes only the branch outputs its result uses: its last exchange unit
fuses into the highest-resolution branch alone (the JAX program's other
fusions are dead code that XLA removes), so every conv there runs forward
and backward and the stage's FLOPs are 3x its forward convolutions'
(``tests/test_torch_bench_tools.py`` holds each conv part to that count
from the shapes). XLA's cost analysis of the JAX tool's programs on the
CPU, at batch 2 and the parts' full shapes in float32, against this count:
the stem 1.0224x (1,649,884,288 FLOPs against 1,613,758,464), stage 1
1.0406x (its elementwise operations), stage 2 0.9865x, the head 0.6667x
(XLA folds the gradient of a sum through the 1x1 conv into reductions,
where the port runs the conv's two backward products). Each call is timed
as the JAX tool times it: one warm call, then ``--iters`` calls by the
host's clock with one ``torch.cuda.synchronize`` at the end.

    python3 -m mindpose_tpu_torch.tools.budget_table [--batch 128] [--iters 20] \\
        [--out budget_h100.json] [--device cpu]
"""
import copy
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..models import create_loss, create_network, create_network_with_loss
from ..models.common import frozen_statistics
from ..optim import create_optimizer
from ..parallel import build_train_step
from .ablate_step import autocast
from .profile_parts import Head, Stage1, StageN, Stem
from .timing import device_parser, gpu_name_and_power, resolve_device, sync

__all__ = ["PEAK_FLOPS", "PEAK_BW", "RIDGE", "BACKBONE", "WIDTH", "IMAGE", "HEATMAP",
           "StorageBytes", "count", "nbytes", "measure", "fwd_bwd_program", "parts", "main"]

# NVIDIA H100 SXM (700 W), dense: bf16 tensor-core peak and HBM3 bandwidth
PEAK_FLOPS = 989e12
PEAK_BW = 3.35e12
RIDGE = PEAK_FLOPS / PEAK_BW
AMP_LEVEL = "O2"  # the JAX tool's bf16 modules
BACKBONE = "hrnet_w32"
WIDTH = 32  # HRNet-W32's branch-0 width
IMAGE = (256, 192)  # H, W
HEATMAP = (64, 48)

# ops that overwrite their mutated argument without reading it
_WRITE_ONLY = ("aten::copy_", "aten::zero_", "aten::fill_", "aten::normal_", "aten::uniform_",
               "aten::bernoulli_", "aten::random_", "aten::set_")


def _tensors(value) -> List[torch.Tensor]:
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for t in value if isinstance(t, torch.Tensor)]
    return []


def _extent(t: torch.Tensor):
    """(storage key, first byte, end byte) of the part of its storage ``t`` spans."""
    if t.numel() == 0 or t.layout != torch.strided:
        return None
    size = t.element_size()
    start = t.storage_offset() * size
    span = sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride())) + 1
    return t.untyped_storage().data_ptr(), start, start + span * size


class StorageBytes(TorchDispatchMode):
    """Bytes a call moves: each storage it reads counted once, each it writes
    once, over the hull of the extents touched. A fresh output at an address
    seen before is a new storage (the old one was freed and its bytes stay
    counted); views and allocations move nothing."""

    def __init__(self) -> None:
        super().__init__()
        self.live = {"read": {}, "write": {}}
        self.done = {"read": 0, "write": 0}

    def _touch(self, kind: str, t: torch.Tensor) -> None:
        e = _extent(t)
        if e is None:
            return
        key, lo, hi = e
        seen = self.live[kind].get(key)
        self.live[kind][key] = (lo, hi) if seen is None else (min(seen[0], lo), max(seen[1], hi))

    def _fresh(self, t: torch.Tensor) -> None:
        e = _extent(t)
        if e is None:
            return
        for kind in ("read", "write"):
            seen = self.live[kind].pop(e[0], None)
            if seen is not None:
                self.done[kind] += seen[1] - seen[0]

    def total(self, kind: str) -> int:
        return self.done[kind] + sum(hi - lo for lo, hi in self.live[kind].values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        schema = func._schema
        mutated = []
        read = []
        for i, arg in enumerate(schema.arguments):
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            ts = _tensors(value)
            if arg.alias_info is not None and arg.alias_info.is_write:
                mutated.append((arg.name, ts))
            else:
                read += ts
        returns = list(zip(schema.returns, _tensors(out) if isinstance(out, (list, tuple))
                           else [out] if isinstance(out, torch.Tensor) else []))
        if not mutated and returns and all(r.alias_info is not None for r, _ in returns):
            return out  # a view
        if schema.name.startswith(("aten::empty", "aten::new_empty")):
            for _, t in returns:
                self._fresh(t)
            return out
        for t in read:
            self._touch("read", t)
        for name, ts in mutated:
            for t in ts:
                if name != "out" and schema.name not in _WRITE_ONLY:
                    self._touch("read", t)
                self._touch("write", t)
        for r, t in returns:
            if r.alias_info is None:
                self._fresh(t)
                self._touch("write", t)
        return out


def count(fn: Callable, args: Sequence) -> tuple:
    """(FLOPs, bytes read + written) of one call of ``fn(*args)``."""
    flops = FlopCounterMode(display=False)
    with flops, StorageBytes() as moved:
        fn(*args)
    return float(flops.get_total_flops()), float(moved.total("read") + moved.total("write"))



def nbytes(tensors) -> int:
    """The bytes ``tensors`` hold, each once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def measure(name: str, fn: Callable, args: Sequence, iters: int, rows: List[Dict],
            device: torch.device, min_bytes: Callable[[], int]) -> Dict:
    """Time ``fn(*args)`` (a warm call, then ``iters`` calls), count one more
    call, and append the part's row to ``rows``; ``min_bytes()`` gives the
    least bytes of its function, asked after the warm call (an optimizer's
    states exist from its first step)."""
    fn(*args)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(device)
    ms = (time.perf_counter() - t0) / iters * 1000
    flops, bytes_ = count(fn, args)
    least = float(min_bytes())
    row = {"part": name, "ms": round(ms, 3), "flops": flops, "bytes": bytes_,
           "min_bytes": least}
    if flops or bytes_:
        ai = flops / bytes_ if bytes_ else float("inf")
        bound_ms = max(flops / PEAK_FLOPS, bytes_ / PEAK_BW) * 1e3
        min_bound_ms = max(flops / PEAK_FLOPS, least / PEAK_BW) * 1e3
        row.update({
            "ai_flop_per_byte": round(ai, 1),
            "bound": "compute" if ai >= RIDGE else "bandwidth",
            "bound_ms": round(bound_ms, 3),
            "achieved_tflops": round(flops / ms / 1e9, 1),
            "achieved_gbps": round(bytes_ / ms / 1e6, 1),
            "pct_of_bound": round(100 * bound_ms / ms, 1),
            "min_bound_ms": round(min_bound_ms, 3),
            "pct_of_min_bound": round(100 * min_bound_ms / ms, 1),
        })
    rows.append(row)
    print(f"{name:26s} {ms:8.3f} ms  "
          + (f"{flops / 1e9:8.1f} GFLOP {bytes_ / 1e9:7.2f} GB  "
             f"AI={row['ai_flop_per_byte']:6.1f} {row['bound']:9s} "
             f"bound={row['bound_ms']:7.3f} ms  {row['pct_of_bound']:5.1f}%  "
             f"min {least / 1e9:6.3f} GB bound={row['min_bound_ms']:7.3f} ms  "
             f"{row['pct_of_min_bound']:5.1f}%"
             if "bound" in row else "(nothing counted)"),
          flush=True)
    return row


def _backward(out: torch.Tensor, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``out.backward()`` into fresh ``.grad``s; the leaves' gradients.
    (``torch.autograd.grad`` is the same program, but FlopCounterMode's module
    hooks refuse it.)"""
    for t in leaves:
        t.grad = None
    out.backward()
    return [t.grad for t in leaves]


def fwd_bwd_program(module: nn.Module, device: torch.device) -> Callable:
    """The gradients of sum(module(x)) with respect to its parameters and
    ``x``, train-mode BatchNorm leaving its running statistics (the JAX
    program discards the new ones), bf16 autocast."""
    params = [p for p in module.parameters() if p.requires_grad]

    def program(x: torch.Tensor):
        module.train()
        x = x.detach().requires_grad_()
        with frozen_statistics(module), autocast(device, AMP_LEVEL):
            out = module(x).float().sum()
        return _backward(out, [*params, x])

    return program


def parts() -> List[tuple]:
    """(label, module factory, input NHWC without the batch): the JAX tool's
    parts, the stages' last exchange unit fusing into branch 0 only."""
    w, (sh, sw) = WIDTH, HEATMAP
    return [
        ("stem (256x192 -> /4)", Stem, (*IMAGE, 3)),
        ("stage1 (4xbottleneck)", Stage1, (sh, sw, 64)),
        ("stage2 (1 mod, 2 br)", lambda: StageN(1, 2, (w, 2 * w)), (sh, sw, w)),
        ("stage3 (4 mod, 3 br)", lambda: StageN(4, 3, (w, 2 * w, 4 * w)), (sh, sw, w)),
        ("stage4 (3 mod, 4 br)", lambda: StageN(3, 4, (w, 2 * w, 4 * w, 8 * w)), (sh, sw, w)),
        ("head (1x1 conv 32->17)", lambda: Head(w), (sh, sw, w)),
    ]


def _nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = device_parser(__doc__.split("\n", 1)[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="budget_h100.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B = args.batch
    SH, SW = HEATMAP
    rng = np.random.RandomState(0)
    rows: List[Dict] = []

    # ---- per-part fwd+bwd programs (profile_parts.py decomposition) ----
    torch.manual_seed(0)
    for label, make, shape in parts():
        x = _nchw(rng.rand(B, *shape).astype(np.float32), device)
        with torch.device(device):
            module = make().to(device)
        leaves = [x, *(p for p in module.parameters() if p.requires_grad)]
        measure(label, fwd_bwd_program(module, device), (x,), args.iters, rows, device,
                lambda: 2 * nbytes(leaves))
        del module, x, leaves

    # ---- loss (float32, the real NetWithLoss epilogue) ----
    hm = _nchw(rng.rand(B, SH, SW, 17).astype(np.float32), device)
    y = _nchw(rng.rand(B, SH, SW, 17).astype(np.float32), device)
    tw = torch.ones(B, 17, device=device)
    loss_fn = create_loss("joint_mse", use_target_weight=True)

    def loss_grad(hm):
        hm = hm.detach().requires_grad_()
        return _backward(loss_fn(hm, y, tw).sum(), [hm])

    measure("loss (joint_mse)", loss_grad, (hm,), args.iters, rows, device,
            lambda: 2 * nbytes([hm]) + nbytes([y, tw]))

    # ---- optimizer (adamw over HRNet-W32's 28.5M parameters, all-ones gradients) ----
    with torch.device(device):
        net = create_network(BACKBONE, "hrnet_head").to(device)
    opt_net = copy.deepcopy(net)
    tx = create_optimizer(opt_net, "adamw", learning_rate=1e-3, weight_decay=0.05)
    params = [p for p in opt_net.parameters() if p.requires_grad]
    for p in params:
        p.grad = torch.ones_like(p)
    measure("optimizer (adamw)", tx.step, (), args.iters, rows, device,
            lambda: 7 * nbytes(params))  # p, g, m, v read; p, m, v written
    del opt_net, tx, params

    # ---- the full train step ----
    nwl = create_network_with_loss(net, create_loss("joint_mse", use_target_weight=True),
                                   has_extra_inputs=True)
    step = build_train_step(nwl, create_optimizer(net, "adamw", learning_rate=1e-3,
                                                  weight_decay=0.05), amp_level=AMP_LEVEL)
    x = _nchw(rng.rand(B, *IMAGE, 3).astype(np.float32), device)
    state = [p for p in net.parameters() if p.requires_grad]
    measure("FULL STEP (fwd+bwd+opt)", step, (x, y, tw), args.iters, rows, device,
            lambda: nbytes([x, y, tw]) + 2 * (3 * nbytes(state) + nbytes(net.buffers())))

    report = {"batch": B, "peak_flops": PEAK_FLOPS, "peak_bw": PEAK_BW,
              "ridge_flop_per_byte": RIDGE, "gpu": gpu_name_and_power(device), "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
