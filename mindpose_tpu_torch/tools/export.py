"""Export a trained model to a self-contained ``torch.export`` serving artifact.

Counterpart of ``tools/export.py``. The artifact bakes the weights in and
fuses forward + decode into one program with a symbolic batch dimension
(``engine/export.py``); ``engine.load_serving_fn`` serves it from the bytes
alone, needing only the port's decode ops. It serves on the device it was
exported on: ``--platforms`` (``jax.export``'s lowering platforms) has no
torch counterpart and is refused. Bottom-up recipes are refused, as the JAX
tool refuses them. ``amp_level`` O1-O3 exports the net under bf16 autocast,
as the inferencer runs those levels; O0 exports float32.

``--selftest`` loads the artifact and compares it with the direct forward
and decode on seeded inputs (batch 2, or the pinned one), with the JAX
tool's tolerances: float32 within 1e-4 (rtol and atol); under bf16 at least
90% of the outputs within 1e-2, since a tie on a near-flat heatmap may
decode apart.

It runs on the current CUDA device unless ``--device`` says otherwise, and
raises without CUDA.

Usage:
    python3 -m mindpose_tpu_torch.tools.export --config configs/hrnet/hrnet_w32_tpu.yaml \\
        --ckpt ckpt/hrnet_w32_tpu_last.ckpt [--out hrnet_w32_tpu.pt2] [--batch b] [--raw] \\
        [--selftest] [--device cpu]
"""
import logging
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config, parse_args
from ..engine.export import ServingModule, export_eval_net, load_serving_fn
from ..models import create_decoder, create_eval_network, create_network_from_config
from ..utils.checkpoint import load_net_state_dict

__all__ = ["build_eval_net", "parse_export_args", "main"]


def build_eval_net(args: Any, raw_output: bool,
                   device: Optional[torch.device] = None) -> Tuple[Any, Tuple[int, int]]:
    """(the config's EvalNet with ``args.ckpt``'s weights on ``device``, (H, W))."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("export runs on the GPU by default, and CUDA is not available; "
                               "pass --device cpu to export on the CPU")
        device = "cuda"
    with torch.device("meta"):
        net = create_network_from_config(args)
    state = load_net_state_dict(args.ckpt, net)
    net = net.to_empty(device="cpu")
    net.load_state_dict(state, strict=True)
    net = net.to(torch.device(device))
    decoder = create_decoder(args.decoder_name, **(getattr(args, "decoder_setting", None) or {}))
    image_size = args.dataset_setting["image_size"]
    return create_eval_network(net, decoder, output_raw=raw_output), (int(image_size[1]),
                                                                      int(image_size[0]))


def parse_export_args(argv: Optional[Sequence[str]] = None) -> Config:
    return parse_args(argv, description="export a checkpoint to a torch.export serving artifact",
                      extra_args=[
        {"names": ["--out"], "type": str, "default": "",
         "help": "output path (default <config>.pt2)"},
        {"names": ["--platforms"], "type": str, "default": None,
         "help": "refused: a torch.export artifact serves on the device it was exported on"},
        {"names": ["--batch"], "type": str, "default": "b",
         "help": "symbolic dim name (any batch) or an int to pin"},
        {"names": ["--raw"], "action": "store_true",
         "help": "also return the head's raw outputs from the artifact"},
        {"names": ["--selftest"], "action": "store_true",
         "help": "load the artifact and compare it with the direct forward"},
        {"names": ["--device"], "default": None,
         "help": "where the net runs and the artifact serves (default: the current CUDA device)"},
    ])


def _leaves(tree: Any) -> list:
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def selftest(blob: bytes, eval_net: Any, image_hw: Tuple[int, int], batch: Any,
             amp_level: str) -> int:
    """Load ``blob`` and hold it to the direct forward on seeded inputs, with
    the JAX tool's tolerances. Returns the batch it ran."""
    serve = load_serving_fn(blob)
    n = batch if isinstance(batch, int) else 2
    device = next(eval_net.net.parameters()).device
    rng = np.random.RandomState(0)
    inputs = [torch.from_numpy(a).to(device) for a in (
        rng.rand(n, 3, *image_hw).astype(np.float32),
        rng.uniform(50, 100, (n, 2)).astype(np.float32),
        rng.uniform(0.5, 2.0, (n, 2)).astype(np.float32),
        rng.rand(n).astype(np.float32),
    )]
    got = _leaves(serve(*inputs))
    direct = ServingModule(eval_net.net, eval_net.decoder, eval_net.output_raw,
                           None if amp_level == "O0" else torch.bfloat16)
    with torch.inference_mode():
        want = _leaves(direct(*inputs))
    if len(got) != len(want):
        raise AssertionError(f"the artifact returns {len(got)} outputs, the forward {len(want)}")
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        if not np.all(np.isfinite(g)):
            raise AssertionError("non-finite outputs in the artifact")
        if amp_level == "O0":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            # bf16: another rounding may flip an argmax on a near-flat
            # heatmap, so bulk agreement rather than every element
            frac = float(np.mean(np.isclose(g, w, rtol=1e-2, atol=1e-2)))
            if frac < 0.9:
                raise AssertionError(f"the artifact disagrees with the direct forward on "
                                     f"{1 - frac:.1%} of outputs (shape {g.shape})")
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_export_args(argv)
    if args.platforms:
        raise SystemExit("--platforms has no torch.export counterpart: an artifact serves on "
                         "the device it was exported on (--device)")
    if getattr(args, "pipeline_method", "topdown") != "topdown":
        raise SystemExit("export supports top-down recipes (the bottom-up decoder's grouping "
                         "stage is not a pure device program)")
    if not args.ckpt:
        raise SystemExit("--ckpt is required")
    out = args.out or os.path.splitext(os.path.basename(args.config))[0] + ".pt2"
    batch = int(args.batch) if str(args.batch).isdigit() else args.batch
    amp_level = getattr(args, "amp_level", "O0") or "O0"

    eval_net, image_hw = build_eval_net(args, args.raw, args.device)
    logging.info("exporting %s + %s decode at %sx%s, batch=%r, amp_level=%s, on %s",
                 args.backbone_name, args.decoder_name, image_hw[0], image_hw[1], batch,
                 amp_level, next(eval_net.net.parameters()).device)
    blob = export_eval_net(eval_net, image_hw, batch=batch, amp_level=amp_level)
    with open(out, "wb") as f:
        f.write(blob)
    logging.info("wrote %s (%.1f MB)", out, len(blob) / 1e6)
    if args.selftest:
        n = selftest(blob, eval_net, image_hw, batch, amp_level)
        logging.info("selftest ok: the loaded artifact matches the direct forward "
                     "(batch %d, amp_level=%s)", n, amp_level)


if __name__ == "__main__":
    main()
