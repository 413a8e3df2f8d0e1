"""Convert a published backbone checkpoint into a file the port loads.

Counterpart of ``tools/convert_ckpt.py`` (:38-140). Sources:
  *.ckpt                  MindSpore checkpoint (``utils/ms_ckpt.py``, no MindSpore);
  *.pth / *.pt / *.tar / *.bin   torch state dict (torchvision ResNet, official
                          HRNet, timm/MAE ViT; nested under ``state_dict``,
                          ``model`` or ``module`` as published);
  *.npz                   numpy archive of {torch-style name: array}.

The output is ``torch.save`` of the backbone's ``state_dict`` (float32,
without BatchNorm's ``num_batches_tracked``; a ViT's position grid as the
port's (1, gh, gw, D)), which ``backbone_pretrained: true`` with
``backbone_ckpt_url: <file>`` loads (``utils/checkpoint.load_pretrained_backbone``).
The backbone's names the source lacks are an error unless
``--allow-missing``; its names the backbone has no use for (a classifier)
are logged. ``--check`` builds the backbone on the meta device (a ViT at
the converted grid's size) and compares every converted tensor's shape.
The tool runs on the host and touches no GPU.

Usage:
    python3 -m mindpose_tpu_torch.tools.convert_ckpt --src hrnet_w32_imagenet.ckpt \\
        --arch hrnet_w32 --out cache/pretrained/hrnet_w32_imagenet.pth [--check] \\
        [--allow-missing]
"""
import argparse
import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import create_backbone
from ..models.convert_source import convert_backbone_source

__all__ = ["load_source", "check_shapes", "main"]

PATCH_SIZE = 16  # every ViT of the port


def load_source(path: str) -> Dict[str, np.ndarray]:
    """The source checkpoint's tensors by name, as numpy arrays."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ckpt":
        from ..utils.ms_ckpt import read_ms_checkpoint

        return read_ms_checkpoint(path)
    if ext in (".pth", ".pt", ".tar", ".bin"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        for nest in ("state_dict", "model", "module"):
            if isinstance(state, dict) and isinstance(state.get(nest), dict):
                state = state[nest]
        return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in state.items()}
    if ext == ".npz":
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    raise ValueError(f"unrecognized checkpoint extension {ext!r} for {path!r}")


def _meta_backbone(arch: str, image_size: Optional[List[int]] = None) -> torch.nn.Module:
    kwargs = {"image_size": image_size} if image_size else {}
    with torch.device("meta"):
        return create_backbone(arch, **kwargs)


def check_shapes(arch: str, state: Dict[str, torch.Tensor]) -> int:
    """The count of converted tensors whose shape is not the backbone's
    (built on the meta device; a ViT at the converted position grid's size)."""
    image_size = None
    pos = state.get("pos_embed")
    if pos is not None and pos.dim() == 4:
        image_size = [pos.shape[2] * PATCH_SIZE, pos.shape[1] * PATCH_SIZE]  # [W, H]
    want = _meta_backbone(arch, image_size).state_dict()
    bad = 0
    for name, value in state.items():
        if tuple(want[name].shape) != tuple(value.shape):
            logging.error("shape mismatch at %s: got %s want %s", name, tuple(value.shape),
                          tuple(want[name].shape))
            bad += 1
    covered = sum(not k.endswith("num_batches_tracked") for k in want)
    logging.info("verified %d tensors against %s (%d of its tensors not covered)", len(state),
                 arch, covered - len(state))
    return bad


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Convert a published backbone checkpoint into a "
                                            "file the port's backbone_ckpt_url loads.")
    p.add_argument("--src", required=True, help="source checkpoint path")
    p.add_argument("--arch", required=True, help="the port's backbone name, e.g. hrnet_w32")
    p.add_argument("--out", required=True, help="output file (torch.save)")
    p.add_argument("--check", action="store_true",
                   help="build the backbone and compare the converted shapes with it")
    p.add_argument("--allow-missing", action="store_true",
                   help="accept a source that lacks some of the backbone's tensors "
                        "(a non-strict load)")
    args = p.parse_args(argv)

    source = load_source(args.src)
    logging.info("loaded %d tensors from %s", len(source), args.src)
    backbone = _meta_backbone(args.arch)
    state, missing, unused = convert_backbone_source(backbone, source)
    if missing:
        level = logging.warning if args.allow_missing else logging.error
        level("%d of the backbone's tensors missing (first 10): %s", len(missing), missing[:10])
        if not args.allow_missing:
            raise SystemExit("conversion incomplete: rerun with --allow-missing to accept a "
                             "partial (non-strict) load")
    if unused:
        logging.info("%d source tensors unused (classifier heads etc.); first 10: %s",
                     len(unused), unused[:10])
    if args.check and check_shapes(args.arch, state):
        raise SystemExit("shape check failed")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(state, args.out)
    logging.info("wrote %s (arch=%s, %d tensors); use it with backbone_pretrained: true and "
                 "backbone_ckpt_url: %s", args.out, args.arch, len(state), args.out)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    main()
