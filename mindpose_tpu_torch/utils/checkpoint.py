"""The port's checkpoints, and one loader for them and the JAX package's.

Counterpart of ``mindpose_tpu/utils/checkpoint.py``. The JAX package saves
its TrainState (params, batch_stats, opt_state, step) as flax msgpack; the
port saves the same state as ``torch.save`` of the net's ``state_dict`` (the
BatchNorm running statistics among its buffers), the optimizer's
``state_dict`` and the step, written atomically as ``_write_atomic`` does
(:50-55). ``load_net_state_dict`` takes either kind of file and gives a
``state_dict`` for a strict ``load_state_dict``.
"""
import os
from typing import Any, Dict, Optional

import torch

from ..models.convert import convert_net_variables
from .flax_msgpack import load_variables

__all__ = ["save_checkpoint", "load_checkpoint", "restore_train_state", "load_net_state_dict"]

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's file format is a zip archive


def save_checkpoint(path: str, net: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, step: int = 0) -> None:
    """Write ``{"net", "optimizer", "step"}`` to ``path`` atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state = {
        "net": net.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "step": int(step),
    }
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A port checkpoint as saved: ``{"net", "optimizer", "step"}``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, net: torch.nn.Module,
                        optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Load the net (strict) and the optimizer from a port checkpoint; returns the step."""
    ckpt = load_checkpoint(path)
    net.load_state_dict(ckpt["net"], strict=True)
    if optimizer is not None:
        if ckpt["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt["step"]


def load_net_state_dict(path: str, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``net``'s weights from a port checkpoint or a JAX package (flax msgpack) one.

    A flax file is converted with ``models/convert.convert_net_variables``
    for ``net``'s HRNet stage config. The result loads with
    ``net.load_state_dict(..., strict=True)``.
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _ZIP_MAGIC:
        return load_checkpoint(path)["net"]
    return convert_net_variables(load_variables(path), net.backbone.stage_cfg)
