"""The port's checkpoints, and one loader for them and the JAX package's.

Counterpart of ``mindpose_tpu/utils/checkpoint.py``. The JAX package saves
its TrainState (params, batch_stats, opt_state, step) as flax msgpack; the
port saves the same state as ``torch.save`` of the net's ``state_dict`` (the
BatchNorm running statistics among its buffers), the optimizer's
``state_dict`` and the step, written atomically as ``_write_atomic`` does
(:50-55). With ``async_write`` the state is copied to the CPU at once and a
thread writes it, as the JAX package's ``save_checkpoint`` does (:58-98);
``wait_pending_checkpoints`` waits for every such thread.

``load_net_state_dict`` takes either kind of file and gives a
``state_dict`` for a strict ``load_state_dict``; ``restore_train_state``
resumes a run from either: a JAX TrainState fills the net and, for an
``adam``/``adamw`` optimizer, its moments and step count (optax's
``mu``/``nu``/``count`` become torch's ``exp_avg``/``exp_avg_sq``/``step``).
"""
import logging
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.convert import convert_net_variables
from .flax_msgpack import load_variables, msgpack_restore

__all__ = ["save_checkpoint", "save_ema", "load_checkpoint", "load_ema", "restore_train_state",
           "load_net_state_dict", "wait_pending_checkpoints"]

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's file format is a zip archive

# per-path writer threads of async saves: a new save to a path joins the
# previous one first, so the file ends at the newest state
_WRITERS: Dict[str, threading.Thread] = {}
_WRITERS_LOCK = threading.Lock()


def _to_cpu(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_cpu(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write_atomic(path: str, state: Any) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _save(path: str, state: Dict[str, Any], async_write: bool) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not async_write:
        _write_atomic(path, state)
        return
    state = _to_cpu(state)  # the step may change the tensors once this returns
    key = os.path.abspath(path)
    # read-prev and register-new in one critical section, or two saves to
    # one path could chain onto the same predecessor and race
    with _WRITERS_LOCK:
        prev = _WRITERS.get(key)

        def run(prev=prev):
            if prev is not None:
                prev.join()
            _write_atomic(path, state)

        t = threading.Thread(target=run, name=f"ckpt-write:{path}")
        _WRITERS[key] = t
    t.start()


def save_checkpoint(path: str, net: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, step: int = 0,
                    async_write: bool = False) -> None:
    """Write ``{"net", "optimizer", "step"}`` to ``path`` atomically, now or
    (``async_write``) from a thread, from a CPU copy taken now."""
    _save(path, {
        "net": net.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "step": int(step),
    }, async_write)


def save_ema(path: str, params: Dict[str, torch.Tensor], async_write: bool = False) -> None:
    """Write the averaged parameters as ``{"params": ...}``, as the JAX package
    writes its ``.ema`` files."""
    _save(path, {"params": dict(params)}, async_write)


def wait_pending_checkpoints() -> None:
    """Block until every async checkpoint write has finished."""
    with _WRITERS_LOCK:
        threads = list(_WRITERS.values())
    for t in threads:
        t.join()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A port checkpoint as saved: ``{"net", "optimizer", "step"}``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_ema(path: str) -> Dict[str, torch.Tensor]:
    """The averaged parameters of an ``.ema`` file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["params"]


def _is_port_file(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def _adam_states(tree: Any):
    """Every optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) in an opt_state."""
    if isinstance(tree, dict):
        if set(tree) == {"count", "mu", "nu"}:
            yield tree
            return
        for v in tree.values():
            yield from _adam_states(v)


def _restore_jax_train_state(path: str, net: torch.nn.Module,
                             optimizer: Optional[torch.optim.Optimizer]) -> int:
    with open(path, "rb") as f:
        raw = msgpack_restore(f.read())
    variables = {"params": raw.get("params", raw), "batch_stats": raw.get("batch_stats", {})}
    net.load_state_dict(convert_net_variables(variables, net), strict=True)
    if optimizer is None:
        return int(np.asarray(raw.get("step", 0)))
    if "opt_state" not in raw:
        raise ValueError(f"{path} holds no optimizer state")
    adam = list(_adam_states(raw["opt_state"]))
    if not isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)) or len(adam) != 1:
        raise NotImplementedError(
            f"only an adam or adamw state is carried across from the JAX package; {path} holds "
            f"{len(adam)} adam states and the optimizer is {type(optimizer).__name__}")
    count = float(np.asarray(adam[0]["count"]))
    moments = {k: convert_net_variables({"params": adam[0][k],
                                         "batch_stats": variables["batch_stats"]}, net)
               for k in ("mu", "nu")}
    names = {id(p): n for n, p in net.named_parameters()}
    state_dict = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    # torch numbers the parameters of a state_dict over its groups, in order
    state_dict["state"] = {i: {"step": torch.tensor(count),
                               "exp_avg": moments["mu"][names[id(p)]],
                               "exp_avg_sq": moments["nu"][names[id(p)]]}
                           for i, p in enumerate(params)}
    optimizer.load_state_dict(state_dict)
    return int(np.asarray(raw["step"]))


def restore_train_state(path: str, net: torch.nn.Module,
                        optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Load the net (strict) and the optimizer from a port checkpoint or a JAX
    package TrainState; returns the step count."""
    logging.info("Resuming train state from %s", path)
    if not _is_port_file(path):
        return _restore_jax_train_state(path, net, optimizer)
    ckpt = load_checkpoint(path)
    net.load_state_dict(ckpt["net"], strict=True)
    if optimizer is not None:
        if ckpt["optimizer"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(ckpt["optimizer"])
    return ckpt["step"]


def load_net_state_dict(path: str, net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``net``'s weights from a port checkpoint or a JAX package (flax msgpack) one.

    A flax file is converted with ``models/convert.convert_net_variables``,
    by the mapping of ``net``'s backbone and head (``net`` may live on the
    meta device: only its structure is read). The result loads with
    ``net.load_state_dict(..., strict=True)``.
    """
    if _is_port_file(path):
        return load_checkpoint(path)["net"]
    return convert_net_variables(load_variables(path), net)
