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
``load_pretrained_backbone`` merges a backbone from either kind of file into
a net, where shapes match (:113-201).
"""
import logging
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..models.convert import (
    convert_variables,
    convert_net_variables,
    export_variables,
    net_mapping,
    num_heads,
)
from .flax_msgpack import load_variables, msgpack_restore

__all__ = ["save_checkpoint", "save_ema", "load_checkpoint", "load_ema", "restore_train_state",
           "load_net_state_dict", "load_pretrained_backbone", "resize_bilinear_antialiased",
           "wait_pending_checkpoints"]

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


def save_checkpoint(path: str, net: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                    optimizer: Union[torch.optim.Optimizer, Mapping[str, Any], None] = None,
                    step: int = 0, async_write: bool = False) -> None:
    """Write ``{"net", "optimizer", "step"}`` to ``path`` atomically, now or
    (``async_write``) from a thread, from a CPU copy taken now.

    ``net`` and ``optimizer`` are the module and the optimizer, or their
    ``state_dict``s (a sharded net's, gathered by ``parallel/fsdp.full_state``).
    """
    if isinstance(net, torch.nn.Module):
        net = net.state_dict()
    if isinstance(optimizer, torch.optim.Optimizer):
        optimizer = optimizer.state_dict()
    _save(path, {"net": net, "optimizer": optimizer, "step": int(step)}, async_write)


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


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize``'s "bilinear" along one axis
    (``jax/_src/image/scale.py:compute_weight_mat``, antialias on): a
    triangle kernel, widened by n_in / n_out when the axis shrinks, each
    row normalized."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


def resize_bilinear_antialiased(grid: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``jax.image.resize(grid, shape, "bilinear")`` for a (1, gh, gw, D)
    position grid: the two spatial axes, each shrunk with the antialiasing
    triangle (``F.interpolate`` without antialias gives another answer
    there). float32, as the JAX package computes it."""
    out = np.asarray(grid, np.float32)
    for axis in (1, 2):
        if out.shape[axis] != shape[axis]:
            w = _resize_weights(out.shape[axis], shape[axis]).astype(np.float32)
            out = np.moveaxis(np.tensordot(w, np.moveaxis(out, axis, 0), axes=1), 0, axis)
    return out


def _merge(dst: Dict[str, Any], src: Mapping[str, Any]) -> Tuple[Dict[str, Any], int]:
    """The JAX package's non-strict merge: each leaf of ``dst`` takes ``src``'s
    where the shapes match, and a ``pos_embedding`` grid of another size is
    resized onto ``dst``'s; every other leaf stays. Returns the tree and the
    count of leaves taken."""
    out, n_loaded = {}, 0
    for k, v in dst.items():
        s = src.get(k)
        if isinstance(v, dict):
            if isinstance(s, dict):
                out[k], n = _merge(v, s)
                n_loaded += n
            else:
                out[k] = v
            continue
        s_shape = tuple(s.shape) if hasattr(s, "shape") else None
        if s_shape == tuple(v.shape):
            out[k] = s
            n_loaded += 1
        elif (k == "pos_embedding" and s_shape is not None and len(s_shape) == len(v.shape) == 4
              and s_shape[-1] == v.shape[-1]):
            # a ViT position grid trained at another resolution (ViTPose §3)
            out[k] = resize_bilinear_antialiased(_numpy(s), v.shape)
            logging.info("Interpolated pos_embedding %s -> %s", s_shape, tuple(v.shape))
            n_loaded += 1
        else:
            out[k] = v
    return out, n_loaded


def _numpy(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf of a flax msgpack file
        return value.float().numpy()
    return np.asarray(value)


def _source_variables(path: str, net: torch.nn.Module) -> Dict[str, Any]:
    """The file's variables as flax ``{"params", "batch_stats"}`` trees: a flax
    msgpack file as it is; a port file (``torch.save``, of ``{"net": ...}``
    or of a bare state_dict) through ``export_variables`` by ``net``'s
    mapping, its ``backbone.`` tensors under a ``backbone`` scope."""
    if not _is_port_file(path):
        with open(path, "rb") as f:
            return msgpack_restore(f.read())
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("net", state)
    if any(k.startswith("backbone.") for k in state):
        return export_variables(state, net_mapping(net), num_heads(net))
    # a backbone's own state_dict
    return export_variables(state, _backbone_entries(net), num_heads(net.backbone))


def _backbone_entries(net: torch.nn.Module):
    """``net_mapping``'s backbone entries, named within the backbone."""
    return [(kind, name[len("backbone."):], path[1:]) for kind, name, path in net_mapping(net)
            if path[0] == "backbone"]


def load_pretrained_backbone(path: str, net: torch.nn.Module,
                             download_root: Optional[str] = None) -> int:
    """Non-strict load of ``net.backbone``'s parameters and BatchNorm
    statistics from a checkpoint; returns the count of (flax) tensors taken.

    Counterpart of the JAX package's ``load_pretrained_backbone``: a local
    path, ``file://``, or an ``http(s)://`` URL, downloaded first
    (``utils/download.py``, kept and reused under ``download_root``, by
    default ``get_default_download_root()``); a flax msgpack file (the JAX
    package's ``tools/convert_ckpt.py``'s, or a TrainState) or a port file
    (the port's ``tools/convert_ckpt.py``'s, or a ``torch.save`` of a net).
    Its ``params`` and ``batch_stats`` (the root when there is no
    ``params``), their ``backbone`` subtree when there is one, merge into the
    net's where shapes match; a ``pos_embedding`` of another grid is resized
    as ``jax.image.resize`` does.
    """
    if path.startswith("file://"):
        path = path[len("file://"):]
    elif path.startswith(("http://", "https://")):
        from .download import DownLoad

        path = DownLoad().download_url(path, path=download_root)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"pretrained backbone checkpoint not found: {path!r}")
    raw = _source_variables(path, net)
    backbone, entries = net.backbone, _backbone_entries(net)
    dst = export_variables(backbone.state_dict(), entries, num_heads(backbone))
    merged, n_total = {}, 0
    for coll in ("params", "batch_stats"):
        src_coll = raw.get(coll, raw if coll == "params" else None)
        merged[coll] = dst[coll]
        if not isinstance(src_coll, dict):
            continue
        src_backbone = src_coll.get("backbone", src_coll)
        if isinstance(src_backbone, dict):
            merged[coll], n = _merge(dst[coll], src_backbone)
            n_total += n
    state = backbone.state_dict()
    with torch.no_grad():
        for name, value in convert_variables(merged, entries).items():
            if not name.endswith("num_batches_tracked"):
                state[name].copy_(value)
    if n_total == 0:
        logging.warning("No pretrained backbone tensors matched from %s", path)
    else:
        logging.info("Loaded %d pretrained backbone tensors from %s", n_total, path)
    return n_total
