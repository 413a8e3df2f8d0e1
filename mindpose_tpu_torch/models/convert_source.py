"""Carry a published backbone (MindSpore .ckpt, torch .pth, numpy .npz) into the port.

Counterpart of ``mindpose_tpu/models/backbones/convert.py``'s
``convert_backbone_state`` (:434) for the port's modules. The JAX package
maps each source name onto its flax tree; the port's backbones already use
the source's torch names (ResNet torchvision's, HRNet the official repo's,
ViT timm's with a fused ``qkv``), so once ``normalize_source_keys`` (a copy
of :49, pinned by tests/test_torch_host_copies.py) has put a source in
torch style, each of the backbone's tensors is taken by its own name, in
float32. What the port changes is the ViT position grid, as
``convert_vit_state`` (:228) does: the class token is dropped and the
tokens reshaped to the (1, gh, gw, D) grid the port stores, the grid
inferred from the token count (square, else 4:3 portrait). Shapes are not
checked here: ``tools/convert_ckpt.py --check`` compares them with the
backbone's, and ``utils/checkpoint.load_pretrained_backbone`` takes what
matches (resizing a position grid of another size).

``export_backbone_state`` goes the other way, as the JAX package's (:336,
with ``export_vit_state`` :377): a backbone's ``state_dict`` -> a
published-style state dict with torch names or MindSpore's (BatchNorm's
gamma/beta/moving_mean/moving_variance, ``down_sample``, ViTPose's
``last_norm`` and the LayerNorms' gamma/beta), which
``write_ms_checkpoint`` writes as a ``.ckpt`` that ``convert_backbone_source``
carries back bit for bit.
"""
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .backbones.vit import ViT

__all__ = ["normalize_source_keys", "infer_token_grid", "convert_backbone_source",
           "export_backbone_state", "export_vit_state"]

_MS_RENAMES = (
    (".gamma", ".weight"),
    (".beta", ".bias"),
    (".moving_mean", ".running_mean"),
    (".moving_variance", ".running_var"),
    (".down_sample.", ".downsample."),
    ("last_norm.", "norm."),  # ViTPose's name for the final trunk LayerNorm
)
_STRIP_PREFIXES = ("backbone.", "module.", "net.", "model.")


def normalize_source_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Canonicalize MindSpore/torch naming variants into torch-style keys."""
    out = {}
    for k, v in state.items():
        for pre in _STRIP_PREFIXES:
            if k.startswith(pre):
                k = k[len(pre):]
        for old, new in _MS_RENAMES:
            k = k.replace(old, new)
        out[k] = np.asarray(v)
    return out


def infer_token_grid(n_tokens: int) -> Optional[Tuple[int, int]]:
    """(gh, gw) of ``n_tokens``: square, else 4:3 portrait (256x192 crops ->
    16x12); None when neither factors it."""
    r = int(round(n_tokens ** 0.5))
    if r * r == n_tokens:
        return r, r
    h = int(round((n_tokens * 4 / 3) ** 0.5))
    if h > 0 and n_tokens % h == 0:
        return h, n_tokens // h
    return None


def _position_grid(pos: np.ndarray, dim: int,
                   grid: Optional[Tuple[int, int]]) -> np.ndarray:
    """A [1, N(+1), D] position embedding as the port's (1, gh, gw, D) grid."""
    n = pos.shape[1]
    if grid is None:
        grid = infer_token_grid(n) if infer_token_grid(n) is not None else infer_token_grid(n - 1)
        if grid is None:
            raise ValueError(f"cannot infer a token grid for {n} tokens; pass grid=(gh, gw)")
    gh, gw = grid
    if n == gh * gw + 1:  # a leading class token (MAE, timm): the port's trunk has none
        pos = pos[:, 1:]
    elif n != gh * gw:
        raise ValueError(f"pos_embed has {n} tokens; grid {gh}x{gw} wants {gh * gw} (+1 cls)")
    return pos.reshape(1, gh, gw, dim)


def convert_backbone_source(backbone: nn.Module, source: Dict[str, np.ndarray],
                            grid: Optional[Tuple[int, int]] = None
                            ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """A source state dict -> (the tensors of ``backbone``'s ``state_dict``
    that it holds, float32; the backbone's names it lacks; its names the
    backbone has no use for). ``backbone`` gives the names only, so it may
    live on the meta device. BatchNorm's ``num_batches_tracked`` is neither
    taken nor missed: flax and MindSpore keep none."""
    src = normalize_source_keys(source)
    state: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for name in backbone.state_dict():
        if name.endswith("num_batches_tracked"):
            continue
        if name not in src:
            missing.append(name)
            continue
        value = np.array(src[name], dtype=np.float32)  # a copy: a .ckpt's arrays are read-only
        if name == "pos_embed" and isinstance(backbone, ViT):
            value = _position_grid(value, backbone.hidden_dim, grid)
        state[name] = torch.from_numpy(np.ascontiguousarray(value))
    unused = sorted(set(src) - set(state))
    return state, missing, unused


# BatchNorm's torch leaves and MindSpore's names for them
_BN_LEAVES = {"weight": "gamma", "bias": "beta", "running_mean": "moving_mean",
              "running_var": "moving_variance"}


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def export_backbone_state(arch: str, state: Dict[str, torch.Tensor],
                          naming: str = "torch") -> Dict[str, np.ndarray]:
    """A backbone's ``state_dict`` -> {published name: float32 array}, the
    inverse of ``convert_backbone_source``.

    ``naming`` "torch" keeps the port's names (the official torch ones);
    "mindspore" renames BatchNorm's leaves (gamma, beta, moving_mean,
    moving_variance) and ``downsample`` to ``down_sample``, as the JAX
    package's export does. BatchNorm's ``num_batches_tracked`` is left out
    (neither flax nor MindSpore keeps one). A ViT (its ``state`` holds a
    ``pos_embed``) goes through ``export_vit_state``. ``arch`` names the
    backbone, as the JAX function takes it; the port's names carry the
    structure, so any HRNet, ResNet or ViT exports."""
    if naming not in ("torch", "mindspore"):
        raise ValueError(f"naming must be 'torch' or 'mindspore', got {naming!r}")
    if "pos_embed" in state:
        return export_vit_state(arch, state, naming=naming)
    ms = naming == "mindspore"
    norms = {k[:-len(".running_mean")] for k in state if k.endswith(".running_mean")}
    out: Dict[str, np.ndarray] = {}
    for name, value in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        prefix, leaf = name.rsplit(".", 1)
        if ms:
            if prefix in norms:
                leaf = _BN_LEAVES[leaf]
            prefix = prefix.replace(".downsample.", ".down_sample.")
        out[f"{prefix}.{leaf}"] = _numpy(value)
    return out


def export_vit_state(arch: str, state: Dict[str, torch.Tensor],
                     naming: str = "torch") -> Dict[str, np.ndarray]:
    """A ViT's ``state_dict`` -> torch-style (timm) names, in the JAX
    package's order: the patch embedding, the position embedding flattened
    to [1, N, D] (no class token: the port's trunk has none), each block's
    norms, fused qkv, projection and MLP, then the final norm.
    ``naming="mindspore"`` gives the LayerNorms gamma/beta and the final
    norm ViTPose's ``last_norm`` name."""
    ms = naming == "mindspore"
    ln_leaves = ("gamma", "beta") if ms else ("weight", "bias")
    depth = sum(1 for k in state if k.startswith("blocks.") and k.endswith(".norm1.weight"))
    out: Dict[str, np.ndarray] = {}

    def ln(src_key: str, module: str) -> None:
        out[f"{src_key}.{ln_leaves[0]}"] = _numpy(state[f"{module}.weight"])
        out[f"{src_key}.{ln_leaves[1]}"] = _numpy(state[f"{module}.bias"])

    def copy(*names: str) -> None:
        for name in names:
            out[name] = _numpy(state[name])

    copy("patch_embed.proj.weight", "patch_embed.proj.bias")
    pos = _numpy(state["pos_embed"])  # [1, gh, gw, D]
    out["pos_embed"] = pos.reshape(1, -1, pos.shape[-1])
    for i in range(depth):
        ln(f"blocks.{i}.norm1", f"blocks.{i}.norm1")
        ln(f"blocks.{i}.norm2", f"blocks.{i}.norm2")
        copy(*(f"blocks.{i}.{m}.{leaf}" for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
               for leaf in ("weight", "bias")))
    ln("last_norm" if ms else "norm", "norm")
    return out
