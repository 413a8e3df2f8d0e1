"""Carry the JAX package's trained variables into the port's modules.

The JAX package keeps a model's weights as flax trees, ``{"params": ...,
"batch_stats": ...}``, whose paths follow flax's auto-naming (``HRModule_3``,
``BasicBlock_5``, ``Conv_0``, ...). The port's modules use the official HRNet
torch names (``stage3.0.branches.1.1.conv1``). ``hrnet_mapping`` pairs the two
for any stage config, in the order in which the JAX modules create their
submodules, so reduced-depth configs convert as well as HRNet-W32/W48.

Layout changes: conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]; BN
scale -> weight, bias -> bias, batch_stats mean/var -> running_mean/var;
``num_batches_tracked``, which flax has no counterpart of, is set to 0.
The result loads with ``load_state_dict(strict=True)``.
"""
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["hrnet_mapping", "convert_backbone_variables", "convert_net_variables"]

# (kind, torch prefix, flax path): kind is "conv" or "bn"
Entry = Tuple[str, str, Tuple[str, ...]]

# flax class name and number of conv+BN pairs of each residual block
_BLOCKS = {"BASIC": ("BasicBlock", 2, 1), "BOTTLENECK": ("Bottleneck", 3, 4)}


def _residual_block(src: str, flax: Tuple[str, ...], n_convs: int,
                    downsample: bool) -> List[Entry]:
    entries: List[Entry] = []
    for c in range(n_convs):
        entries.append(("conv", f"{src}.conv{c + 1}", flax + (f"Conv_{c}",)))
        entries.append(("bn", f"{src}.bn{c + 1}", flax + (f"BatchNorm_{c}",)))
    if downsample:
        entries.append(("conv", f"{src}.downsample.0", flax + (f"Conv_{n_convs}",)))
        entries.append(("bn", f"{src}.downsample.1", flax + (f"BatchNorm_{n_convs}",)))
    return entries


def hrnet_mapping(stage_cfg: Mapping[str, Mapping[str, Any]]) -> List[Entry]:
    """(kind, torch prefix, flax path) for every conv and BN of an HRNet backbone."""
    entries: List[Entry] = [
        ("conv", "conv1", ("stem_conv1",)),
        ("bn", "bn1", ("stem_bn1",)),
        ("conv", "conv2", ("stem_conv2",)),
        ("bn", "bn2", ("stem_bn2",)),
    ]
    cfg1 = stage_cfg["stage1"]
    cls1, n1, exp1 = _BLOCKS[cfg1["block"]]
    for i in range(cfg1["num_blocks"][0]):
        entries += _residual_block(f"layer1.{i}", (f"{cls1}_{i}",), n1, downsample=i == 0)
    pre_channels: Tuple[int, ...] = (cfg1["num_channels"][0] * exp1,)

    top_c = 0  # counter of the transitions' top-level Conv_c / BatchNorm_c
    h = 0  # HRModule counter
    for s in (2, 3, 4):
        cfg = stage_cfg[f"stage{s}"]
        cls, n_convs, exp = _BLOCKS[cfg["block"]]
        cur = tuple(c * exp for c in cfg["num_channels"])
        t = s - 1
        for i, ch in enumerate(cur):
            if i < len(pre_channels):
                if ch != pre_channels[i]:
                    entries.append(("conv", f"transition{t}.{i}.0", (f"Conv_{top_c}",)))
                    entries.append(("bn", f"transition{t}.{i}.1", (f"BatchNorm_{top_c}",)))
                    top_c += 1
            else:
                for j in range(i + 1 - len(pre_channels)):
                    entries.append(("conv", f"transition{t}.{i}.{j}.0", (f"Conv_{top_c}",)))
                    entries.append(("bn", f"transition{t}.{i}.{j}.1", (f"BatchNorm_{top_c}",)))
                    top_c += 1

        n_br = cfg["num_branches"]
        for m in range(cfg["num_modules"]):
            mod = (f"HRModule_{h}",)
            src_mod = f"stage{s}.{m}"
            g = 0  # flax numbers the blocks of all branches in one sequence
            for b in range(n_br):
                for k in range(cfg["num_blocks"][b]):
                    # a branch's input already has its output width, so no
                    # block of a stage 2-4 branch has a downsample
                    entries += _residual_block(f"{src_mod}.branches.{b}.{k}",
                                               mod + (f"{cls}_{g}",), n_convs, downsample=False)
                    g += 1
            is_last = m == cfg["num_modules"] - 1
            multi = cfg.get("multiscale_output", True) or not is_last
            fc = 0  # fusion convs, in ascending (i, j) order
            for i in range(n_br if multi else 1):
                for j in range(n_br):
                    if j > i:
                        entries.append(("conv", f"{src_mod}.fuse_layers.{i}.{j}.0",
                                        mod + (f"Conv_{fc}",)))
                        entries.append(("bn", f"{src_mod}.fuse_layers.{i}.{j}.1",
                                        mod + (f"BatchNorm_{fc}",)))
                        fc += 1
                    elif j < i:
                        for k in range(i - j):
                            entries.append(("conv", f"{src_mod}.fuse_layers.{i}.{j}.{k}.0",
                                            mod + (f"Conv_{fc}",)))
                            entries.append(("bn", f"{src_mod}.fuse_layers.{i}.{j}.{k}.1",
                                            mod + (f"BatchNorm_{fc}",)))
                            fc += 1
            h += 1
        pre_channels = cur
    return entries


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf of a flax msgpack file
        return value.to(torch.float32)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def convert_backbone_variables(
    variables: Mapping[str, Any], stage_cfg: Mapping[str, Mapping[str, Any]]
) -> Dict[str, torch.Tensor]:
    """HRNet backbone variables ({"params", "batch_stats"} at the backbone scope)
    -> the port's HRNet ``state_dict``. Raises if a flax leaf is left unused."""
    params = _leaves(variables["params"])
    stats = _leaves(variables.get("batch_stats", {}))
    used = set()

    def take(tree: Dict[Tuple[str, ...], Any], key: Tuple[str, ...]) -> torch.Tensor:
        used.add(("params" if tree is params else "batch_stats",) + key)
        return _tensor(tree[key])

    out: Dict[str, torch.Tensor] = {}
    for kind, name, path in hrnet_mapping(stage_cfg):
        if kind == "conv":
            out[f"{name}.weight"] = take(params, path + ("kernel",)).permute(3, 2, 0, 1).contiguous()
        else:
            out[f"{name}.weight"] = take(params, path + ("scale",))
            out[f"{name}.bias"] = take(params, path + ("bias",))
            out[f"{name}.running_mean"] = take(stats, path + ("mean",))
            out[f"{name}.running_var"] = take(stats, path + ("var",))
            out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    every = {("params",) + k for k in params} | {("batch_stats",) + k for k in stats}
    unused = sorted(every - used)
    if unused:
        raise ValueError(f"flax variables with no counterpart in the port: {unused[:5]} ...")
    return out


def convert_net_variables(
    variables: Mapping[str, Any], stage_cfg: Mapping[str, Mapping[str, Any]]
) -> Dict[str, torch.Tensor]:
    """Variables of the JAX ``Net`` (HRNet backbone + ``hrnet_head``) -> the
    port's ``Net.state_dict()``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    backbone = convert_backbone_variables(
        {"params": params["backbone"], "batch_stats": stats.get("backbone", {})}, stage_cfg)
    out = {f"backbone.{k}": v for k, v in backbone.items()}
    head = params["head"]["head"]
    out["head.head.weight"] = _tensor(head["kernel"]).permute(3, 2, 0, 1).contiguous()
    out["head.head.bias"] = _tensor(head["bias"])
    return out
