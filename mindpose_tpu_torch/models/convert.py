"""Carry the JAX package's trained variables into the port's modules.

The JAX package keeps a model's weights as flax trees, ``{"params": ...,
"batch_stats": ...}``, whose paths follow flax's auto-naming (``HRModule_3``,
``Bottleneck_5``, ``Conv_0``, ``ConvTranspose_1``, ...). The port's modules
use the official torch names (``stage3.0.branches.1.1.conv1``,
``layer2.0.downsample.0``, ``deconv_layers.3``). A mapping pairs the two, in
the order in which the JAX modules create their submodules: ``hrnet_mapping``
for any HRNet stage config, ``resnet_mapping`` for any block counts, and one
for each head. ``net_mapping`` picks the backbone's and the head's from the
port's net itself, so reduced-depth nets convert as well as full ones.

Layout changes: conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]; a
transposed conv's kernel [kh, kw, I, O] -> weight [I, O, kh, kw], flipped in
both spatial axes (flax's ``ConvTranspose`` with ``transpose_kernel=False``
does not flip it, torch's ``ConvTranspose2d`` does); BN scale -> weight,
bias -> bias, batch_stats mean/var -> running_mean/var;
``num_batches_tracked``, which flax has no counterpart of, is set to 0.
The result loads with ``load_state_dict(strict=True)``.
"""
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .backbones.hrnet import HRNet
from .backbones.resnet import ResNet
from .heads.hrnet_head import HRNetHead
from .heads.simple_baseline_head import SimpleBaselineHead

__all__ = ["hrnet_mapping", "resnet_mapping", "head_mapping", "net_mapping",
           "convert_variables", "convert_net_variables"]

# (kind, torch prefix, flax path): kind is "conv" (no bias), "conv_bias",
# "deconv" (a transposed conv, no bias) or "bn"
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


def resnet_mapping(block_counts: Sequence[int]) -> List[Entry]:
    """(kind, torch prefix, flax path) for every conv and BN of a ResNet backbone."""
    entries: List[Entry] = [("conv", "conv1", ("conv1",)), ("bn", "bn1", ("bn1",))]
    g = 0  # flax numbers the bottlenecks of all stages in one sequence
    for stage, count in enumerate(block_counts):
        for i in range(count):
            entries += _residual_block(f"layer{stage + 1}.{i}", (f"Bottleneck_{g}",), 3,
                                       downsample=i == 0)
            g += 1
    return entries


def head_mapping(head: nn.Module) -> List[Entry]:
    """The entries of a port head: ``hrnet_head`` or ``simple_baseline_head``."""
    if isinstance(head, HRNetHead):
        return [("conv_bias", "head", ("head",))]
    if isinstance(head, SimpleBaselineHead):
        convs = [i for i, m in enumerate(head.deconv_layers) if isinstance(m, nn.ConvTranspose2d)]
        entries: List[Entry] = []
        for n, i in enumerate(convs):
            entries.append(("deconv", f"deconv_layers.{i}", (f"ConvTranspose_{n}",)))
            entries.append(("bn", f"deconv_layers.{i + 1}", (f"BatchNorm_{n}",)))
        return entries + [("conv_bias", "final_layer", ("final_layer",))]
    raise NotImplementedError(f"no JAX variable mapping for the head {type(head).__name__}")


def net_mapping(net: nn.Module) -> List[Entry]:
    """The entries of a port ``Net``: its backbone's, then its head's, each
    under its scope (``backbone.`` / ``("backbone",)``, ``head.`` / ``("head",)``)."""
    backbone = net.backbone
    if isinstance(backbone, HRNet):
        entries = hrnet_mapping(backbone.stage_cfg)
    elif isinstance(backbone, ResNet):
        entries = resnet_mapping(backbone.block_counts)
    else:
        raise NotImplementedError(
            f"no JAX variable mapping for the backbone {type(backbone).__name__}")
    return ([(kind, f"backbone.{name}", ("backbone",) + path) for kind, name, path in entries]
            + [(kind, f"head.{name}", ("head",) + path) for kind, name, path in
               head_mapping(net.head)])


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


def convert_net_variables(variables: Mapping[str, Any], net: nn.Module) -> Dict[str, torch.Tensor]:
    """Variables of the JAX ``Net`` (``{"params", "batch_stats"}``) -> ``net.state_dict()``.

    The mapping comes from ``net`` (``net_mapping``); ``net``'s own tensors
    are not read, so it may live on the meta device. A tree with the params'
    structure, such as a gradient or an adam moment, converts with the net's
    batch_stats beside it.
    """
    return convert_variables(variables, net_mapping(net))


def convert_variables(variables: Mapping[str, Any],
                      entries: Sequence[Entry]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> a state_dict, by ``entries``.
    Raises if a flax leaf is left unused."""
    params = _leaves(variables["params"])
    stats = _leaves(variables.get("batch_stats", {}))
    used = set()

    def take(tree: Dict[Tuple[str, ...], Any], key: Tuple[str, ...]) -> torch.Tensor:
        used.add(("params" if tree is params else "batch_stats",) + key)
        return _tensor(tree[key])

    out: Dict[str, torch.Tensor] = {}
    for kind, name, path in entries:
        if kind in ("conv", "conv_bias"):
            out[f"{name}.weight"] = take(params, path + ("kernel",)).permute(3, 2, 0, 1).contiguous()
            if kind == "conv_bias":
                out[f"{name}.bias"] = take(params, path + ("bias",))
        elif kind == "deconv":
            kernel = take(params, path + ("kernel",))
            out[f"{name}.weight"] = kernel.flip(0, 1).permute(2, 3, 0, 1).contiguous()
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
