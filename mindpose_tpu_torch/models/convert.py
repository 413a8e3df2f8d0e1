"""Carry the JAX package's trained variables into the port's modules.

The JAX package keeps a model's weights as flax trees, ``{"params": ...,
"batch_stats": ...}``, whose paths follow flax's auto-naming (``HRModule_3``,
``Bottleneck_5``, ``Conv_0``, ``ConvTranspose_1``, ...). The port's modules
use the official torch names (``stage3.0.branches.1.1.conv1``,
``layer2.0.downsample.0``, ``deconv_layers.3``). A mapping pairs the two, in
the order in which the JAX modules create their submodules: ``hrnet_mapping``
for any HRNet stage config, ``resnet_mapping`` for any block counts,
``vit_mapping`` for any ViT depth, and one for each head (the SimCC and
RLE heads' Linear layers are "dense" entries, flax ``Dense`` [in, out] ->
torch ``Linear`` [out, in]). ``net_mapping``
picks the backbone's and the head's from the port's net itself, so
reduced-depth nets convert as well as full ones.

Layout changes: conv kernel [kh, kw, I, O] -> weight [O, I, kh, kw]; a
transposed conv's kernel [kh, kw, I, O] -> weight [I, O, kh, kw], flipped in
both spatial axes (flax's ``ConvTranspose`` with ``transpose_kernel=False``
does not flip it, torch's ``ConvTranspose2d`` does); BN scale -> weight,
bias -> bias, batch_stats mean/var -> running_mean/var;
``num_batches_tracked``, which flax has no counterpart of, is set to 0.
ViT (the layout changes of the JAX package's ``export_vit_state``): a Dense
kernel [I, O] -> weight [O, I]; LayerNorm scale -> weight; the attention's
query/key/value kernels [D, heads, hd] -> one fused ``qkv.weight`` [3D, D]
and their biases [heads, hd] -> ``qkv.bias`` [3D]; its ``out`` kernel
[heads, hd, D] -> ``proj.weight`` [D, D]; the patch kernel [p, p, 3, D] ->
[D, 3, p, p] (a conv's); ``pos_embedding`` (1, gh, gw, D) as it is.
The result loads with ``load_state_dict(strict=True)``. ``export_variables``
goes the other way.
"""
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .backbones.hrnet import HRNet
from .backbones.resnet import ResNet
from .backbones.vit import Attention, ViT
from .heads.higher_hrnet_head import HigherHRNetHead
from .heads.hrnet_head import HRNetHead
from .heads.rle_head import RLERegressionHead
from .heads.simcc_head import SimCCHead
from .heads.simple_baseline_head import SimpleBaselineHead

__all__ = ["hrnet_mapping", "resnet_mapping", "vit_mapping", "head_mapping", "net_mapping",
           "convert_variables", "convert_net_variables", "export_variables", "num_heads"]

# (kind, torch prefix, flax path): kind is "conv" (no bias), "conv_bias",
# "deconv" (a transposed conv, no bias), "bn", "dense", "layernorm", "qkv"
# (the attention's fused query/key/value; the flax path is the attention's),
# "out" (the attention's output projection) or "param" (one bare parameter:
# the torch name and the flax path are the leaf's own)
Entry = Tuple[str, str, Tuple[str, ...]]

_QKV = ("query", "key", "value")

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


def vit_mapping(depth: int) -> List[Entry]:
    """(kind, torch prefix, flax path) for every tensor of a ViT backbone."""
    entries: List[Entry] = [("conv_bias", "patch_embed.proj", ("patch_embed",)),
                            ("param", "pos_embed", ("pos_embedding",))]
    for i in range(depth):
        blk = (f"block_{i}",)
        attn = blk + ("MultiHeadDotProductAttention_0",)
        entries += [("layernorm", f"blocks.{i}.norm1", blk + ("LayerNorm_0",)),
                    ("qkv", f"blocks.{i}.attn.qkv", attn),
                    ("out", f"blocks.{i}.attn.proj", attn + ("out",)),
                    ("layernorm", f"blocks.{i}.norm2", blk + ("LayerNorm_1",)),
                    ("dense", f"blocks.{i}.mlp.fc1", blk + ("MlpBlock_0", "Dense_0")),
                    ("dense", f"blocks.{i}.mlp.fc2", blk + ("MlpBlock_0", "Dense_1"))]
    return entries + [("layernorm", "norm", ("norm",))]


def head_mapping(head: nn.Module) -> List[Entry]:
    """The entries of a port head: ``hrnet_head``, ``simple_baseline_head``,
    ``higher_hrnet_head``, ``simcc_head`` or ``rle_head``."""
    if isinstance(head, HRNetHead):
        return [("conv_bias", "head", ("head",))]
    if isinstance(head, SimCCHead):
        return [("conv_bias", "final_conv", ("final_conv",)),
                ("dense", "mlp_x", ("mlp_x",)), ("dense", "mlp_y", ("mlp_y",))]
    if isinstance(head, RLERegressionHead):
        return [("dense", "fc_coord", ("fc_coord",)), ("dense", "fc_sigma", ("fc_sigma",))]
    if isinstance(head, SimpleBaselineHead):
        convs = [i for i, m in enumerate(head.deconv_layers) if isinstance(m, nn.ConvTranspose2d)]
        entries: List[Entry] = []
        for n, i in enumerate(convs):
            entries.append(("deconv", f"deconv_layers.{i}", (f"ConvTranspose_{n}",)))
            entries.append(("bn", f"deconv_layers.{i + 1}", (f"BatchNorm_{n}",)))
        return entries + [("conv_bias", "final_layer", ("final_layer",))]
    if isinstance(head, HigherHRNetHead):
        entries = [("conv_bias", f"final_layers.{i}", (f"final_{i}",))
                   for i in range(len(head.final_layers))]
        g = 0  # flax numbers the BasicBlocks of all stages in one sequence
        for i, stage in enumerate(head.deconv_layers):
            entries.append(("deconv", f"deconv_layers.{i}.0", (f"ConvTranspose_{i}",)))
            entries.append(("bn", f"deconv_layers.{i}.1", (f"BatchNorm_{i}",)))
            for b in range(3, len(stage)):
                entries += _residual_block(f"deconv_layers.{i}.{b}", (f"BasicBlock_{g}",), 2,
                                           downsample=False)
                g += 1
        return entries
    raise NotImplementedError(f"no JAX variable mapping for the head {type(head).__name__}")


def net_mapping(net: nn.Module) -> List[Entry]:
    """The entries of a port ``Net``: its backbone's, then its head's, each
    under its scope (``backbone.`` / ``("backbone",)``, ``head.`` / ``("head",)``)."""
    backbone = net.backbone
    if isinstance(backbone, HRNet):
        entries = hrnet_mapping(backbone.stage_cfg)
    elif isinstance(backbone, ResNet):
        entries = resnet_mapping(backbone.block_counts)
    elif isinstance(backbone, ViT):
        entries = vit_mapping(backbone.depth)
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
        elif kind in ("dense", "out"):
            kernel = take(params, path + ("kernel",))
            out[f"{name}.weight"] = kernel.reshape(-1, kernel.shape[-1]).t().contiguous()
            out[f"{name}.bias"] = take(params, path + ("bias",))
        elif kind == "qkv":
            kernels = [take(params, path + (p, "kernel")) for p in _QKV]
            out[f"{name}.weight"] = torch.cat([k.reshape(k.shape[0], -1).t() for k in kernels])
            out[f"{name}.bias"] = torch.cat([take(params, path + (p, "bias")).reshape(-1)
                                             for p in _QKV])
        elif kind == "layernorm":
            out[f"{name}.weight"] = take(params, path + ("scale",))
            out[f"{name}.bias"] = take(params, path + ("bias",))
        elif kind == "param":
            out[name] = take(params, path)
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


def export_variables(state: Mapping[str, torch.Tensor], entries: Sequence[Entry],
                     num_heads: Mapping[str, int]) -> Dict[str, Any]:
    """A state_dict -> flax ``{"params", "batch_stats"}`` (numpy), by ``entries``:
    ``convert_variables`` undone. ``num_heads`` gives each "qkv" and "out"
    entry's head count by its torch prefix (flax keeps the heads as an
    axis; ``num_heads(module)`` lists a module's). An entry
    whose tensors are not all in ``state``, or whose fused attention tensors
    do not split into those heads, is left out."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(tree: Dict[str, Any], path: Tuple[str, ...], value: torch.Tensor) -> None:
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = value.detach().cpu().numpy()

    get = state.get
    for kind, name, path in entries:
        if kind == "param":
            if get(name) is not None:
                put(params, path, get(name))
            continue
        w, b = get(f"{name}.weight"), get(f"{name}.bias")
        if w is None or (b is None and kind not in ("conv", "deconv")):
            continue
        if kind in ("conv", "conv_bias"):
            put(params, path + ("kernel",), w.permute(2, 3, 1, 0))
            if kind == "conv_bias":
                put(params, path + ("bias",), b)
        elif kind == "deconv":
            put(params, path + ("kernel",), w.permute(2, 3, 0, 1).flip(0, 1))
        elif kind == "dense":
            put(params, path + ("kernel",), w.t())
            put(params, path + ("bias",), b)
        elif kind == "out":  # [D_out, D_in] -> [heads, hd, D_out]
            h = num_heads[name]
            if w.shape[1] % h:
                continue
            put(params, path + ("kernel",), w.t().reshape(h, w.shape[1] // h, w.shape[0]))
            put(params, path + ("bias",), b)
        elif kind == "qkv":  # [3D, D] -> 3 x [D, heads, hd]
            h, d = num_heads[name], w.shape[1]
            if d % h or w.shape[0] != 3 * d or b.shape[0] != 3 * d:
                continue
            for p, wj, bj in zip(_QKV, w.chunk(3), b.chunk(3)):
                put(params, path + (p, "kernel"), wj.t().reshape(d, h, d // h))
                put(params, path + (p, "bias"), bj.reshape(h, d // h))
        elif kind == "layernorm":
            put(params, path + ("scale",), w)
            put(params, path + ("bias",), b)
        else:
            mean, var = get(f"{name}.running_mean"), get(f"{name}.running_var")
            if mean is None or var is None:
                continue
            put(params, path + ("scale",), w)
            put(params, path + ("bias",), b)
            put(stats, path + ("mean",), mean)
            put(stats, path + ("var",), var)
    return {"params": params, "batch_stats": stats}


def num_heads(module: nn.Module) -> Dict[str, int]:
    """Each ViT attention's head count under ``module``, by the torch prefix
    of its "qkv" and "out" entries (``...blocks.{i}.attn.qkv`` / ``.proj``)."""
    return {f"{name}.{part}": m.num_heads for name, m in module.named_modules()
            if isinstance(m, Attention) for part in ("qkv", "proj")}
