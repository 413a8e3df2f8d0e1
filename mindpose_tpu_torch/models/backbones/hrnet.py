"""HRNet backbones (HRNet-W32/W48), NCHW.

Counterpart of mindpose_tpu/models/backbones/hrnet.py: the same topology
(stem /4, bottleneck stage 1, 2/3/4-branch stages with exchange units; with
``multiscale_output: False`` the last module returns the highest-resolution
branch only), with the submodule names of the official HRNet torch code
(conv1 ... layer1, transition1, stage2.0.branches.0.0.conv1,
stage2.0.fuse_layers.0.1.0, ...). Those are the names that the JAX
package's ``export_backbone_state(..., naming="torch")`` emits.

``remat: true`` recomputes each exchange unit (``HRModule``) in the
backward pass instead of keeping its activations, as the JAX package's
``nn.remat(HRModule)`` does (:195), through ``torch.utils.checkpoint``. flax's
remat is functional and updates the BatchNorm running statistics once; the
recompute here runs the forward a second time, so it runs under
``frozen_statistics`` and the statistics update once, with the values they
take without remat.

The JAX package's other TPU knobs are checked once, in ``_hrnet``: the
space-to-depth rewrites (``stem_s2d``, ``branch0_s2d``) and
``bn_grad_stats: fused`` (exact BN with a hand-written backward) change no
result, so they are accepted and build plain BN here; subsampled BN
statistics (``bn_stats_frac < 1``) and frozen-statistic gradients
(``frozen``, ``frozen_var``) were measured to diverge
(docs/performance.md:103-122) and are refused.
"""
import contextlib
import copy
from typing import Any, Dict, List, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...register import register
from ..common import (
    BatchNorm2d,
    check_bn_settings,
    conv1x1,
    conv3x3,
    frozen_statistics,
    resize_nearest,
)
from .backbone import Backbone
from .resnet import BasicBlock, Bottleneck

__all__ = ["HRModule", "HRNet", "hrnet_w32", "hrnet_w48", "w_cfg"]

_BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}
_KNOBS = ("remat", "stem_s2d", "branch0_s2d", "bn_stats_frac", "bn_grad_stats")


def _conv_bn(conv: nn.Conv2d, channels: int, relu: bool) -> nn.Sequential:
    layers = [conv, BatchNorm2d(channels)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class HRModule(nn.Module):
    """One exchange unit: per-branch residual blocks then cross-scale fusion.

    ``remat``: a train-mode forward that records gradients keeps only its
    inputs, and the backward recomputes the rest.
    """

    def __init__(
        self,
        num_branches: int,
        block: str,
        num_blocks: Sequence[int],
        in_channels: Sequence[int],
        num_channels: Sequence[int],
        multi_scale_output: bool = True,
        remat: bool = False,
    ) -> None:
        super().__init__()
        self.remat = remat
        block_cls = _BLOCKS[block]
        out_ch = [c * block_cls.expansion for c in num_channels]

        branches = []
        for i in range(num_branches):
            layers = [block_cls(in_channels[i], num_channels[i],
                                downsample=in_channels[i] != out_ch[i])]
            for _ in range(1, num_blocks[i]):
                layers.append(block_cls(out_ch[i], num_channels[i]))
            branches.append(nn.Sequential(*layers))
        self.branches = nn.ModuleList(branches)

        self.fuse_layers = None
        if num_branches > 1:
            rows = []
            for i in range(num_branches if multi_scale_output else 1):
                row: List[nn.Module] = []
                for j in range(num_branches):
                    if j > i:
                        # lower resolution: 1x1 conv + BN, upsampled in forward
                        row.append(_conv_bn(conv1x1(out_ch[j], out_ch[i]), out_ch[i], False))
                    elif j == i:
                        row.append(None)
                    else:
                        # higher resolution: a chain of strided 3x3 convs
                        chain = []
                        for k in range(i - j):
                            last = k == i - j - 1
                            ch = out_ch[i] if last else out_ch[j]
                            chain.append(_conv_bn(conv3x3(out_ch[j], ch, 2), ch, not last))
                        row.append(nn.Sequential(*chain))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._forward(xs)
        # the forward runs as it is; the recompute leaves the statistics be
        return list(checkpoint(
            self._forward_tuple, *xs, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), frozen_statistics(self))))

    def _forward_tuple(self, *xs: torch.Tensor) -> tuple:
        return tuple(self._forward(list(xs)))

    def _forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            h, w = ys[i].shape[2:]
            acc = ys[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                t = layer(ys[j])
                if j > i:
                    t = resize_nearest(t, h, w)
                acc = acc + t
            fused.append(torch.relu(acc))
        return fused


class HRNet(Backbone):
    """HRNet backbone; returns the highest-resolution (stride-4) NCHW feature.

    ``stage_cfg`` is the stage dict of ``w_cfg`` (or a reduced one in the
    same form); ``remat`` recomputes every exchange unit in the backward.
    """

    def __init__(
        self,
        stage_cfg: Dict[str, Dict[str, Any]],
        in_channels: int = 3,
        remat: bool = False,
    ) -> None:
        super().__init__()
        self.stage_cfg = copy.deepcopy(stage_cfg)
        self.conv1 = conv3x3(in_channels, 64, 2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = conv3x3(64, 64, 2)
        self.bn2 = BatchNorm2d(64)

        cfg1 = stage_cfg["stage1"]
        block_cls = _BLOCKS[cfg1["block"]]
        ch1 = cfg1["num_channels"][0]
        blocks = [block_cls(64, ch1, downsample=True)]
        for _ in range(1, cfg1["num_blocks"][0]):
            blocks.append(block_cls(ch1 * block_cls.expansion, ch1))
        self.layer1 = nn.Sequential(*blocks)
        pre_channels = [ch1 * block_cls.expansion]

        for t, stage_name in enumerate(("stage2", "stage3", "stage4"), start=1):
            cfg = stage_cfg[stage_name]
            expansion = _BLOCKS[cfg["block"]].expansion
            cur_channels = [c * expansion for c in cfg["num_channels"]]
            setattr(self, f"transition{t}", self._transition(pre_channels, cur_channels))
            multi_out = cfg.get("multiscale_output", True)
            modules = []
            for m in range(cfg["num_modules"]):
                is_last_module = m == cfg["num_modules"] - 1
                modules.append(HRModule(
                    num_branches=cfg["num_branches"],
                    block=cfg["block"],
                    num_blocks=cfg["num_blocks"],
                    in_channels=cur_channels,
                    num_channels=cfg["num_channels"],
                    multi_scale_output=multi_out or not is_last_module,
                    remat=remat,
                ))
            setattr(self, stage_name, nn.Sequential(*modules))
            pre_channels = cur_channels

    @property
    def out_channels(self) -> int:
        return self.stage_cfg["stage4"]["num_channels"][0]

    @staticmethod
    def _transition(pre_channels, cur_channels) -> nn.ModuleList:
        """Create/adapt branches between stages (a None entry passes through)."""
        layers: List[nn.Module] = []
        num_pre = len(pre_channels)
        for i, ch in enumerate(cur_channels):
            if i < num_pre:
                if ch != pre_channels[i]:
                    layers.append(_conv_bn(conv3x3(pre_channels[i], ch), ch, True))
                else:
                    layers.append(None)
            else:
                # new lower-resolution branch from the last previous branch
                chain = []
                for j in range(i + 1 - num_pre):
                    c = ch if j == i - num_pre else pre_channels[-1]
                    chain.append(_conv_bn(conv3x3(pre_channels[-1], c, 2), c, True))
                layers.append(nn.Sequential(*chain))
        return nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for t, stage_name in enumerate(("stage2", "stage3", "stage4"), start=1):
            branches = []
            for i, layer in enumerate(getattr(self, f"transition{t}")):
                if i >= len(xs):
                    branches.append(layer(xs[-1]))
                else:
                    branches.append(xs[i] if layer is None else layer(xs[i]))
            xs = getattr(self, stage_name)(branches)
        return xs[0]


def w_cfg(width: int) -> Dict[str, Dict[str, Any]]:
    """Stage config of HRNet-W<width> (mindpose_tpu/models/backbones/hrnet.py:254-286)."""
    return {
        "stage1": {
            "num_modules": 1,
            "num_branches": 1,
            "block": "BOTTLENECK",
            "num_blocks": (4,),
            "num_channels": (64,),
        },
        "stage2": {
            "num_modules": 1,
            "num_branches": 2,
            "block": "BASIC",
            "num_blocks": (4, 4),
            "num_channels": (width, width * 2),
        },
        "stage3": {
            "num_modules": 4,
            "num_branches": 3,
            "block": "BASIC",
            "num_blocks": (4, 4, 4),
            "num_channels": (width, width * 2, width * 4),
        },
        "stage4": {
            "num_modules": 3,
            "num_branches": 4,
            "block": "BASIC",
            "num_blocks": (4, 4, 4, 4),
            "num_channels": (width, width * 2, width * 4, width * 8),
            "multiscale_output": False,
        },
    }


def _hrnet(width: int, in_channels: int, kwargs: Dict[str, Any]) -> HRNet:
    unknown = sorted(set(kwargs) - set(_KNOBS))
    if unknown:
        raise TypeError(f"unknown HRNet settings: {unknown}")
    check_bn_settings(kwargs.get("bn_grad_stats", "exact"), kwargs.get("bn_stats_frac", 1.0))
    return HRNet(w_cfg(width), in_channels=in_channels, remat=bool(kwargs.get("remat", False)))


@register("backbone")
def hrnet_w32(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
              **kwargs: Any) -> HRNet:
    """HRNet-W32."""
    return _hrnet(32, in_channels, kwargs)


@register("backbone")
def hrnet_w48(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
              **kwargs: Any) -> HRNet:
    """HRNet-W48."""
    return _hrnet(48, in_channels, kwargs)
