"""ViT backbones for ViTPose-style top-down estimation (NCHW in, NCHW out).

Counterpart of mindpose_tpu/models/backbones/vit.py: a plain Vision
Transformer ("ViTPose", arXiv:2204.12484) with a p x p stride-p patch embed,
a learned position grid and no class token, pre-LN encoder blocks, and a
final LayerNorm; the token grid goes back to a [N, D, gh, gw] map for the
deconv head. The submodules carry timm/ViTPose names (``patch_embed.proj``,
``pos_embed``, ``blocks.{i}.norm1/attn.qkv/attn.proj/norm2/mlp.fc1/mlp.fc2``,
``norm``), with query, key and value in one fused ``qkv`` Linear;
``models/convert.py`` carries the JAX package's variables across.

What it computes is flax's: LayerNorm epsilon 1e-6 (torch's default is
1e-5); the tanh GELU (``flax.linen.gelu`` defaults to ``approximate=True``);
the query divided by sqrt(head_dim) before its product with the keys, as
``flax.linen.dot_product_attention_weights`` does. Attention is plain tensor
products and a softmax, as the JAX package computes it outside any Pallas
kernel.

The position grid is stored as (1, gh, gw, D), as the JAX package stores it,
so a grid trained at another resolution resizes onto it on load
(``utils/checkpoint.load_pretrained_backbone``). A torch module allocates it
when built, where flax sizes it from the first input: ``image_size`` ([W, H],
as a config's ``dataset_setting`` gives it) sets the grid, and defaults to
every ViTPose recipe's 192 x 256. ``pretrained`` and ``ckpt_url`` are
accepted and ignored, as in the JAX package: the train entry loads the file.
"""
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...register import register
from ..common import dense, lecun_normal_
from .backbone import Backbone

__all__ = ["Attention", "EncoderBlock", "MlpBlock", "PatchEmbed", "ViT",
           "vit_b", "vit_h", "vit_l", "vit_s"]

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon
DEFAULT_IMAGE_SIZE = (192, 256)  # [W, H] of every configs/vitpose recipe


class MlpBlock(nn.Module):
    """Linear -> tanh GELU -> Linear."""

    def __init__(self, dim: int, mlp_dim: int) -> None:
        super().__init__()
        self.fc1 = dense(dim, mlp_dim)
        self.fc2 = dense(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask, no dropout)."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden_dim {dim} is not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(n, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        q = q / math.sqrt(d // h)
        weights = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
        return self.proj((weights @ v).transpose(1, 2).reshape(n, t, d))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(norm1(x)), then x + mlp(norm2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """p x p stride-p conv from the image to the token grid."""

    def __init__(self, patch_size: int, in_channels: int, dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)
        lecun_normal_(self.proj.weight, in_channels * patch_size * patch_size)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ViT(Backbone):
    """Plain ViT; returns a [N, hidden_dim, H / p, W / p] map."""

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_ratio: int = 4, in_channels: int = 3,
                 image_size: Sequence[int] = DEFAULT_IMAGE_SIZE) -> None:
        super().__init__()
        w, h = (int(s) for s in image_size)
        if h % patch_size or w % patch_size:
            raise ValueError(f"image_size {w}x{h} (W x H) is not a multiple of the patch "
                             f"size {patch_size}")
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.grid = (h // patch_size, w // patch_size)
        self.patch_embed = PatchEmbed(patch_size, in_channels, hidden_dim)
        self.pos_embed = nn.Parameter(torch.empty(1, *self.grid, hidden_dim))
        nn.init.normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, hidden_dim * mlp_ratio) for _ in range(depth))
        self.norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    @property
    def out_channels(self) -> int:
        return self.hidden_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        n, d, h, w = x.shape
        if (h, w) != self.grid:
            raise ValueError(f"the input gives a {h}x{w} token grid; this ViT's position grid "
                             f"is {self.grid[0]}x{self.grid[1]} (set image_size)")
        # token t = i * w + j, as flax's NHWC reshape numbers them
        x = x.flatten(2).transpose(1, 2) + self.pos_embed.reshape(1, h * w, d)
        for block in self.blocks:
            x = block(x)
        return self.norm(x).transpose(1, 2).reshape(n, d, h, w)


def _vit(hidden_dim: int, depth: int, num_heads: int, in_channels: int,
         kwargs: Any) -> ViT:
    unknown = sorted(set(kwargs) - {"image_size"})
    if unknown:
        raise TypeError(f"unknown ViT settings: {unknown}")
    return ViT(hidden_dim=hidden_dim, depth=depth, num_heads=num_heads, in_channels=in_channels,
               image_size=kwargs.get("image_size", DEFAULT_IMAGE_SIZE))


@register("backbone")
def vit_s(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
          **kwargs: Any) -> ViT:
    """ViT-Small/16 (22M params): ViTPose-S backbone."""
    return _vit(384, 12, 6, in_channels, kwargs)


@register("backbone")
def vit_b(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
          **kwargs: Any) -> ViT:
    """ViT-Base/16 (86M params): ViTPose-B backbone."""
    return _vit(768, 12, 12, in_channels, kwargs)


@register("backbone")
def vit_l(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
          **kwargs: Any) -> ViT:
    """ViT-Large/16 (304M params): ViTPose-L backbone."""
    return _vit(1024, 24, 16, in_channels, kwargs)


@register("backbone")
def vit_h(pretrained: bool = False, ckpt_url: str = "", in_channels: int = 3,
          **kwargs: Any) -> ViT:
    """ViT-Huge/16 (~632M params): ViTPose-H backbone."""
    return _vit(1280, 32, 16, in_channels, kwargs)
