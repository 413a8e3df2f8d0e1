"""The evaluation fixture on the port's side, and the decode-margin check.

Shared by ``chip_smoke.py`` and ``tests/test_torch_eval.py``; it imports
torch and the port only, never JAX.

- ``RECORD`` and ``CKPT``: the fixture's record (its eval config, stage
  config and the JAX package's stats) and its checkpoint, both written by
  ``tests/make_torch_eval_fixture.py``;
- ``BOTTOMUP_RECORD`` and ``BOTTOMUP_CKPT``: the bottom-up fixture's (the
  same reduced HRNet with a ``higher_hrnet_head``), written by
  ``tests/make_torch_bottomup_fixture.py``;
- ``register_port_backbone``: the fixture's reduced HRNet in the port's
  registry, under the name the record's config gives it;
- ``decode_margin``: how far a heatmap is from decoding otherwise, which
  says which joints two nearly equal heatmaps must decode alike.
"""
import json
import os

import torch

from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.register import list_components, register

FIXTURE_DIR = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(FIXTURE_DIR, "tiny_hrnet_topdown.msgpack")
with open(os.path.join(FIXTURE_DIR, "tiny_hrnet_topdown.json")) as f:
    RECORD = json.load(f)
BOTTOMUP_CKPT = os.path.join(FIXTURE_DIR, "tiny_higher_hrnet_bottomup.msgpack")
with open(os.path.join(FIXTURE_DIR, "tiny_higher_hrnet_bottomup.json")) as f:
    BOTTOMUP_RECORD = json.load(f)


def register_port_backbone() -> None:
    """Register the fixtures' reduced HRNet in the port's registry (once); both
    fixtures name the same one."""
    name = RECORD["config"]["backbone_name"]
    assert BOTTOMUP_RECORD["config"]["backbone_name"] == name
    assert BOTTOMUP_RECORD["stage_cfg"] == RECORD["stage_cfg"]
    if name in list_components("backbone"):
        return
    stage_cfg = RECORD["stage_cfg"]

    def fixture_hrnet(pretrained=False, ckpt_url="", in_channels=3, **kwargs):
        return HRNet(stage_cfg, in_channels=in_channels)

    register("backbone", extra_name=name)(fixture_hrnet)


def decode_margin(heat: torch.Tensor, shift: bool = True) -> torch.Tensor:
    """Per (crop, joint) of an NCHW heatmap, how far it is from another decode.

    The peak's lead over its runner-up and, with ``shift`` and off the
    border, the differences of its left and right and of its upper and lower
    neighbours (which set the quarter-pixel shift): the smallest of them. A
    change of the heatmap by less than half of it moves neither the argmax
    nor the shift.
    """
    _, _, h, w = heat.shape
    flat = heat.flatten(2)
    top2, idx = torch.topk(flat, 2, dim=2)
    margin = top2[..., 0] - top2[..., 1]
    if not shift:
        return margin
    peak = idx[..., 0]
    x, y = peak % w, peak // w

    def tap(offset: int) -> torch.Tensor:
        return torch.gather(flat, 2, torch.clamp(peak + offset, 0, h * w - 1)[..., None])[..., 0]

    inf = torch.full_like(margin, float("inf"))
    dx = torch.where((x >= 1) & (x <= w - 2), (tap(1) - tap(-1)).abs(), inf)
    dy = torch.where((y >= 1) & (y <= h - 2), (tap(w) - tap(-w)).abs(), inf)
    return torch.minimum(margin, torch.minimum(dx, dy))
