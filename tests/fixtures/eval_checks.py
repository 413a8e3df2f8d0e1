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
  says which joints two nearly equal heatmaps must decode alike;
- ``recording_entry`` and ``compare_callback_with_eval_entry``: what a
  train entry's callback evaluated, held against its last checkpoint
  through the eval entry.
"""
import contextlib
import json
import os

import numpy as np
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
        knobs = {k: kwargs[k] for k in ("bn_stats_frac", "bn_grad_stats") if k in kwargs}
        return HRNet(stage_cfg, in_channels=in_channels, **knobs)

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


@contextlib.contextmanager
def recording_entry(entry):
    """Within the block, the inferencers that ``entry.create_inferencer``
    makes keep each pass's outputs in ``seen["outputs"]``; where ``entry``
    makes its net with ``create_network`` (the train entry), the net goes to
    ``seen["net"]`` and each of its forwards appends (``training``,
    ``torch.is_inference_mode_enabled()``) to ``seen["modes"]``."""
    seen = {"outputs": [], "modes": [], "net": None}
    make_inferencer = entry.create_inferencer
    make_net = getattr(entry, "create_network", None)

    def create_inferencer(*args, **kwargs):
        inferencer = make_inferencer(*args, **kwargs)
        infer = inferencer.infer

        def recorded(dataset):
            outputs = infer(dataset)
            seen["outputs"].append(outputs)
            return outputs

        inferencer.infer = recorded
        return inferencer

    def create_network(*args, **kwargs):
        net = make_net(*args, **kwargs)
        net.register_forward_pre_hook(lambda module, _: seen["modes"].append(
            (module.training, torch.is_inference_mode_enabled())))
        seen["net"] = net
        return net

    entry.create_inferencer = create_inferencer
    if make_net is not None:
        entry.create_network = create_network
    try:
        yield seen
    finally:
        entry.create_inferencer = make_inferencer
        if make_net is not None:
            entry.create_network = make_net


def compare_callback_with_eval_entry(trained: dict, evaluated: dict, ckpt: dict) -> dict:
    """What a train entry's callback evaluated (``recording_entry``'s record of
    the train entry) against its last checkpoint ``ckpt`` (as
    ``load_checkpoint`` reads it) through the eval entry (its record).

    Raises unless every forward of a train step ran in train mode and every
    forward of an evaluation in eval mode, each evaluation following a train
    step's forward; the checkpoint holds the trained net's tensors bit for
    bit; and the eval entry saw the callback's last images, with as many
    persons in each. Returns the evaluations, the persons found, and the
    largest differences of the persons' keypoints (x, y, score, tags) and
    of their scores, for the caller to hold. A top-down record is one crop:
    its person is its ``pred`` (x, y, score), and it has no ``score``."""
    modes = trained["modes"]
    if any(training == inference for training, inference in modes):
        raise AssertionError("a train forward ran in eval mode or an evaluation in train mode")
    evaluations = sum(1 for before, after in zip(modes, modes[1:])
                      if not before[1] and after[1])
    if evaluations != len(trained["outputs"]) or not evaluations:
        raise AssertionError(f"{evaluations} evaluations after a train step, "
                             f"{len(trained['outputs'])} callback passes")
    state = trained["net"].state_dict()
    if set(state) != set(ckpt["net"]) or not all(
            torch.equal(value.cpu(), ckpt["net"][name]) for name, value in state.items()):
        raise AssertionError("the last checkpoint does not hold the trained net")
    got, want = evaluated["outputs"][-1], trained["outputs"][-1]
    if [r["image_path"] for r in got] != [r["image_path"] for r in want] or any(
            np.shape(g["pred"]) != np.shape(w["pred"]) for g, w in zip(got, want)):
        raise AssertionError("the eval entry found other images or persons than the callback")
    top_down = bool(want) and "box" in want[0]
    persons = len(want) if top_down else sum(len(r["pred"]) for r in want)
    pred_err = max((float(np.abs(np.asarray(g["pred"]) - np.asarray(w["pred"])).max())
                    for g, w in zip(got, want) if len(w["pred"])), default=0.0)
    score_err = max((float(np.abs(np.asarray(g["score"]) - np.asarray(w["score"])).max())
                     for g, w in zip(got, want) if len(w.get("score", ()))), default=0.0)
    return {"evaluations": evaluations, "persons": persons, "pred_err": pred_err,
            "score_err": score_err}
