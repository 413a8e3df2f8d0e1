"""Bottom-up evaluation through the port's eval entry against the JAX package's stats.

The fixture (tests/make_torch_bottomup_fixture.py: a reduced HRNet with a
``higher_hrnet_head``, trained by the JAX package on tiny_coco frames) is
evaluated by ``mindpose_tpu_torch/tools/eval.py:evaluate`` on the CPU, from
the JAX package's msgpack file, on the val split its record names. The 10
COCO stats are held to the ones the JAX package recorded:

- O0 (float32), for both matchers: ``device_grouping`` on (the port's plain
  fixed-capacity matcher, ``ops/grouping.py``, against JAX's
  ``match_by_tag_device``) and off (the host Hungarian), within
  ``STATS_ATOL`` (1e-3); the same with hflip and multi-scale [1.0, 0.5]
  TTA and ``refine_missing_joint``;
- O2 (bf16 autocast against JAX's bf16 net), matcher on: each stat within
  ``O2_STATS_ATOL`` (0.02) of JAX's O2, as tests/test_torch_eval.py holds
  top-down O2, or, where bf16 moves JAX's own stat farther from its O0
  value, no farther from JAX's O2 than that. The two frameworks round bf16
  at other places, which moves the fixture's heatmaps by up to 0.018
  (measured; as much as bf16 moves either from float32); one of the
  fixture's 32 persons lies at OKS 0.75, where JAX's O0 and O2 runs put it
  on either side, and a single-threshold stat moves by one person's share
  (AP .75 by 4/101 on the 101-point recall grid).

The decoder's candidates differ from JAX's by float noise only (a few
1e-6 at O0); the fixture was kept only where such noise regroups no val
image (its maker's stability check), since with one tag per joint the
matcher's tie-break is degenerate.
Also: the inferencer groups with the matcher by default where the net runs
on CUDA and with the host Hungarian on the CPU (a config key wins either
way); it runs a net left in train mode in eval mode; the eval entry runs on
the GPU unless asked for the CPU.
"""
import os

import numpy as np
import pytest
import torch

from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.engine import create_inferencer
from mindpose_tpu_torch.models import create_decoder, create_eval_network
from mindpose_tpu_torch.models import create_network_from_config
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.utils.checkpoint import load_net_state_dict
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import BOTTOMUP_CKPT, BOTTOMUP_RECORD, register_port_backbone
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

STATS_ATOL, O2_STATS_ATOL = 1e-3, 0.02
RUNS = [
    # (record key, amp_level, TTA, device_grouping)
    ("jax_stats", "O0", False, True),
    ("jax_stats", "O0", False, False),
    ("jax_stats_tta", "O0", True, True),
    ("jax_stats_tta", "O0", True, False),
    ("jax_stats_o2", "O2", False, True),
]


@pytest.fixture(scope="module")
def val_split(tmp_path_factory):
    register_port_backbone()
    root = str(tmp_path_factory.mktemp("bottomup_val"))
    return tiny_coco.write_val(root)


def _args(val_split, tmp_path, amp_level="O0", **eval_setting):
    img_root, ann = val_split
    cfg = dict(BOTTOMUP_RECORD["config"], val_root=img_root, val_label=ann, ckpt=BOTTOMUP_CKPT,
               amp_level=amp_level, result_path=str(tmp_path / "result.json"))
    cfg["eval_setting"] = dict(cfg["eval_setting"], **eval_setting)
    return Config(**cfg)


@pytest.mark.parametrize("key,amp_level,tta,device_grouping", RUNS,
                         ids=[f"{k} {a} {'tta' if t else 'no tta'} "
                              f"{'matcher' if g else 'host'}" for k, a, t, g in RUNS])
def test_eval_entry_gives_the_jax_stats(val_split, tmp_path, key, amp_level, tta,
                                        device_grouping):
    extra = BOTTOMUP_RECORD["tta"] if tta else {}
    args = _args(val_split, tmp_path, amp_level, device_grouping=device_grouping, **extra)
    timings = {}
    got = port_eval.evaluate(args, device="cpu", timings=timings)
    want = BOTTOMUP_RECORD[key]["device_grouping" if device_grouping else "host"]
    assert list(got)[:10] == list(want)
    for name, value in want.items():
        atol = STATS_ATOL
        if amp_level == "O2":  # as far as bf16 moves JAX's own stat, at least 0.02
            o0 = BOTTOMUP_RECORD["jax_stats"]["device_grouping"][name]
            atol = max(O2_STATS_ATOL, abs(value - o0))
        assert abs(got[name] - value) <= atol, (name, got[name], value)
    assert want["AP"] > 0.2  # persons that group
    # the square max_image_size batches the val images (the batch rule)
    assert timings["batches"] == -(-tiny_coco.VAL_IMAGES // BOTTOMUP_RECORD["config"]["batch_size"])
    assert os.path.exists(tmp_path / "result.json")


def _inferencer(val_split, tmp_path, device="cpu", **eval_setting):
    args = _args(val_split, tmp_path, **eval_setting)
    net = create_network_from_config(args)
    net.load_state_dict(load_net_state_dict(args.ckpt, net), strict=True)
    eval_net = create_eval_network(net, create_decoder(args.decoder_name, **args.decoder_setting))
    return create_inferencer(eval_net, name=args.inference_method, config=args.eval_setting,
                             dataset_config=args.dataset_setting, device=device)


def test_device_grouping_follows_the_device_unless_the_config_says(val_split, tmp_path,
                                                                   monkeypatch):
    cfg = dict(BOTTOMUP_RECORD["config"]["eval_setting"])
    assert "device_grouping" not in cfg
    assert _inferencer(val_split, tmp_path)._inference_cfg["device_grouping"] is False
    assert _inferencer(val_split, tmp_path, device_grouping=True)._inference_cfg[
        "device_grouping"] is True
    # on CUDA the default is the matcher (checked without a card: the
    # default reads only the inferencer's device)
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    inferencer = _inferencer(val_split, tmp_path, device="cuda")
    assert inferencer.device.type == "cuda" and inferencer._inference_cfg["device_grouping"]
    assert _inferencer(val_split, tmp_path, device="cuda", device_grouping=False)._inference_cfg[
        "device_grouping"] is False


def test_a_net_left_in_train_mode_is_evaluated_in_eval_mode(val_split, tmp_path):
    from mindpose_tpu_torch.data import create_dataset, create_pipeline

    inferencer = _inferencer(val_split, tmp_path, device_grouping=True)
    args = _args(val_split, tmp_path)
    ds = create_dataset(args.val_root, args.val_label, dataset_format=args.dataset_format,
                        is_train=False, config=args.dataset_setting)
    batch = next(iter(create_pipeline(ds, args.val_transforms, method="bottomup",
                                      batch_size=4, is_train=False, config=args.dataset_setting)))
    want = inferencer.infer_batch(batch)
    inferencer.net.net.train()
    stats = {k: v.clone() for k, v in inferencer.net.net.state_dict().items()}
    got = inferencer.infer_batch(batch)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k, v in inferencer.net.net.state_dict().items():
        assert torch.equal(v, stats[k]), k  # no running statistic moved


def test_eval_entry_runs_on_the_gpu_unless_asked_for_the_cpu(val_split, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_eval.evaluate(_args(val_split, tmp_path))


def test_persons_are_in_the_original_frame(val_split, tmp_path):
    """Each val image's persons: [P, 17, 3 + L] in the 224x160 frame, one
    score each, where the fixture finds the two drawn persons."""
    inferencer = _inferencer(val_split, tmp_path, device_grouping=True)
    args = _args(val_split, tmp_path)
    from mindpose_tpu_torch.data import create_dataset, create_pipeline

    ds = create_dataset(args.val_root, args.val_label, dataset_format=args.dataset_format,
                        is_train=False, config=args.dataset_setting)
    records = inferencer(create_pipeline(ds, args.val_transforms, method="bottomup",
                                         batch_size=8, is_train=False,
                                         config=args.dataset_setting))
    assert len(records) == tiny_coco.VAL_IMAGES
    h, w = tiny_coco.FRAME_HW
    for rec in records:
        pred = np.asarray(rec["pred"])
        assert pred.ndim == 3 and pred.shape[1:] == (17, 4) and len(rec["score"]) == len(pred)
        seen = pred[pred[..., 2] > 0.1]
        assert (seen[:, 0] > -1).all() and (seen[:, 0] < w + 1).all()
        assert (seen[:, 1] > -1).all() and (seen[:, 1] < h + 1).all()
