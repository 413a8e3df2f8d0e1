"""The port's top-down evaluation against the JAX package's, through the entry points.

- The inferencer: the reduced HRNet (tests/test_torch_hrnet.py, weights
  carried across by ``convert_net_variables``) fed the same val batches as
  JAX's ``TopDownHeatMapInferencer``, with TTA off, on, and on with
  ``shift_heatmap``. At O0 (float32 on both) every score agrees within
  1e-5 (the heatmaps reach ~2.6), and every clear joint within 1e-3 px:
  one whose heatmap peak leads its runner-up, and whose neighbours on
  each side of the peak (which set the quarter-pixel shift) differ, by
  more than 1e-4 (far above float32's ~1e-6 difference); boxes, image
  paths and bbox ids are equal. At O2 (JAX's bf16 net against bf16
  autocast, which round BatchNorm and the convs differently) the scores
  agree within 0.02 x max|heatmap| (measured 0.0065), the joints clear by
  more than that within 1e-3 px, and at least 80% of all joints (measured
  87-91%); where peaks or neighbours are closer than bf16's rounding the
  two pick different maxima or shifts.
- End to end: the committed fixture checkpoint (tests/make_torch_eval_fixture.py)
  evaluated by the JAX package and by ``mindpose_tpu_torch.tools.eval``
  at O0 on the fixture's val split gives the same 10 COCO stats within
  1e-3, an AP of at least 0.5, and the AP recorded beside the checkpoint.
  At O2 (JAX in bf16, the port in bf16 autocast) the stats agree within
  0.02 (measured 0.0078: the AP 0.6740 against JAX's 0.6662, one joint
  decoded apart moves a 32-crop AP by about that).
"""
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu.engine.inferencer.topdown_inferencer import (
    TopDownHeatMapInferencer as JaxInferencer,
)
from mindpose_tpu.models.backbones.hrnet import HRNet as JaxHRNet
from mindpose_tpu.models.backbones.hrnet import _freeze_cfg
from mindpose_tpu.models.decoders.top_down_decoder import TopDownHeatMapDecoder as JaxDecoder
from mindpose_tpu.models.heads.hrnet_head import HRNetHead as JaxHRNetHead
from mindpose_tpu.models.networks import EvalNet as JaxEvalNet
from mindpose_tpu.models.networks import Net as JaxNet
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.engine import create_inferencer
from mindpose_tpu_torch.models import create_decoder, create_eval_network, create_network
from mindpose_tpu_torch.tools import eval as port_eval
from mindpose_tpu_torch.utils.checkpoint import load_net_state_dict, save_checkpoint
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import CKPT, RECORD, decode_margin, register_port_backbone
from tests.helpers import DATASET_SETTING, make_tiny_coco
from tests.test_torch_hrnet import CFG, build_pair

SETTING = dict(DATASET_SETTING, image_size=[48, 64], heatmap_size=[12, 16])
TTA_MODES = [(False, False), (True, False), (True, True)]
DECODER = {"shift_coordinate": True}
O0_SCORE_ATOL, PEAK_GAP, XY_ATOL = 1e-5, 1e-4, 1e-3
O2_SCORE_RTOL, O2_AGREE = 0.02, 0.8
STATS_ATOL, O2_STATS_ATOL = 1e-3, 0.02


class _Batches(list):
    """Loader batches, with the loader's batch size (JAX pads to it)."""

    batch_size = 3


@pytest.fixture(scope="module")
def val_batches(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tiny_coco"))
    img_root, ann = make_tiny_coco(root, num_images=4, people_per_img=2)
    ds = jax_create_dataset(img_root, ann, is_train=False, config=SETTING,
                            use_gt_bbox_for_val=True)
    loader = jax_create_pipeline(ds, ["topdown_box_to_center_scale", "topdown_affine"],
                                 batch_size=_Batches.batch_size, is_train=False, config=SETTING)
    return _Batches(loader)  # 8 records: batches of 3, 3 and 2


@pytest.fixture(scope="module")
def nets():
    jax_net, variables, port, _ = build_pair()
    return variables, port


def _jax_net(amp_level):
    dtype = jnp.bfloat16 if amp_level != "O0" else jnp.float32
    return JaxNet(backbone=JaxHRNet(stage_cfg=_freeze_cfg(CFG), dtype=dtype),
                  head=JaxHRNetHead(in_channels=8, num_joints=17, dtype=dtype))


@pytest.mark.parametrize("amp_level", ["O0", "O2"])
@pytest.mark.parametrize("tta, shift", TTA_MODES, ids=["tta off", "tta on", "tta shift"])
def test_inferencer_matches_jax(val_batches, nets, amp_level, tta, shift):
    variables, port = nets
    config = {"has_heatmap_output": True, "hflip_tta": tta, "shift_heatmap": shift}
    want = JaxInferencer(JaxEvalNet(_jax_net(amp_level), JaxDecoder(**DECODER)),
                         config=dict(config, **SETTING))(val_batches, variables=variables)
    inferencer = create_inferencer(
        create_eval_network(port, create_decoder("topdown_heatmap", **DECODER)),
        config=config, dataset_config=SETTING, device="cpu", amp_level=amp_level)
    got = inferencer(val_batches)

    assert [r["image_path"] for r in got] == [r["image_path"] for r in want]
    assert [r["bbox_id"] for r in got] == [r["bbox_id"] for r in want]
    np.testing.assert_array_equal([r["box"] for r in got], [r["box"] for r in want])
    heat = torch.cat([inferencer.heatmaps(torch.from_numpy(b["image"]).permute(0, 3, 1, 2))
                      for b in val_batches]).float()
    margin = decode_margin(heat).numpy()
    pred, pred_jax = np.array([r["pred"] for r in got]), np.array([r["pred"] for r in want])
    xy_err = np.abs(pred[..., :2] - pred_jax[..., :2]).max(-1)
    score_err = np.abs(pred[..., 2] - pred_jax[..., 2]).max()
    if amp_level == "O0":
        score_tol, clear = O0_SCORE_ATOL, margin > PEAK_GAP
        assert clear.mean() > 0.9
    else:
        score_tol = O2_SCORE_RTOL * float(heat.abs().max())
        clear = margin > score_tol
        assert (xy_err <= XY_ATOL).mean() >= O2_AGREE
    assert score_err <= score_tol
    assert (xy_err[clear] <= XY_ATOL).all()


def test_inferencer_needs_the_gpu_by_default(nets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eval_net = create_eval_network(nets[1], create_decoder("topdown_heatmap"))
    config = {"has_heatmap_output": True, "hflip_tta": False, "shift_heatmap": False}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_inferencer(eval_net, config=config, dataset_config=SETTING)
    with pytest.raises(ValueError, match="amp_level"):
        create_inferencer(eval_net, config=config, dataset_config=SETTING, device="cpu",
                          amp_level="O4")
    with pytest.raises(ValueError, match="heatmap output"):
        create_inferencer(eval_net, config=dict(config, hflip_tta=True, has_heatmap_output=False),
                          dataset_config=SETTING, device="cpu")


@pytest.fixture(scope="module")
def fixture_args(tmp_path_factory):
    """The fixture's eval config, with its val split written under a temporary directory."""
    root = tmp_path_factory.mktemp("fixture")
    val_root, val_label = tiny_coco.write_val(str(root / "val"))
    fixture.register_jax_backbone()
    register_port_backbone()
    return dict(RECORD["config"], val_root=val_root, val_label=val_label, ckpt=CKPT,
                result_path=str(root / "result.json"))


def _stats(result):
    return np.array([result[name] for name in fixture.STAT_NAMES])


def test_fixture_checkpoint_gives_the_jax_stats(fixture_args, tmp_path):
    assert RECORD["config"] == fixture.CONFIG and RECORD["stage_cfg"] == fixture.STAGE_CFG
    recorded = _stats(RECORD["jax_stats"])
    jax_stats = _stats(fixture.jax_evaluate(fixture_args, fixture_args["ckpt"], str(tmp_path)))
    np.testing.assert_allclose(jax_stats, recorded, rtol=0, atol=STATS_ATOL)

    timings = {}
    result = port_eval.evaluate(Config(**fixture_args), device="cpu", timings=timings)
    port_stats = _stats(result)
    np.testing.assert_allclose(port_stats, jax_stats, rtol=0, atol=STATS_ATOL)
    assert port_stats[0] >= fixture.TARGET_AP
    assert abs(port_stats[0] - recorded[0]) <= STATS_ATOL
    with open(fixture_args["result_path"]) as f:
        assert json.load(f) == {k: float(v) for k, v in result.items()}
    assert timings["records"] == 2 * tiny_coco.VAL_IMAGES
    assert timings["batches"] == -(-timings["records"] // fixture_args["batch_size"])


def test_fixture_checkpoint_at_o2_gives_the_jax_bf16_stats(fixture_args, tmp_path):
    args = dict(fixture_args, amp_level="O2")
    recorded = _stats(RECORD["jax_stats_o2"])
    jax_stats = _stats(fixture.jax_evaluate(args, args["ckpt"], str(tmp_path)))
    np.testing.assert_allclose(jax_stats, recorded, rtol=0, atol=STATS_ATOL)
    port_stats = _stats(port_eval.evaluate(Config(**args), device="cpu"))
    np.testing.assert_allclose(port_stats, jax_stats, rtol=0, atol=O2_STATS_ATOL)
    assert port_stats[0] >= fixture.TARGET_AP


def test_port_checkpoint_and_cli_give_the_same_stats(fixture_args, tmp_path, monkeypatch):
    """The fixture's weights saved as a port checkpoint, through the CLI."""
    net = create_network(fixture.BACKBONE, "hrnet_head")
    net.load_state_dict(load_net_state_dict(fixture_args["ckpt"], net), strict=True)
    ckpt = str(tmp_path / "fixture.pt")
    save_checkpoint(ckpt, net)
    want = port_eval.evaluate(Config(**fixture_args), device="cpu")

    config = tmp_path / "fixture.yaml"
    config.write_text(json.dumps(RECORD["config"]))  # JSON is YAML
    result_path = tmp_path / "cli" / "result.json"
    result_path.parent.mkdir()
    monkeypatch.setattr(sys, "argv", [
        "eval", "--config", str(config), "--ckpt", ckpt, "--device", "cpu", "--cfg-options",
        f"val_root={fixture_args['val_root']}", f"val_label={fixture_args['val_label']}",
        f"result_path={result_path}"])
    port_eval.main()
    with open(result_path) as f:
        assert json.load(f) == {k: float(v) for k, v in want.items()}
    assert not (tmp_path / "cli" / "result_keypoints.json").exists()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_eval.evaluate(Config(**dict(fixture_args, ckpt=ckpt)))


def test_inferencer_evaluates_a_net_a_train_step_left_in_train_mode(val_batches, nets):
    """The train entry's callback evaluates the net it trains, which the last
    train step left in train mode: the inferencer still runs it in eval mode
    (running statistics, none updated), as JAX applies it with train=False."""
    _, port = nets
    config = {"has_heatmap_output": True, "hflip_tta": False, "shift_heatmap": False}
    inferencer = create_inferencer(
        create_eval_network(port, create_decoder("topdown_heatmap", **DECODER)),
        config=config, dataset_config=SETTING, device="cpu")
    want = inferencer(val_batches)
    stats = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    port.train()
    assert inferencer(val_batches) == want
    assert not port.training
    for k, v in port.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k
