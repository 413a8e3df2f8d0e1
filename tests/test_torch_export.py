"""The port's serving export (``engine/export.py``, ``tools/export.py``) on the CPU.

An EvalNet is exported with a symbolic batch (traced at batch 2), the bytes
are loaded with ``load_serving_fn`` alone, and the artifact is called at
batches 1 and 3, which it was not traced at:

- against the port's own forward and decode on the same weights: bit for
  bit (the same PyTorch operations on the CPU);
- against the JAX package's ``EvalNet.apply`` on the converted weights, for
  the top-down heatmap decoder (plain, quarter-pixel shift, UDP, DARK-UDP),
  SimCC and regression, within the tolerances of the tests that hold each
  net to JAX (tests/test_torch_predictor.py: 1e-3 px where a joint's peak
  leads its runner-up by more than 1e-4, scores within 1e-4;
  tests/test_torch_simcc.py's and tests/test_torch_rle.py's
  ``check_preds``).

The heatmap decode is one ``mindpose::decode_heatmap`` node of the program
(``mindpose::argmax_shift_decode`` under DARK), which is what launches the
kernel on the card (chip_smoke.py phase 31 counts those launches). Then the
tool: ``--selftest`` on the eval fixture's config (float32 and bf16, a
pinned batch), and its refusals (bottom-up, ``--platforms``, no
``--ckpt``).
"""
import io
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from mindpose_tpu.models.decoders.regression_decoder import (
    RegressionDecoder as JaxRegressionDecoder,
)
from mindpose_tpu.models.decoders.simcc_decoder import SimCCDecoder as JaxSimCCDecoder
from mindpose_tpu.models.decoders.top_down_decoder import TopDownHeatMapDecoder as JaxDecoder
from mindpose_tpu.models.heads.rle_head import RLERegressionHead as JaxRLEHead
from mindpose_tpu.models.heads.simcc_head import SimCCHead as JaxSimCCHead
from mindpose_tpu.models.networks import EvalNet as JaxEvalNet
from mindpose_tpu_torch.engine import export_eval_net, load_serving_fn
from mindpose_tpu_torch.engine.export import ServingModule
from mindpose_tpu_torch.models import create_decoder
from mindpose_tpu_torch.models.heads import RLERegressionHead, SimCCHead
from mindpose_tpu_torch.models.networks import EvalNet
from mindpose_tpu_torch.ops.cuda.decode import argmax_shift_decode_plain
from mindpose_tpu_torch.ops.heatmap import gaussian_kernel_2d
from mindpose_tpu_torch.tools import export as export_tool
from tests.fixtures.eval_checks import BOTTOMUP_RECORD, CKPT, RECORD, register_port_backbone
from tests.test_torch_hrnet import build_pair as hrnet_pair
from tests.test_torch_predictor import _top2_gap
from tests.test_torch_rle import check_preds as rle_check_preds
from tests.test_torch_simcc import (
    FEATURE_SIZE,
    IMAGE_SIZE,
    RTOL_OF_MAX,
    check_preds,
    clear_joints,
    crops,
    reduced_pair,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

HEATMAP_SETTINGS = [{}, {"shift_coordinate": True}, {"use_udp": True},
                    {"use_udp": True, "dark_udp_refine": True}]
BATCHES = (1, 3)


def _inputs(rng, n, hw):
    x = rng.standard_normal((n, hw[0], hw[1], 3)).astype(np.float32)
    return (x,) + crops(rng, n)


def _torch(inputs):
    x, *rest = inputs
    return [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()] + [
        torch.from_numpy(a) for a in rest]


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _served_and_direct(eval_net, hw, inputs):
    """(the loaded artifact's outputs, the port's direct outputs, the program's bytes)."""
    blob = export_eval_net(eval_net, hw)
    serve = load_serving_fn(blob)
    args = _torch(inputs)
    got = serve(*args)
    with torch.inference_mode():
        want = ServingModule(eval_net.net, eval_net.decoder, eval_net.output_raw)(*args)
    return got, want, blob


def _decode_ops(blob):
    program = torch.export.load(io.BytesIO(blob))
    return [str(n.target) for n in program.graph.nodes if "mindpose" in str(n.target)]


@pytest.fixture(scope="module")
def hrnet():
    return hrnet_pair()


@pytest.mark.parametrize("setting", HEATMAP_SETTINGS,
                         ids=["plain", "shift", "udp", "dark_udp"])
def test_heatmap_artifact_serves_unseen_batches_as_the_net_and_jax(hrnet, setting):
    jax_net, variables, port, _ = hrnet
    eval_net = EvalNet(port, create_decoder("topdown_heatmap", **setting), output_raw=True)
    jax_eval = jax.jit(JaxEvalNet(jax_net, JaxDecoder(**setting), output_raw=True).apply)
    rng = np.random.RandomState(7)
    for n in BATCHES:
        inputs = _inputs(rng, n, (64, 48))
        (got, got_heat), want_direct, blob = _served_and_direct(eval_net, (64, 48), inputs)
        for g, w in zip(_leaves((got, got_heat)), _leaves(want_direct)):
            assert g.shape[0] == n
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        (want, want_boxes), heat = jax_eval(variables, *inputs)
        heat = np.asarray(heat).transpose(0, 3, 1, 2)
        # the heatmaps at test_torch_hrnet.py's eval tolerance
        np.testing.assert_allclose(got_heat.numpy(), heat, atol=1e-4, rtol=0)
        preds = got[0].numpy()
        if setting.get("dark_udp_refine"):
            # the Newton step turns the heatmaps' float32 summation order into
            # up to 3e-3 px: JAX's decoder on the artifact's own heatmaps, each
            # joint within twice the refinement's float32 rounding bound, as
            # chip_smoke.py holds the card's DARK decode (5.5e-4 px measured)
            want, want_boxes = JaxDecoder(**setting)(got_heat.numpy().transpose(0, 2, 3, 1),
                                                     *inputs[1:])
            want = np.asarray(want)
            np.testing.assert_array_equal(preds[..., 2], want[..., 2])
            cells = torch.tensor([47.0, 63.0], dtype=torch.float64)
            bound = chip_smoke.dark_rounding_bound(
                got_heat, argmax_shift_decode_plain(got_heat, False)[0],
                torch.from_numpy(gaussian_kernel_2d(11)),
                torch.from_numpy(inputs[2]).double() * 200.0 / cells)
            bound = 2 * bound.numpy() + 8 * 2.0 ** -24 * np.abs(want[..., :2]).max(-1)
            err = np.abs(preds[..., :2] - want[..., :2]).max(-1)
            assert (err <= np.maximum(bound, 1e-4)).all(), float((err / bound).max())
        else:
            clear = _top2_gap(heat) > 1e-4
            assert clear.mean() > 0.9
            np.testing.assert_allclose(preds[..., :2][clear], np.asarray(want)[..., :2][clear],
                                       atol=1e-3, rtol=0)
            np.testing.assert_allclose(preds[..., 2], np.asarray(want)[..., 2], atol=1e-4,
                                       rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want_boxes), rtol=2e-7)
    op = "mindpose.argmax_shift_decode" if setting.get("dark_udp_refine") else \
        "mindpose.decode_heatmap"
    assert _decode_ops(blob) == [f"{op}.default"]


def test_simcc_artifact_serves_unseen_batches_as_the_net_and_jax():
    jax_net, variables, port = reduced_pair(
        JaxSimCCHead(input_size=IMAGE_SIZE),
        SimCCHead(input_size=IMAGE_SIZE, feature_size=FEATURE_SIZE))
    kw = dict(input_size=IMAGE_SIZE, split_ratio=2.0, sigma=6.0)
    eval_net = EvalNet(port, create_decoder("simcc", **kw), output_raw=True)
    jax_eval = jax.jit(JaxEvalNet(jax_net, JaxSimCCDecoder(**kw)).apply)
    rng = np.random.RandomState(8)
    for n in BATCHES:
        inputs = _inputs(rng, n, IMAGE_SIZE[::-1])
        got, want_direct, _ = _served_and_direct(eval_net, IMAGE_SIZE[::-1], inputs)
        for g, w in zip(_leaves(got), _leaves(want_direct)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        (want_preds, want_boxes), want_logits = jax_eval(variables, *inputs)
        (preds, boxes), _ = got
        np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=2e-7)
        tol = RTOL_OF_MAX * max(float(np.abs(w).max()) for w in want_logits)
        clear = clear_joints(want_logits, 4 * tol)
        check_preds(preds.numpy(), np.asarray(want_preds), clear, tol)


def test_regression_artifact_serves_unseen_batches_as_the_net_and_jax():
    jax_net, variables, port = reduced_pair(JaxRLEHead(), RLERegressionHead())
    eval_net = EvalNet(port, create_decoder("regression", input_size=IMAGE_SIZE), output_raw=True)
    jax_eval = jax.jit(JaxEvalNet(jax_net, JaxRegressionDecoder(input_size=IMAGE_SIZE)).apply)
    rng = np.random.RandomState(9)
    for n in BATCHES:
        inputs = _inputs(rng, n, IMAGE_SIZE[::-1])
        got, want_direct, _ = _served_and_direct(eval_net, IMAGE_SIZE[::-1], inputs)
        for g, w in zip(_leaves(got), _leaves(want_direct)):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
        (want_preds, want_boxes), want_out = jax_eval(variables, *inputs)
        (preds, boxes), _ = got
        np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes), rtol=2e-7)
        rle_check_preds(preds.numpy(), np.asarray(want_preds), want_out)


def test_pinned_batch_and_decoder_outputs_alone(hrnet):
    port = hrnet[2]
    eval_net = EvalNet(port, create_decoder("topdown_heatmap"), output_raw=False)
    serve = load_serving_fn(export_eval_net(eval_net, (64, 48), batch=3))
    inputs = _torch(_inputs(np.random.RandomState(10), 3, (64, 48)))
    preds, boxes = serve(*inputs)
    assert preds.shape == (3, 17, 3) and boxes.shape == (3, 6)
    with pytest.raises(Exception):
        serve(*_torch(_inputs(np.random.RandomState(10), 2, (64, 48))))


# ------------------------------------------------------------------ the tool


def _fixture_config(tmp_path, record=RECORD, **overrides):
    path = str(tmp_path / "fixture.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(record["config"], **overrides), f)
    return path


@pytest.mark.parametrize("amp_level,batch", [("O0", "b"), ("O2", "3")])
def test_tool_selftest_on_the_fixture(tmp_path, caplog, amp_level, batch):
    register_port_backbone()
    out = str(tmp_path / "fixture.pt2")
    export_tool.main(["--config", _fixture_config(tmp_path, amp_level=amp_level), "--ckpt", CKPT,
                      "--out", out, "--batch", batch, "--selftest", "--device", "cpu"])
    assert os.path.getsize(out) > 0
    with open(out, "rb") as f:
        serve = load_serving_fn(f.read())
    n = 3 if batch == "3" else 5
    preds, boxes = serve(torch.zeros(n, 3, 128, 96), torch.full((n, 2), 50.0),
                         torch.ones(n, 2), torch.ones(n))
    assert preds.shape == (n, 17, 3) and torch.isfinite(preds).all()


def test_tool_refusals(tmp_path):
    register_port_backbone()
    config = _fixture_config(tmp_path)
    with pytest.raises(SystemExit, match="platforms"):
        export_tool.main(["--config", config, "--ckpt", CKPT, "--platforms", "tpu,cpu",
                          "--device", "cpu"])
    with pytest.raises(SystemExit, match="--ckpt"):
        export_tool.main(["--config", config, "--device", "cpu"])
    bottom_up = _fixture_config(tmp_path, BOTTOMUP_RECORD)
    with pytest.raises(SystemExit, match="top-down"):
        export_tool.main(["--config", bottom_up, "--ckpt", CKPT, "--device", "cpu"])


def test_tool_exports_on_the_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    register_port_backbone()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = export_tool.parse_export_args(["--config", _fixture_config(tmp_path), "--ckpt", CKPT])
    assert args.device is None and args.batch == "b" and not args.selftest
    with pytest.raises(RuntimeError, match="--device cpu"):
        export_tool.build_eval_net(args, raw_output=False)
