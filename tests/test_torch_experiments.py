"""The port's experiment tools against the JAX package's, on the CPU.

``mindpose_tpu_torch/tools/ablate_accuracy.py``, ``exp_grouping.py`` and
``exp_warmstart.py`` against ``tools/ablate_accuracy.py``,
``tools/exp_grouping.py`` and ``tools/exp_warmstart.py`` (loaded from
their files, as tests/utils/test_ablate_resume.py loads them; their main
guards keep them from running):

- the constants (``ARMS``, ``DATASET_SETTING``, ``EVAL_SETTING``, and
  exp_grouping's ``SETTING`` / ``EVAL_SETTING``) equal JAX's;
- ``make_det_json`` writes JAX's bytes; ``load_completed_runs`` and
  ``summarize`` give JAX's results on test_ablate_resume.py's cases;
- ``eval_checkpoint`` on the top-down fixture (tests/fixtures/
  tiny_hrnet_topdown.msgpack, at its 96x128 crops) gives JAX's AP within
  1e-6 with the plain and the DARK-UDP decoders, and ``eval_grouping`` on the bottom-up fixture
  (tiny_higher_hrnet_bottomup.msgpack, at its 128x128 size) with the matcher
  and with the host Hungarian, all in float32 (O0; JAX's net float32);
- each experiment's ``main`` runs on the CPU with the fixtures' reduced
  HRNet (one seed, one epoch of one step) and writes a report with JAX's
  keys; exp_warmstart's conversion runs ``tools/convert_ckpt.main`` in this
  process (the reduced arch is registered here only, so a process of its
  own would not know it);
- ``models/convert_source.export_backbone_state`` gives JAX's
  ``export_backbone_state`` key for key (in its order) and bit for bit,
  with torch and MindSpore names, on a narrow HRNet, ResNet-50 and a
  2-block ViT-B; and export -> ``write_ms_checkpoint`` -> the port's
  ``convert_ckpt`` -> a loaded backbone gives back the state bit for bit.
"""
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.models.backbones import convert as jax_convert
from mindpose_tpu.utils.checkpoint import load_variables
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.models import create_network, create_network_from_config
from mindpose_tpu_torch.models.convert import export_variables, num_heads
from mindpose_tpu_torch.models.convert_source import export_backbone_state, normalize_source_keys
from mindpose_tpu_torch.tools import ablate_accuracy, convert_ckpt, exp_grouping, exp_warmstart
from mindpose_tpu_torch.tools.make_synthetic_coco import generate_split
from mindpose_tpu_torch.utils.checkpoint import load_net_state_dict
from mindpose_tpu_torch.utils.ms_ckpt import write_ms_checkpoint
from tests import make_torch_eval_fixture as td_fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import (
    BOTTOMUP_CKPT,
    BOTTOMUP_RECORD,
    CKPT,
    RECORD,
    register_port_backbone,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_convert_ckpt import ARCHS, _empty, _fill_, archs  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AP_ATOL = 1e-6
FIXTURE_BACKBONE = RECORD["config"]["backbone_name"]


def _load_tool(name):
    """A JAX tool from its file (its main guard keeps it from running)."""
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.pop(0)
        sys.path.pop(0)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {name: _load_tool(name) for name in ("ablate_accuracy", "exp_grouping",
                                                 "exp_warmstart")}


@pytest.fixture
def grouping_setting(monkeypatch):
    """exp_grouping's SETTING restored after the test (``apply_image_size`` and
    ``main`` change it in place)."""
    monkeypatch.setattr(exp_grouping, "SETTING", json.loads(json.dumps(exp_grouping.SETTING)))


# ---- constants ----

def test_constants_equal_jax_s(jax_tools):
    jax_acc, jax_grp = jax_tools["ablate_accuracy"], jax_tools["exp_grouping"]
    assert ablate_accuracy.ARMS == jax_acc.ARMS
    assert ablate_accuracy.DATASET_SETTING == jax_acc.DATASET_SETTING
    assert ablate_accuracy.EVAL_SETTING == jax_acc.EVAL_SETTING
    assert exp_grouping.SETTING == jax_grp.SETTING
    assert exp_grouping.EVAL_SETTING == jax_grp.EVAL_SETTING
    assert (exp_grouping.K, exp_grouping.M) == (jax_grp.K, jax_grp.M)
    # the warm-start tool trains and evaluates through the accuracy tool's functions
    assert exp_warmstart.train_arm is ablate_accuracy.train_arm


@pytest.mark.parametrize("size", [128, 512])
def test_apply_image_size_equals_jax_s(jax_tools, grouping_setting, size):
    jax_grp = jax_tools["exp_grouping"]
    kept = json.loads(json.dumps(jax_grp.SETTING))
    try:
        jax_grp.apply_image_size(size)
        exp_grouping.apply_image_size(size)
        assert exp_grouping.SETTING == jax_grp.SETTING
    finally:
        jax_grp.SETTING.clear()
        jax_grp.SETTING.update(kept)


# ---- helpers ----

@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("det"))
    generate_split(root, 24, seed=3, people_per_img=3)
    return os.path.join(root, "annotations.json")


@pytest.mark.parametrize("seed", [0, 7])
def test_make_det_json_writes_jax_s_bytes(jax_tools, annotations, tmp_path, seed):
    want = jax_tools["ablate_accuracy"].make_det_json(annotations, str(tmp_path / "jax.json"),
                                                      seed=seed)
    got = ablate_accuracy.make_det_json(annotations, str(tmp_path / "port.json"), seed=seed)
    with open(want, "rb") as a, open(got, "rb") as b:
        want_bytes, got_bytes = a.read(), b.read()
    assert got_bytes == want_bytes
    assert len(json.loads(got_bytes)) > 0


def _rec(arm, seed, label, ap):
    return {"label": label, "arm": arm, "seed": seed, "AP": ap, "AP50": -1, "AR": -1}


RESUME_CASES = {
    # test_ablate_resume.py's: a stale partial, the retrain's complete records,
    # a complete plain pair and an incomplete udp pair
    "dedup": [_rec("udp", 0, "udp", 0.50), _rec("udp", 0, "udp", 0.80),
              _rec("udp", 0, "udp+dark", 0.82), _rec("plain", 1, "plain", 0.70),
              _rec("udp", 2, "udp", 0.60)],
    "truncated tail": [_rec("plain", 0, "plain", 0.9)],
}


@pytest.mark.parametrize("module", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_load_completed_runs_and_summarize_give_jax_s_results(jax_tools, tmp_path, module,
                                                               case):
    jax_acc = jax_tools["ablate_accuracy"]
    tool = jax_acc if module == "jax" else ablate_accuracy
    path = tmp_path / "r.jsonl"
    text = "\n".join(json.dumps(r) for r in RESUME_CASES[case]) + "\n"
    if case == "truncated tail":
        text += '{"label": "plain", "arm": "pl'
    path.write_text(text)
    runs, done = tool.load_completed_runs(str(path))
    want_runs, want_done = jax_acc.load_completed_runs(str(path))
    assert (runs, done) == (want_runs, want_done)
    if case == "dedup":  # test_ablate_resume.py's assertions
        assert done == {("udp", 0), ("plain", 1)}
        assert sorted(r["AP"] for r in runs if r["arm"] == "udp") == [0.80, 0.82]
    else:
        assert done == {("plain", 0)} and len(runs) == 1
    assert tool.summarize(runs) == jax_acc.summarize(runs)


def test_summarize_pairs_deltas_as_jax_does(jax_tools):
    rng = np.random.RandomState(0)
    runs = [_rec(arm, seed, label, float(rng.rand()))
            for seed in range(3) for arm, label in
            (("plain", "plain"), ("udp", "udp"), ("udp", "udp+dark"), ("rle", "rle"))]
    runs.pop()  # rle lacks seed 2: its deltas pair over the seeds it has
    want = jax_tools["ablate_accuracy"].summarize(runs)
    assert ablate_accuracy.summarize(runs) == want
    assert want["udp"]["paired_delta_vs_plain"]["per_seed"]


# ---- evaluation ----

@pytest.fixture(scope="module")
def topdown_pair(tmp_path_factory):
    """The top-down fixture as a JAX float32 net with its variables, and as a port net."""
    td_fixture.register_jax_backbone()
    register_port_backbone()
    jax_net = jax_create_network(FIXTURE_BACKBONE, "hrnet_head", dtype=jnp.float32)
    init = jax.jit(lambda k, x: jax_net.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 96, 3), jnp.float32))
    variables = load_variables(CKPT, init)
    port = create_network(FIXTURE_BACKBONE, "hrnet_head")
    port.load_state_dict(load_net_state_dict(CKPT, port), strict=True)
    root = str(tmp_path_factory.mktemp("topdown_val"))
    data = {"val": tiny_coco.write_val(root)}
    return jax_net, variables, port, data


@pytest.mark.parametrize("label", ["plain", "udp+dark"])
def test_eval_checkpoint_gives_jax_s_ap(jax_tools, topdown_pair, monkeypatch, label):
    """At the fixture's own crop size (96x128, heatmaps 24x32) on both sides."""
    jax_net, variables, port, data = topdown_pair
    setting = RECORD["config"]["dataset_setting"]
    monkeypatch.setattr(ablate_accuracy, "DATASET_SETTING", setting)
    monkeypatch.setattr(jax_tools["ablate_accuracy"], "DATASET_SETTING", setting)
    _, name, kwargs = next(e for arm in ablate_accuracy.ARMS.values() for e in arm["evals"]
                           if e[0] == label)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    want = jax_tools["ablate_accuracy"].eval_checkpoint(jax_net, state, data, kwargs,
                                                       decoder_name=name)
    got = ablate_accuracy.eval_checkpoint(port, data, kwargs, decoder_name=name, device="cpu",
                                          amp_level="O0")
    assert want["AP"] > 0.5
    assert abs(got["AP"] - want["AP"]) <= AP_ATOL, (got["AP"], want["AP"])


@pytest.fixture(scope="module")
def bottomup_pair(tmp_path_factory):
    cfg = BOTTOMUP_RECORD["config"]
    td_fixture.register_jax_backbone()
    register_port_backbone()
    jax_net = jax_create_network(cfg["backbone_name"], cfg["head_name"],
                                 head_args=cfg["head_setting"], dtype=jnp.float32)
    init = jax.jit(lambda k, x: jax_net.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3), jnp.float32))
    variables = load_variables(BOTTOMUP_CKPT, init)
    port = create_network_from_config(Config(**cfg))
    port.load_state_dict(load_net_state_dict(BOTTOMUP_CKPT, port), strict=True)
    root = str(tmp_path_factory.mktemp("bottomup_val"))
    data = {"val": tiny_coco.write_val(root)}
    return jax_net, variables, port, data


@pytest.mark.parametrize("device_grouping", [True, False], ids=["matcher", "hungarian"])
def test_eval_grouping_gives_jax_s_ap(jax_tools, bottomup_pair, grouping_setting,
                                      device_grouping):
    jax_net, variables, port, data = bottomup_pair
    jax_grp = jax_tools["exp_grouping"]
    size = BOTTOMUP_RECORD["config"]["dataset_setting"]["image_size"][0]  # the fixture's 128
    kept = json.loads(json.dumps(jax_grp.SETTING))
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    try:
        jax_grp.apply_image_size(size)
        want = jax_grp.eval_grouping(jax_net, state, data, device_grouping)
    finally:
        jax_grp.SETTING.clear()
        jax_grp.SETTING.update(kept)
    exp_grouping.apply_image_size(size)
    got = exp_grouping.eval_grouping(port, data, device_grouping, device="cpu", amp_level="O0")
    assert want["AP"] > 0.2
    assert abs(got["AP"] - want["AP"]) <= AP_ATOL, (got["AP"], want["AP"])


# ---- end to end ----

ACCURACY_PROTOCOL = {"train_images", "val_images", "people_per_img", "epochs", "batch_size",
                     "backbone", "tta", "det_noise", "paired"}
GROUPING_PROTOCOL = {"train_images", "val_images", "people_per_img", "epochs",
                     "steps_per_epoch", "batch_size", "model", "hflip_tta", "multiscale_tta",
                     "refine_missing_joint"}
WARMSTART_ARGS = {"arch", "head", "epochs", "pretrain_epochs", "batch_size", "seeds",
                  "eval_every", "train_images", "val_images", "data_root", "out"}


def counted_steps(module, monkeypatch) -> list:
    """Each train step that ``module``'s ``build_train_step`` builds appends its loss."""
    losses = []
    build = module.build_train_step

    def counting(*args, **kwargs):
        step = build(*args, **kwargs)

        def counted(*batch):
            loss = step(*batch)
            losses.append(loss)
            return loss

        return counted

    monkeypatch.setattr(module, "build_train_step", counting)
    return losses


def test_ablate_accuracy_main_writes_jax_s_report(tmp_path, monkeypatch):
    register_port_backbone()
    losses = counted_steps(ablate_accuracy, monkeypatch)
    out = tmp_path / "acc.json"
    report = ablate_accuracy.main([
        "--device", "cpu", "--arms", "udp", "--seeds", "0", "--epochs", "1",
        "--batch-size", "2", "--train-images", "1", "--val-images", "2", "--people", "2",
        "--backbone", FIXTURE_BACKBONE, "--data-root", str(tmp_path / "data"),
        "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == report
    assert set(report) == {"protocol", "runs", "summary"}
    assert set(report["protocol"]) == ACCURACY_PROTOCOL
    assert [r["label"] for r in report["runs"]] == ["udp", "udp+dark"]
    for r in report["runs"]:
        assert set(r) == {"label", "arm", "seed", "AP", "AP50", "AR"}
        assert 0.0 <= r["AP"] <= 1.0
    assert set(report["summary"]) == {"udp", "udp+dark"}
    assert len(losses) == 1 and torch.isfinite(losses[0]).all()  # one epoch of one step
    # the runs file resumes: a second run trains nothing and reports the same runs
    again = ablate_accuracy.main([
        "--device", "cpu", "--arms", "udp", "--seeds", "0", "--epochs", "1",
        "--batch-size", "2", "--backbone", FIXTURE_BACKBONE,
        "--train-images", "1", "--val-images", "2", "--people", "2",
        "--data-root", str(tmp_path / "data"), "--out", str(out)])
    assert again["runs"] == report["runs"] and len(losses) == 1


def test_exp_grouping_main_writes_jax_s_report(tmp_path, grouping_setting, monkeypatch):
    register_port_backbone()
    monkeypatch.setattr(exp_grouping, "BACKBONE", FIXTURE_BACKBONE)
    losses = counted_steps(exp_grouping, monkeypatch)
    out = tmp_path / "grouping.json"
    report = exp_grouping.main([
        "--device", "cpu", "--seeds", "0", "--epochs", "1", "--steps-per-epoch", "1",
        "--batch-size", "2", "--train-images", "2", "--val-images", "2", "--people", "2",
        "--image-size", "64", "--data-root", str(tmp_path / "data"), "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == report
    assert set(report) == {"protocol", "runs", "max_abs_delta"}
    assert set(report["protocol"]) == GROUPING_PROTOCOL
    (run,) = report["runs"]
    assert set(run) == {"seed", "AP_host", "AP_device", "delta"}
    assert report["max_abs_delta"] == abs(run["delta"])
    assert exp_grouping.SETTING["image_size"] == [64, 64]
    assert len(losses) == 1 and torch.isfinite(losses[0]).all()


def test_exp_warmstart_main_writes_jax_s_report(tmp_path, monkeypatch):
    register_port_backbone()
    calls = []

    def convert_in_process(cmd, **kwargs):
        calls.append(cmd)
        i = cmd.index("mindpose_tpu_torch.tools.convert_ckpt")
        convert_ckpt.main(cmd[i + 1:])
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(exp_warmstart.subprocess, "run", convert_in_process)
    losses = counted_steps(ablate_accuracy, monkeypatch)
    out = tmp_path / "warmstart.json"
    report = exp_warmstart.main([
        "--device", "cpu", "--arch", FIXTURE_BACKBONE, "--epochs", "1", "--pretrain-epochs",
        "1", "--batch-size", "2", "--seeds", "0", "--eval-every", "1", "--train-images", "1",
        "--val-images", "2", "--data-root", str(tmp_path / "data"), "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) == {"protocol", "runs", "summary"}
    assert set(report["protocol"]) == WARMSTART_ARGS | {"device"}
    assert [(r["init"], r["seed"]) for r in report["runs"]] == [("scratch", 0), ("converted", 0)]
    for r in report["runs"]:
        assert set(r) == {"init", "seed", "trajectory", "final_AP"} and 1 in r["trajectory"]
    assert "paired_delta_converted_minus_scratch" in report["summary"]
    assert len(losses) == 3  # domain A, then scratch and converted: one step each
    (cmd,) = calls
    assert cmd[1:3] == ["-m", "mindpose_tpu_torch.tools.convert_ckpt"] and "--check" in cmd
    # the converted file holds the exported backbone, bit for bit
    exported = convert_ckpt.load_source(str(tmp_path / "data" / f"{FIXTURE_BACKBONE}_domain_a.ckpt"))
    converted = torch.load(str(tmp_path / "data" / f"{FIXTURE_BACKBONE}_domain_a.pth"))
    renamed = normalize_source_keys(exported)
    assert set(converted) == set(renamed)
    for name, value in converted.items():
        assert np.array_equal(value.numpy(), renamed[name]), name


# ---- export_backbone_state ----

def _backbone(name, seed):
    return _fill_(_empty(ARCHS[name][2]), seed)


def _jax_export(name, backbone, naming):
    jax_arch = ARCHS[name][0]
    flax = export_variables(backbone.state_dict(), ARCHS[name][3](backbone),
                            num_heads(backbone))
    return jax_convert.export_backbone_state(jax_arch, flax, naming=naming)


@pytest.mark.parametrize("naming", ["torch", "mindspore"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_export_backbone_state_equals_jax_s(name, naming):
    backbone = _backbone(name, seed=5)
    want = _jax_export(name, backbone, naming)
    got = export_backbone_state(ARCHS[name][1], backbone.state_dict(), naming=naming)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        assert np.array_equal(got[key], np.asarray(value)), key


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_export_write_convert_load_gives_the_state_back(name, tmp_path):
    backbone = _backbone(name, seed=6)
    state = {k: v for k, v in backbone.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    ckpt = str(tmp_path / "exported.ckpt")
    write_ms_checkpoint(ckpt, export_backbone_state(ARCHS[name][1], state, naming="mindspore"))
    out = str(tmp_path / "converted.pth")
    convert_ckpt.main(["--src", ckpt, "--arch", ARCHS[name][1], "--out", out, "--check"])
    converted = torch.load(out)
    assert set(converted) == set(state)
    loaded = _fill_(_empty(ARCHS[name][2]), seed=7)
    loaded.load_state_dict(converted, strict=False)
    for key, value in state.items():
        assert torch.equal(loaded.state_dict()[key], value), key
