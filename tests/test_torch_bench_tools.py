"""The port's bench tools against the JAX package's, on the CPU.

The JAX bench tools set up a compilation cache or the TPU's platform when
imported, so the test never imports them whole: ``tests/fixtures/
jax_tools.jax_defs`` builds their functions and tables from the source.
``bench_e2e``'s synthetic set is byte for byte JAX's, and its bytes per
batch (all five modes) and loader-only counts are JAX's exactly at one
worker. ``bench_decode``'s decoder outputs equal JAX's within
tests/test_torch_decode.py's tolerance. ``bench_serve``'s presets,
dataset setting and drawn boxes equal JAX's, and its predictions on
tests/test_torch_hrnet.py's reduced net equal the JAX composition within
tests/test_torch_predictor.py's tolerance. ``budget_table``'s FLOPs for
each conv part are 3x the forward convolutions' from the shapes, and its
bytes for a lone 1x1 conv are x + w + b + y. The variant tables are JAX's,
and the variants measured to diverge time nets in their BatchNorm modes.
Each tool's ``main`` runs at a
tiny size with ``--device cpu`` and reports JAX's keys but the ones the
port drops (listed here), and raises without a card unless given
``--device``. The train steps against JAX's: tests/test_torch_bench_steps.py.
"""
import ast
import filecmp
import functools
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

from mindpose_tpu_torch.models import create_network
from mindpose_tpu_torch.models.common import BatchNorm2d
from mindpose_tpu_torch.tools import (
    bench,
    bench_bu_variant,
    bench_e2e,
    bench_serve,
    bench_variant,
    budget_table,
)
from tests.fixtures.eval_checks import RECORD, register_port_backbone
from tests.fixtures.jax_tools import REPO, Proxy, jax_defs
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)
from tests.test_torch_hrnet import build_pair
from tests.test_torch_predictor import _jax_composition, _top2_gap

CPU = torch.device("cpu")
BENCH_PY = os.path.join(REPO, "bench.py")


# ---- the variant tables and the refused variants ----

def _jax_variant_table():
    """bench_variant.py's ``cfgs``, from its ``__main__`` block."""
    with open(os.path.join(REPO, "tools", "bench_variant.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.If))
    node = next(n for n in main.body if isinstance(n, ast.Assign) and n.targets[0].id == "cfgs")
    return ast.literal_eval(node.value)


def test_variant_tables_are_jax_s():
    assert bench_variant.VARIANTS == _jax_variant_table()
    assert bench_bu_variant.VARIANTS == jax_defs("bench_bu_variant")["VARIANTS"]


@pytest.mark.parametrize("tool, variant", [
    (bench_variant, "bn4"), (bench_variant, "bn8"), (bench_variant, "s2d_bn4"),
    (bench_variant, "bnfrozen"), (bench_bu_variant, "bnfrozen")])
def test_refused_variants_raise(tool, variant, monkeypatch):
    """The variants measured to diverge, refused until the port took the JAX
    package's BatchNorm modes: each now times its net at batch 1 (the
    fixture's reduced HRNet), every BatchNorm of the backbone in the
    variant's mode (s2d_bn4: bn4's, JAX's s2d stem taking the plain stem's
    statistics)."""
    built = []

    def create(*args, **kwargs):
        built.append(tiny_create_network(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(bench_variant, "create_network", create)
    monkeypatch.setattr(bench, "create_network", create)
    rows = tool.main(["--device", "cpu", "--variants", variant, "--batch", "1", "--iters", "1"])
    settings = (bench_variant.VARIANTS[variant] if tool is bench_variant
                else bench_bu_variant.VARIANTS[variant][0])
    want = (settings.get("bn_stats_frac", 1.0), settings.get("bn_grad_stats", "exact"))
    assert {(m.stats_frac, m.grad_stats) for m in built[0].backbone.modules()
            if isinstance(m, BatchNorm2d)} == {want}
    (row,) = rows
    assert row["variant"] == variant
    assert row.get("ms", row.get("higher_hrnet_step_time_ms")) > 0


# ---- bench_decode ----

class RecordingJax(Proxy):
    """``jax`` whose ``jit`` keeps what the jitted function returned."""

    def __init__(self):
        super().__init__(jax, outputs=[])

    def jit(self, fn, **kwargs):
        jitted = jax.jit(fn, **kwargs)

        def call(*args):
            out = jitted(*args)
            self.outputs.append(out)
            return out

        return call


def test_decode_outputs_match_jax(monkeypatch):
    recording = RecordingJax()
    ns = jax_defs("bench", path=BENCH_PY, jax=recording)
    want = ns["bench_decode"](batch=4, iters=1)
    outputs = []

    def recording_decoder(name, **kwargs):
        decoder = bench_create_decoder(name, **kwargs)

        def call(*args):
            outputs.append(decoder(*args))
            return outputs[-1]

        return call

    bench_create_decoder = bench.create_decoder
    monkeypatch.setattr(bench, "create_decoder", recording_decoder)
    got = bench.bench_decode(batch=4, iters=1, device=CPU)
    (want_p, want_b), (got_p, got_b) = recording.outputs[0], outputs[0]
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-4)
    assert len(outputs) == len(recording.outputs) == 1 + 1 + 5 * 100
    assert set(got) == set(want) | {"decode_kernel_launches"}
    assert got["decode_kernel_launches"] == 0  # the plain version on the CPU


# ---- bench_e2e ----

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The JAX tool's synthetic set (3 frames, 24 records) and the port's."""
    ns = jax_defs("bench_e2e", assigns=("DATASET_SETTING",), json=json, logging=logging)
    want = ns["make_synth_coco"](str(tmp_path_factory.mktemp("jax")), 3)
    got = bench_e2e.make_synth_coco(str(tmp_path_factory.mktemp("port")), 3)
    return ns, want, got


def test_synthetic_set_is_byte_for_byte(synth):
    _, (want_root, want_ann), (got_root, got_ann) = synth
    assert filecmp.cmp(want_ann, got_ann, shallow=False)
    names = sorted(os.listdir(want_root))
    assert names == sorted(os.listdir(got_root)) and len(names) == 3
    match, mismatch, errors = filecmp.cmpfiles(want_root, got_root, names, shallow=False)
    assert match == names, (mismatch, errors)


def test_e2e_settings_are_jax_s(synth):
    ns = synth[0]
    for name in ("MODES", "TRAIN_TRANSFORMS", "DATASET_SETTING", "MEAN", "STD"):
        assert getattr(bench_e2e, name) == ns[name], name


@pytest.mark.parametrize("mode", list(bench_e2e.MODES) + list(bench_e2e.BYTES_MODES))
def test_bytes_per_batch_match_jax(synth, mode):
    ns, (root, ann), _ = synth
    np.random.seed(0)  # the augmentations draw from numpy's global stream, in both loaders
    want = ns["measure_bytes"](mode, root, ann, batch_size=8, num_workers=1)
    np.random.seed(0)
    got = bench_e2e.measure_bytes(mode, root, ann, batch_size=8, num_workers=1)
    assert got == {**want, "columns": list(want["columns"])}


@pytest.mark.parametrize("mode", bench_e2e.MODES)
def test_loader_only_counts_match_jax(synth, mode):
    ns, (root, ann), _ = synth
    kwargs = dict(batch_size=8, epochs=2, num_workers=1, decode_cache_mb=64)
    np.random.seed(0)
    want = ns["measure_loader_only"](mode, root, ann, **kwargs)
    np.random.seed(0)
    got = bench_e2e.measure_loader_only(mode, root, ann, **kwargs)
    keys = ("mode", "records_per_epoch", "cache_hits", "cache_misses", "num_workers",
            "decode_cache_mb")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert set(got) == set(want) and got["cache_hits"] > 0


# ---- bench_serve ----

def test_serve_presets_and_setting_are_jax_s():
    ns = jax_defs("bench_serve", assigns=("DATASET_SETTING", "PRESETS"))
    assert bench_serve.PRESETS == ns["PRESETS"]
    assert bench_serve.DATASET_SETTING == ns["DATASET_SETTING"]


class RecordingPredictor:
    """Keeps each request's boxes; answers zeros."""

    def __init__(self, requests):
        self.requests = requests

    def __call__(self, image, boxes):
        self.requests.append(np.array(boxes))
        return np.zeros((len(boxes), 17, 3), np.float32)


def test_serve_boxes_are_drawn_as_jax_draws_them(monkeypatch):
    ns = jax_defs("bench_serve", assigns=("DATASET_SETTING", "PRESETS"))
    want, got = [], []
    ns["build_predictor"] = lambda preset, batch_size, quantize="": RecordingPredictor(want)
    monkeypatch.setattr(bench_serve, "build_predictor",
                        lambda preset, batch_size, quantize="", device=None:
                        RecordingPredictor(got))
    for draws, bench_model in ((want, ns["bench_model"]), (got, bench_serve.bench_model)):
        rng = np.random.RandomState(0)
        image = rng.randint(0, 255, (480, 640, 3), np.uint8)  # main's draw, first
        for name in ("resnet50", "hrnet_w32"):
            kwargs = {"device": CPU} if bench_model is bench_serve.bench_model else {}
            bench_model(name, [1, 8, 32], 2, image, rng, **kwargs)
    assert len(got) == len(want) == 2 * 3 * 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_serve_predictions_match_the_jax_composition(monkeypatch):
    jax_net_, variables, port, _ = build_pair()
    monkeypatch.setattr(bench_serve, "create_network", lambda **kwargs: port)
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (480, 640, 3), np.uint8)
    boxes = bench_serve.draw_boxes(rng, 8, 480, 640)
    predictor = bench_serve.build_predictor(bench_serve.PRESETS["hrnet_w32"], 4, device=CPU)
    got = predictor(image, boxes)
    want, heat = _jax_composition(jax_net_, variables, image, boxes, {"shift_coordinate": True})
    clear = _top2_gap(heat) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got[..., :2][clear], want[..., :2][clear], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 2], want[..., 2], atol=1e-4, rtol=0)


# ---- budget_table ----

@pytest.fixture
def tiny_budget(monkeypatch):
    register_port_backbone()
    for name, value in (("BACKBONE", RECORD["config"]["backbone_name"]), ("WIDTH", 4),
                        ("IMAGE", (32, 24)), ("HEATMAP", (8, 6)), ("AMP_LEVEL", "O0")):
        monkeypatch.setattr(budget_table, name, value)


def _forward_conv_flops(module, x):
    """2 x the multiply-adds of every conv of one forward, from the shapes."""
    flops = []

    def hook(conv, inputs, out):
        n, cout, h, w = out.shape
        kh, kw = conv.kernel_size
        flops.append(2 * n * cout * h * w * conv.in_channels // conv.groups * kh * kw)

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, nn.Conv2d)]
    with torch.no_grad():
        module.train()
        module(x)
    for h in handles:
        h.remove()
    return sum(flops)


@pytest.mark.parametrize("i", range(6), ids=["stem", "stage1", "stage2", "stage3", "stage4",
                                              "head"])
def test_budget_conv_part_flops_are_3x_the_forward_convs(tiny_budget, i):
    label, make, shape = budget_table.parts()[i]
    torch.manual_seed(0)
    module = make()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, *shape).astype(np.float32))
    x = x.permute(0, 3, 1, 2).contiguous()
    flops, bytes_ = budget_table.count(budget_table.fwd_bwd_program(module, CPU), (x,))
    assert flops == 3 * _forward_conv_flops(module, x) > 0
    assert bytes_ > x.nbytes


# XLA's cost analysis of the JAX tool's parts on the CPU over the port's
# FLOPs, batch 2, as budget_table's docstring states them
XLA_OVER_PORT = {"stem": 1.0224, "stage1": 1.0406, "stage2": 0.9865, "head": 0.6667}


@pytest.mark.parametrize("part", sorted(XLA_OVER_PORT))
def test_budget_flops_against_xla_s_figure(part):
    from flax import linen as flax_nn
    from mindpose_tpu.models.backbones.hrnet import HRModule as JaxHRModule
    from mindpose_tpu.models.backbones.resnet import Bottleneck as JaxBottleneck
    from mindpose_tpu.models.common import batch_norm as jax_batch_norm
    from mindpose_tpu.models.common import conv3x3 as jax_conv3x3

    classes = jax_defs("budget_table", body_of="main", nn=flax_nn, dt=jax.numpy.float32,
                       conv3x3=jax_conv3x3, batch_norm=jax_batch_norm,
                       Bottleneck=JaxBottleneck, HRModule=JaxHRModule, W=32)
    module = {"stem": lambda: classes["Stem"](), "stage1": lambda: classes["Stage1"](),
              "stage2": lambda: classes["StageN"](n_modules=1, n_branches=2, channels=(32, 64)),
              "head": lambda: classes["Head"]()}[part]()
    label, make, shape = next(p for p in budget_table.parts() if p[0].startswith(part))
    x = np.random.RandomState(0).rand(2, *shape).astype(np.float32)
    variables = module.init(jax.random.PRNGKey(0), x, train=False)
    stats = variables.get("batch_stats", {})

    def fwd(params, x):
        out = module.apply({"params": params, "batch_stats": stats}, x, train=True,
                           mutable=["batch_stats"])[0]
        return jax.numpy.sum(out.astype(jax.numpy.float32))

    cost = jax.jit(jax.grad(fwd, argnums=(0, 1))).lower(variables["params"], x).compile()
    cost = cost.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    flops, _ = budget_table.count(budget_table.fwd_bwd_program(make(), CPU), (xt,))
    assert round(float(cost["flops"]) / flops, 4) == XLA_OVER_PORT[part]


def test_budget_bytes_of_a_lone_1x1_conv():
    conv = nn.Conv2d(8, 5, 1)
    x = torch.rand(2, 8, 6, 4)
    with torch.no_grad():
        flops, bytes_ = budget_table.count(conv, (x,))
        y = conv(x)
    nbytes = [t.numel() * t.element_size() for t in (x, conv.weight, conv.bias, y)]
    assert bytes_ == sum(nbytes)
    assert flops == 2 * 2 * 5 * 6 * 4 * 8


def test_budget_counts_a_storage_once_and_a_freed_address_anew():
    """Two reads of one input count it once; an in-place update reads and
    writes its tensor once each; a new tensor at a freed address counts anew."""
    x = torch.rand(64)
    with budget_table.StorageBytes() as moved:
        y = x * 2 + x  # x read twice, once counted; x*2 written, read; y written
        y.add_(1.0)
    n = x.numel() * 4
    assert moved.total("read") == 3 * n  # x, x*2, y
    assert moved.total("write") == 2 * n  # x*2, y (written twice, counted once)


# ---- each main at a tiny size, its keys, and the device rule ----

# JAX's report keys the port leaves out (ROADMAP.md, "Code that the port drops")
DROPPED = {"regressions", "decode_pallas_p50_ms", "decode_pallas_amortized_ms",
           "decode_pallas_amortized_spread_ms"}
ADDED = {"decode_kernel_launches"}
JAX_BENCH_EXTRA = {
    "train_images_per_sec", "train_images_per_sec_per_chip", "step_time_ms", "batch_per_chip",
    "n_devices", "decode_p50_ms", "decode_amortized_ms", "decode_amortized_spread_ms",
    "decode_batch", "decode_pallas_p50_ms", "decode_pallas_amortized_ms",
    "decode_pallas_amortized_spread_ms", "higher_hrnet_train_images_per_sec_per_chip",
    "higher_hrnet_step_time_ms", "higher_hrnet_batch_per_chip", "e2e_images_per_sec",
    "e2e_mode", "e2e_records_per_epoch", "e2e_epoch_rates", "e2e_mb_per_batch",
    "e2e_wire_mb_per_s", "link_mb_per_s", "link_mb_per_s_pre_post", "e2e_link_utilization",
    "regressions"}
LINK_KEYS = {"e2e_mb_per_batch", "e2e_wire_mb_per_s", "link_mb_per_s", "link_mb_per_s_pre_post",
             "e2e_link_utilization"}
E2E_KEYS = {"mode", "decode_cache_mb", "device_prefetch", "patch_grouped", "e2e_images_per_sec",
            "epoch_rates", "batch_size", "records_per_epoch"} | LINK_KEYS
BUDGET_ROW_KEYS = {"part", "ms", "flops", "bytes", "ai_flop_per_byte", "bound", "bound_ms",
                   "achieved_tflops", "achieved_gbps", "pct_of_bound",
                   # added: the shape-derived least bytes and their roofline bound
                   "min_bytes", "min_bound_ms", "pct_of_min_bound"}


def tiny_create_network(backbone_name, head_name, **kwargs):
    """The fixture's reduced HRNet; a deconv head's 256-filter upsampling to
    8x the crop's feature map is a 1x1 conv here (``hrnet_head``)."""
    register_port_backbone()
    if head_name == "simple_baseline_head":
        head_name = "hrnet_head"
    return create_network(RECORD["config"]["backbone_name"], head_name, **kwargs)


def _shrunk(fn, **fixed):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        return fn(*args, **{**kwargs, **fixed})
    return call


def test_bench_main_prints_jax_s_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "create_network", tiny_create_network)
    monkeypatch.setattr(bench_e2e, "create_network", tiny_create_network)
    monkeypatch.setattr(bench, "bench_decode", _shrunk(bench.bench_decode, batch=4, iters=1))
    monkeypatch.setattr(bench, "bench_train_step",
                        _shrunk(bench.bench_train_step, batch_per_chip=2, iters=1))
    monkeypatch.setattr(bench, "bench_bottomup_step",
                        _shrunk(bench.bench_bottomup_step, batch_per_chip=1, iters=1))
    monkeypatch.setattr(bench, "bench_e2e_encode",
                        _shrunk(bench.bench_e2e_encode, num_images=2, epochs=2))
    monkeypatch.setattr(bench_e2e, "measure_e2e",
                        _shrunk(bench_e2e.measure_e2e, batch_size=8, num_workers=1))
    report = bench.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(report))
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "hrnet_w32_256x192_train_throughput" and line["value"] > 0
    assert line["vs_baseline"] == 1.0 and line["unit"] == "images/sec/chip"
    assert set(line["extra"]) == (JAX_BENCH_EXTRA - DROPPED) | ADDED, line["extra"]


def test_bench_main_keeps_the_headline_when_an_extra_fails(monkeypatch, capsys):
    def fails(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "bench_decode", _shrunk(bench.bench_decode, batch=4, iters=1))
    monkeypatch.setattr(bench, "bench_train_step",
                        _shrunk(bench.bench_train_step, batch_per_chip=2, iters=1))
    monkeypatch.setattr(bench, "create_network", tiny_create_network)
    monkeypatch.setattr(bench, "bench_e2e_encode", fails)
    monkeypatch.setattr(bench, "bench_bottomup_step", fails)
    extra = bench.main(["--device", "cpu"])["extra"]
    assert extra["e2e_error"].startswith("RuntimeError") and "higher_hrnet_error" in extra


def test_e2e_main_runs_each_kind_of_run(monkeypatch):
    monkeypatch.setattr(bench_e2e, "create_network", tiny_create_network)
    small = ["--device", "cpu", "--num-images", "2", "--batch-size", "8", "--num-workers", "1"]
    run = bench_e2e.main([*small, "--modes", "host,encode,full", "--epochs", "2"])
    assert [set(r) for r in run["results"]] == [E2E_KEYS] * 3
    assert set(run["e2e_summary"]) == {"host", "encode", "full"}
    assert all(r["e2e_images_per_sec"] > 0 and r["records_per_epoch"] == 16
               for r in run["results"])
    sized = bench_e2e.main([*small, "--bytes-only", "--modes",
                            "host,encode,full,full_nocrop,full_grouped"])
    assert [r["mode"] for r in sized["results"]] == [
        f"{m}+bytes_only" for m in ("host", "encode", "full", "full_nocrop", "full_grouped")]
    loaded = bench_e2e.main([*small, "--loader-only", "--epochs", "2"])
    assert [r["mode"] for r in loaded["results"]] == [f"{m}+loader_only" for m in bench_e2e.MODES]
    fed = bench_e2e.main([*small, "--modes", "encode", "--epochs", "2", "--device-prefetch", "2"])
    (r,) = fed["results"]  # no link calibration: the JAX tool's prefetch path has none
    assert set(r) == E2E_KEYS - LINK_KEYS and r["device_prefetch"] == 2


def test_serve_main_reports_jax_s_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(bench_serve, "create_network", lambda **kw: tiny_create_network(
        kw.pop("backbone_name"), kw.pop("head_name"), **kw))
    out = tmp_path / "serve.json"
    report = bench_serve.main(["--device", "cpu", "--batch-sizes", "1,2", "--iters", "2",
                               "--out", str(out)])
    assert set(report) == {"backend", "device_kind", "image_hw", "iters", "quantize", "note",
                           "models"}
    assert report["backend"] == "cpu" and "tunnel" not in report["note"]
    assert list(report["models"]) == ["resnet50", "hrnet_w32", "vit_b", "rle", "simcc"]
    for model in report["models"].values():
        assert list(model) == ["batch1", "batch2"]
        for r in model.values():
            assert set(r) == {"p50_ms", "p90_ms", "p99_ms", "boxes_per_sec"}
            assert 0 < r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"]
    assert json.loads(out.read_text()) == report


def test_variant_mains_print_their_rows(monkeypatch, capsys):
    monkeypatch.setattr(bench_variant, "create_network", tiny_create_network)
    monkeypatch.setattr(bench, "create_network", tiny_create_network)
    rows = bench_variant.main(["--device", "cpu", "--variants", "base,s2d,b0s2d_bnfused",
                               "--batch", "2", "--iters", "1"])
    bu = bench_bu_variant.main(["--device", "cpu", "--variants", "base,bnfused,remat",
                                "--batch", "1", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [r["variant"] for r in rows] == ["base", "s2d", "b0s2d_bnfused"]
    assert [r["variant"] for r in bu] == ["base", "bnfused", "remat"]
    assert all(r["ms"] > 0 for r in rows) and all(r["higher_hrnet_step_time_ms"] > 0 for r in bu)
    assert sum("img/s" in line for line in lines) == 6


def test_budget_main_reports_jax_s_keys(tiny_budget, tmp_path):
    out = tmp_path / "budget.json"
    report = budget_table.main(["--device", "cpu", "--batch", "2", "--iters", "1",
                                "--out", str(out)])
    assert set(report) == {"batch", "peak_flops", "peak_bw", "ridge_flop_per_byte", "gpu",
                           "rows"}
    assert report["gpu"] == "cpu" and report["peak_flops"] == 989e12
    assert [r["part"] for r in report["rows"]] == [
        "stem (256x192 -> /4)", "stage1 (4xbottleneck)", "stage2 (1 mod, 2 br)",
        "stage3 (4 mod, 3 br)", "stage4 (3 mod, 4 br)", "head (1x1 conv 32->17)",
        "loss (joint_mse)", "optimizer (adamw)", "FULL STEP (fwd+bwd+opt)"]
    for row in report["rows"]:
        assert set(row) == BUDGET_ROW_KEYS, row
        assert row["bytes"] > 0 and row["pct_of_bound"] >= 0  # rounded: CPU times are long
        # the eager program moves at least what its function needs
        assert 0 < row["min_bytes"] <= row["bytes"] and row["min_bound_ms"] <= row["bound_ms"]
    rows = {r["part"].split(" ")[0]: r for r in report["rows"]}
    # float32, each once: x, w, b read and their gradients written; the
    # heatmaps, targets and weights read and the heatmaps' gradient written
    assert rows["head"]["min_bytes"] == 2 * 4 * (2 * 4 * 8 * 6 + 17 * 4 + 17)
    assert rows["loss"]["min_bytes"] == 4 * (3 * 2 * 17 * 8 * 6 + 2 * 17)
    assert json.loads(out.read_text()) == report


TOOLS = {"bench": bench, "bench_e2e": bench_e2e, "bench_serve": bench_serve,
         "bench_variant": bench_variant, "bench_bu_variant": bench_bu_variant,
         "budget_table": budget_table}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_main_needs_the_gpu_unless_asked_for_the_cpu(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TOOLS[tool].main([])
