"""The port's native COCO library against the JAX package's, and against its numpy paths.

``mindpose_tpu_torch/csrc/coco_native.cpp`` is a byte-for-byte copy of
``csrc/coco_native.cpp`` (tests/test_torch_host_copies.py pins the bytes),
built with the same ``g++`` flags into ``build/mindpose_tpu_torch/``. On
seeded inputs (OKS rows with labelled joints and with none labelled but a
box, pairwise OKS with ``vis_thr`` None and set, RLE counts) its three
functions give the JAX package's library's results bit for bit, and the
port's callers (``COCOeval.computeOks``, ``oks_iou``, ``decode_rle``) agree
with their numpy paths within 1e-9, the bound of
tests/utils/test_native_parity.py. A library that cannot build raises with
the compiler's output, where the JAX package would take numpy.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from mindpose_tpu.utils import native as jax_native
from mindpose_tpu_torch.ops.cuda import build
from mindpose_tpu_torch.utils import native
from mindpose_tpu_torch.utils.coco import COCO, decode_rle
from mindpose_tpu_torch.utils.cocoeval import COCO_SIGMAS, COCOeval
from mindpose_tpu_torch.utils.nms import oks_iou
from tests.cocofixtures import make_realistic_eval_fixture
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMPY_ATOL = 1e-9  # tests/utils/test_native_parity.py's bound on the stats
VARIANCES = (np.asarray(COCO_SIGMAS) * 2) ** 2


@pytest.fixture
def toggle():
    """Both switches back on after the test."""
    yield native.set_native_enabled
    native.set_native_enabled(True)
    jax_native.set_native_enabled(True)


def _instances(rng, n, k=17, labelled=True):
    g = np.zeros(3 * k)
    g[0::3] = rng.uniform(0, 640, k)
    g[1::3] = rng.uniform(0, 480, k)
    g[2::3] = rng.choice([0, 1, 2], k) if labelled else 0
    d = np.zeros((n, 3 * k))
    d[:, 0::3] = g[0::3] + rng.randn(n, k) * rng.uniform(1, 60)
    d[:, 1::3] = g[1::3] + rng.randn(n, k) * rng.uniform(1, 60)
    d[:, 2::3] = rng.rand(n, k)
    box = np.array([*rng.uniform(0, 400, 2), *rng.uniform(20, 200, 2)])
    return g, d, rng.uniform(100.0, 90000.0), rng.uniform(100.0, 90000.0, n), box


def _counts(rng, h, w):
    """Run lengths of an HxW mask, background first, summing to h*w."""
    n = min(rng.randint(1, 40), h * w - 1)
    cuts = np.sort(rng.choice(np.arange(1, h * w), n, replace=False))
    counts = np.diff(np.concatenate([[0], cuts, [h * w]]))
    if rng.rand() < 0.5:
        counts = np.concatenate([[0], counts])  # the mask starts with foreground
    return counts.astype(np.int64)


def test_the_library_is_built_from_the_port_s_copy():
    built = build.load_host_library(native.SOURCE)
    assert built.path.parent == build.BUILD_DIR
    assert built.path.name.startswith("libcoco_native-")
    assert build.HOST_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC")
    assert native.native_available() and jax_native.native_available()


@pytest.mark.parametrize("labelled", [True, False], ids=["labelled", "box_only"])
def test_oks_row_bit_for_bit_with_jax_s_library(labelled):
    rng = np.random.RandomState(1 if labelled else 2)
    for _ in range(60):
        g, d, area, _, box = _instances(rng, rng.randint(1, 12), labelled=labelled)
        got = native.compute_oks_row(g, d, area, box, VARIANCES)
        want = jax_native.compute_oks_row(g, d, area, box, VARIANCES)
        assert got.dtype == np.float64 and got.shape == (len(d),)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vis_thr", [None, 0.3], ids=["vis_thr_none", "vis_thr_set"])
def test_oks_pairs_bit_for_bit_with_jax_s_library(vis_thr):
    rng = np.random.RandomState(3)
    for _ in range(60):
        g, d, area, areas, _ = _instances(rng, rng.randint(1, 12))
        got = native.oks_iou_pairs(g, d, area, areas, VARIANCES, vis_thr)
        want = jax_native.oks_iou_pairs(g, d, area, areas, VARIANCES, vis_thr)
        np.testing.assert_array_equal(got, want)


def test_rle_bit_for_bit_with_jax_s_library_and_a_wrong_sum_raises():
    rng = np.random.RandomState(4)
    for _ in range(40):
        h, w = rng.randint(2, 60, 2)
        counts = _counts(rng, h, w)
        got = native.decode_rle_native(counts, h, w)
        np.testing.assert_array_equal(got, jax_native.decode_rle_native(counts, h, w))
        assert got.shape == (h, w) and got.dtype == np.uint8
    bad = np.array([5, 3, 2], np.int64)  # 10 != 4 * 3
    with pytest.raises(ValueError, match="RLE counts sum"):
        native.decode_rle_native(bad, 4, 3)
    with pytest.raises(ValueError, match="RLE counts sum"):
        decode_rle({"counts": bad.tolist(), "size": [4, 3]})


def test_rle_decode_equals_the_numpy_path(toggle):
    rng = np.random.RandomState(5)
    for _ in range(40):
        h, w = rng.randint(2, 60, 2)
        rle = {"counts": _counts(rng, h, w).tolist(), "size": [int(h), int(w)]}
        toggle(True)
        fast = decode_rle(rle)
        toggle(False)
        np.testing.assert_array_equal(fast, decode_rle(rle))


@pytest.mark.parametrize("vis_thr", [None, 0.4], ids=["vis_thr_none", "vis_thr_set"])
def test_oks_iou_within_1e_9_of_the_numpy_path(toggle, vis_thr):
    rng = np.random.RandomState(6)
    for _ in range(60):
        g, d, area, areas, _ = _instances(rng, rng.randint(1, 10))
        toggle(True)
        fast = oks_iou(g, d, area, areas, vis_thr=vis_thr)
        toggle(False)
        ref = oks_iou(g, d, area, areas, vis_thr=vis_thr)
        np.testing.assert_allclose(fast, ref, rtol=0, atol=NUMPY_ATOL)


@pytest.mark.parametrize("unlabelled", [False, True], ids=["labelled", "half_box_only"])
def test_compute_oks_and_stats_within_1e_9_of_the_numpy_path(toggle, unlabelled):
    gt, results = make_realistic_eval_fixture(num_images=8, seed=7)
    if unlabelled:  # the rows of these gts take the doubled-box distance
        for a in gt["annotations"][::2]:
            kp = np.asarray(a["keypoints"], float)
            kp[2::3] = 0
            a["keypoints"] = kp.tolist()
    runs = {}
    for on in (True, False):
        toggle(on)
        ev = COCOeval(COCO(gt), COCO(gt).loadRes(results), "keypoints")
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        runs[on] = ev
    for key, ious in runs[True].ious.items():
        np.testing.assert_allclose(ious, runs[False].ious[key], rtol=0, atol=NUMPY_ATOL)
    np.testing.assert_allclose(runs[True].stats, runs[False].stats, rtol=0, atol=NUMPY_ATOL)
    assert runs[True].stats[0] > 0


def test_disabled_the_functions_return_none_and_the_callers_take_numpy(toggle):
    rng = np.random.RandomState(8)
    g, d, area, areas, box = _instances(rng, 3)
    toggle(False)
    assert not native.native_available() and native.get_native() is None
    assert native.compute_oks_row(g, d, area, box, VARIANCES) is None
    assert native.oks_iou_pairs(g, d, area, areas, VARIANCES, None) is None
    assert native.decode_rle_native(np.array([2, 2], np.int64), 2, 2) is None
    assert oks_iou(g, d, area, areas).shape == (3,)


def test_mindpose_native_0_selects_the_numpy_paths_at_import():
    code = ("from mindpose_tpu_torch.utils import native; "
            "print(native.native_available(), native.get_native())")
    env = dict(os.environ, MINDPOSE_NATIVE="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.split() == ["False", "None"], out.stdout + out.stderr


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet; the caches cleared
    again afterwards, so that later tests load the real library."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.load_host_library.cache_clear()
    native._configured.cache_clear()
    yield tmp_path
    build.load_host_library.cache_clear()
    native._configured.cache_clear()


def test_a_source_that_does_not_compile_raises_with_the_compiler_s_output(fresh_build,
                                                                          monkeypatch, toggle):
    csrc = fresh_build / "csrc"
    csrc.mkdir()
    (csrc / "coco_native.cpp").write_text('extern "C" { int broken( }\n')
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    toggle(True)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on .*coco_native\.cpp:\n.*error"):
        native.get_native()
    gt, results = make_realistic_eval_fixture(num_images=2, seed=9)
    ev = COCOeval(COCO(gt), COCO(gt).loadRes(results), "keypoints")
    with pytest.raises(RuntimeError, match="failed on"):
        ev.evaluate()  # no quiet numpy path
    assert not list((fresh_build / "build").glob("*.so"))


def test_a_missing_compiler_raises(fresh_build, monkeypatch, toggle):
    monkeypatch.setenv("PATH", str(fresh_build))
    toggle(True)
    g, d, area, areas, _ = _instances(np.random.RandomState(10), 2)
    with pytest.raises(RuntimeError, match="could not run"):
        oks_iou(g, d, area, areas)
    toggle(False)
    assert oks_iou(g, d, area, areas).shape == (2,)  # asked for: numpy
