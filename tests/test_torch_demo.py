"""The port's demo CLIs and image-folder dataset against the JAX package's, on the CPU.

``mindpose_tpu_torch/tools/demo.py`` and ``demo_video.py`` run on a few
frames of the synthetic fixture (tests/fixtures/tiny_coco.py) with the JAX
fixture checkpoints: the reduced HRNet's top-down TrainState and the
bottom-up one (tests/fixtures/eval_checks.py). JAX's ``tools/demo.py`` and
``tools/demo_video.py`` run beside them on the same files. The persons each
draws are recorded:

- top-down with ``--boxes``: the port draws the persons JAX draws, x and y
  within 1e-3 px and scores within 0.01, and writes the same files. The
  two predictors crop differently (the port's device gather warp against
  cv2's uint8 crop; on the fixture's boxes 1.6e-5 px and 1.02e-3 apart,
  tests/test_torch_crop_gap.py). With the whole frame as the box, which
  holds several persons, a joint's heatmap may peak twice about equally,
  and then the two crops may pick either peak: at least 90% of the joints
  are held so, as tests/test_torch_predictor.py holds its clear joints;
- bottom-up: every person, as JAX draws them, at the same tolerances;
- video: a short mp4v clip written with cv2, top-down (``--boxes``) and
  bottom-up, One-Euro smoothing on; every frame written, the smoothed
  persons as JAX's;
- the written image is the frame with the port's drawing of its persons;
- ``_associate`` and the drawing on seeded arrays, and
  ``imagefolder_bottomup``'s records and val batches, equal JAX's exactly.
"""
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import yaml

from mindpose_tpu.data import create_dataset as jax_create_dataset
from mindpose_tpu.data import create_pipeline as jax_create_pipeline
from mindpose_tpu_torch.data import create_dataset, create_pipeline
from mindpose_tpu_torch.engine import BottomUpPredictor, TopDownPredictor
from mindpose_tpu_torch.tools import demo, demo_video
from tests import make_torch_eval_fixture as fixture
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import (
    BOTTOMUP_CKPT,
    BOTTOMUP_RECORD,
    CKPT,
    RECORD,
    register_port_backbone,
)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 4
XY_ATOL = 1e-3  # px (see the module's note)
SCORE_ATOL = 0.01  # tests/test_torch_crop_gap.py's: the two crops' heatmap maxima
WHOLE_FRAME_SHARE = 0.9  # of joints, as tests/test_torch_predictor.py's clear joints
BOXES = ("--boxes", "20,10,60,120", "100,30,70,110")


def _jax_tool(monkeypatch, name):
    """``tools/<name>.py`` of the JAX package, imported from its file (it
    imports ``common`` from its own directory)."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Recorder:
    """Records the people each demo draws: the port's through ``draw``,
    JAX's image demo through its predictor's call and its video demo
    through ``_draw``."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.people = []

    def wrap(self, owner, name, result=False, keep_all=False):
        """Record ``owner.name``'s result (``result``) or its second argument:
        the people, (x, y, score) unless ``keep_all``."""
        original = getattr(owner, name)

        def recording(*args, **kwargs):
            out = original(*args, **kwargs)
            people = out if result else args[1]
            if isinstance(people, tuple):  # a bottom-up predictor's (preds, scores)
                people = people[0]
            people = np.asarray(people)
            self.people.append((people if keep_all else people[..., :3]).copy())
            return out

        self.monkeypatch.setattr(owner, name, recording)

    def take(self):
        people, self.people = self.people, []
        return people


def _close_people(got, want, share=1.0):
    """Frame by frame the same persons: x and y within XY_ATOL px and scores
    within SCORE_ATOL, for every joint or at least ``share`` of them."""
    assert len(got) == len(want) and len(want) > 0
    close = []
    for g, w in zip(got, want):
        assert g.shape == w.shape
        g, w = g.astype(np.float64), w.astype(np.float64)
        close.append((np.abs(g[..., :2] - w[..., :2]).max(-1) <= XY_ATOL)
                     & (np.abs(g[..., 2] - w[..., 2]) <= SCORE_ATOL))
    close = np.concatenate([c.ravel() for c in close])
    assert close.mean() >= share, close.mean()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    image_dir, _ = tiny_coco.write_split(str(root / "val"), FRAMES, tiny_coco.VAL_SEED)
    configs = {}
    for name, record in (("topdown", RECORD), ("bottomup", BOTTOMUP_RECORD)):
        configs[name] = str(root / f"{name}.yaml")
        with open(configs[name], "w") as f:
            yaml.safe_dump(record["config"], f)
    register_port_backbone()
    fixture.register_jax_backbone()
    return root, image_dir, configs


def _run(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["demo"] + argv)
    module.main()


def _image_demo(setup, monkeypatch, which, extra=()):
    root, image_dir, configs = setup
    ckpt = CKPT if which == "topdown" else BOTTOMUP_CKPT
    recorder = Recorder(monkeypatch)
    jax_demo = _jax_tool(monkeypatch, "demo")
    recorder.wrap(demo, "draw")
    recorder.wrap(jax_demo.BottomUpPredictor if which == "bottomup" else
                  jax_demo.TopDownPredictor, "__call__", result=True)
    outs = {}
    for label, module, device in (("port", demo, ["--device", "cpu"]), ("jax", jax_demo, [])):
        out_dir = str(root / f"{which}_{label}_{len(extra)}")
        _run(module, ["--config", configs[which], "--ckpt", ckpt, "--image-dir", image_dir,
                      "--output-dir", out_dir, *extra, *device], monkeypatch)
        outs[label] = (out_dir, recorder.take())
    return outs


@pytest.mark.parametrize("boxes", [(), BOXES], ids=["whole image", "boxes"])
def test_top_down_demo_draws_what_jax_draws(setup, monkeypatch, boxes):
    outs = _image_demo(setup, monkeypatch, "topdown", boxes)
    (port_dir, got), (jax_dir, want) = outs["port"], outs["jax"]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert len(os.listdir(port_dir)) == len(got) == FRAMES
    assert all(len(people) == (len(boxes) - 1 if boxes else 1) for people in got)
    # the whole frame holds several persons: where two peaks of a joint's
    # heatmap nearly tie, the two crops may pick either
    _close_people(got, want, 1.0 if boxes else WHOLE_FRAME_SHARE)


def test_bottom_up_demo_draws_what_jax_draws(setup, monkeypatch):
    outs = _image_demo(setup, monkeypatch, "bottomup")
    (port_dir, got), (jax_dir, want) = outs["port"], outs["jax"]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert sum(len(people) for people in got) > 0
    _close_people(got, want)


def test_demo_draws_its_people_on_the_frame(setup, monkeypatch):
    """The written image is the frame with ``draw``'s edges and joints."""
    root, image_dir, configs = setup
    recorder = Recorder(monkeypatch)
    recorder.wrap(demo, "draw")
    out_dir = str(root / "drawn")
    _run(demo, ["--config", configs["topdown"], "--ckpt", CKPT, "--image-dir", image_dir,
                "--output-dir", out_dir, "--device", "cpu"], monkeypatch)
    skeleton = demo.resolve_skeleton(type("A", (), {"dataset_setting": {}, "num_joints": 17}))
    for name, people in zip(sorted(os.listdir(image_dir)), recorder.take()):
        want = cv2.imread(os.path.join(image_dir, name))
        demo.draw(want, people, 0.2, skeleton)
        np.testing.assert_array_equal(cv2.imread(os.path.join(out_dir, name)), want)


def _write_clip(path, image_dir):
    frames = [cv2.imread(os.path.join(image_dir, n)) for n in sorted(os.listdir(image_dir))]
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (w, h))
    for frame in frames + frames[::-1]:
        writer.write(frame)
    writer.release()
    return 2 * len(frames)


def _frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def _jax_smoothing(raw, fps, bottomup, jax_video, num_joints=17):
    """JAX's ``tools/demo_video.py`` loop from each frame's predictions to the
    people it draws, with its own filter and association."""
    smoother, prev_centers, out = jax_video.OneEuroFilter(freq=fps), None, []
    for people in raw:
        if bottomup:
            people = np.asarray([p[:, :3] for p in people]) if len(people) \
                else np.zeros((0, num_joints, 3))
        if not people.size:
            prev_centers = None
            smoother.reset()
        else:
            if bottomup:
                people = jax_video._associate(people, prev_centers)
                prev_centers = people[:, :, :2].mean(axis=1)
            people = people.copy()
            people[..., :2] = smoother(people[..., :2])
        out.append(people)
    return out


@pytest.mark.parametrize("which", ["topdown", "bottomup"])
def test_video_demo_smooths_and_draws_what_jax_draws(setup, monkeypatch, which):
    """Each frame's predictions as JAX's (at least WHOLE_FRAME_SHARE of the
    joints: mp4v's compression blurs the frames, and a blurred joint may
    decode to either of two nearly equal heatmap cells, an error that the
    filter then carries into the next frames); the people drawn are JAX's
    smoothing and association of the port's predictions, exactly."""
    root, image_dir, configs = setup
    clip = str(root / "clip.mp4")
    n = _write_clip(clip, image_dir)
    ckpt = CKPT if which == "topdown" else BOTTOMUP_CKPT
    boxes = BOXES if which == "topdown" else ()
    jax_video = _jax_tool(monkeypatch, "demo_video")
    port_predictor = BottomUpPredictor if which == "bottomup" else TopDownPredictor
    jax_predictor = (jax_video.BottomUpPredictor if which == "bottomup"
                     else jax_video.TopDownPredictor)
    raw, drawn = Recorder(monkeypatch), Recorder(monkeypatch)
    raw.wrap(port_predictor, "__call__", result=True, keep_all=True)
    raw.wrap(jax_predictor, "__call__", result=True, keep_all=True)
    drawn.wrap(demo_video, "draw")
    people = {}
    for label, module, device in (("port", demo_video, ["--device", "cpu"]),
                                  ("jax", jax_video, [])):
        out = str(root / f"{which}_{label}.mp4")
        _run(module, ["--config", configs[which], "--ckpt", ckpt, "--video", clip,
                      "--output", out, *boxes, *device], monkeypatch)
        assert _frames(out) == n
        people[label] = raw.take()
    assert len(people["port"]) == n
    _close_people([p[..., :3] for p in people["port"]], [p[..., :3] for p in people["jax"]],
                  WHOLE_FRAME_SHARE)
    want = _jax_smoothing(people["port"], 10.0, which == "bottomup", jax_video)
    got = drawn.take()
    assert len(got) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_associate_and_draw_are_jax_s(monkeypatch):
    jax_video = _jax_tool(monkeypatch, "demo_video")
    rng = np.random.RandomState(3)
    for m in (1, 2, 5):
        people = rng.uniform(0, 200, (m, 17, 3))
        prev = people[rng.permutation(m), :, :2].mean(axis=1) + rng.normal(0, 2, (m, 2))
        np.testing.assert_array_equal(demo_video._associate(people, prev),
                                      jax_video._associate(people, prev))
        assert demo_video._associate(people, None) is people
    people = np.concatenate([rng.uniform(0, 150, (3, 17, 2)), rng.uniform(0, 1, (3, 17, 1))], -1)
    skeleton = demo.resolve_skeleton(type("A", (), {"dataset_setting": {}, "num_joints": 17}))
    got, want = np.zeros((160, 160, 3), np.uint8), np.zeros((160, 160, 3), np.uint8)
    demo.draw(got, people, 0.3, skeleton)
    jax_video._draw(want, people, 0.3, skeleton)
    np.testing.assert_array_equal(got, want)


BOTTOMUP_VAL = ["bottomup_rescale", "bottomup_pad"]


def test_imagefolder_bottomup_is_jax_s(tmp_path):
    image_dir, _ = tiny_coco.write_split(str(tmp_path), FRAMES, tiny_coco.VAL_SEED)
    setting = BOTTOMUP_RECORD["config"]["dataset_setting"]
    cv2.imwrite(os.path.join(image_dir, "extra.bmp"), np.zeros((40, 60, 3), np.uint8))
    open(os.path.join(image_dir, "notes.txt"), "w").close()
    port = create_dataset(image_dir, None, dataset_format="imagefolder_bottomup",
                          is_train=False, config=setting)
    jax = jax_create_dataset(image_dir, None, dataset_format="imagefolder_bottomup",
                             is_train=False, config=setting)
    assert len(port["dataset"]) == len(jax["dataset"]) == FRAMES + 1
    assert [port["dataset"][i] for i in range(FRAMES + 1)] == \
        [jax["dataset"][i] for i in range(FRAMES + 1)]
    with pytest.raises(ValueError, match="evaluation only"):
        create_dataset(image_dir, None, dataset_format="imagefolder_bottomup", is_train=True,
                       config=setting)
    kw = dict(method="imagefolder_bottomup", batch_size=1, is_train=False, config=setting)
    got_batches = list(create_pipeline(port, BOTTOMUP_VAL, **kw))
    want_batches = list(jax_create_pipeline(jax, BOTTOMUP_VAL, **kw))
    assert len(got_batches) == len(want_batches) == FRAMES + 1
    for got, want in zip(got_batches, want_batches):
        assert list(got) == list(want)
        for key in got:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), key)
