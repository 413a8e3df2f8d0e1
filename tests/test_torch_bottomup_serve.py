"""Bottom-up serving on the CPU: ``BottomUpPredictor``, ``PoseService(mode="bottomup")``
over HTTP on 127.0.0.1 and ``tools/serve.build_service``, against the JAX
package's ``BottomUpPredictor`` and ``tools/serve.py``.

The bottom-up fixture (tests/make_torch_bottomup_fixture.py) serves a
tiny_coco val frame and a 640x480 frame with its persons drawn larger.
Against JAX, with the host Hungarian (the default on the CPU in both) and
with the fixed-capacity matcher: the same persons, keypoints (x, y) within
``XY_ATOL`` px (both map the same heatmap positions back; the decoder's
candidates differ by float noise only), scores and keypoint values within
``SCORE_ATOL``. The HTTP answer equals the predictor's call. The predictor
serves on the GPU unless asked for the CPU, and the serving entry builds
the HigherHRNet-W32 recipe's service with a square 832 input.
"""
import base64
import importlib.util
import json
import os
import threading
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindpose_tpu.config import parse_args as jax_parse_args
from mindpose_tpu.engine.predictor import BottomUpPredictor as JaxBottomUpPredictor
from mindpose_tpu.models import create_network as jax_create_network
from mindpose_tpu.utils.checkpoint import load_variables
from mindpose_tpu_torch.config import Config
from mindpose_tpu_torch.engine import BottomUpPredictor, PoseService, build_http_server
from mindpose_tpu_torch.models import create_network_from_config
from mindpose_tpu_torch.tools import serve
from mindpose_tpu_torch.utils.checkpoint import load_net_state_dict
from tests.fixtures import tiny_coco
from tests.fixtures.eval_checks import BOTTOMUP_CKPT, BOTTOMUP_RECORD, register_port_backbone
from tests.make_torch_eval_fixture import register_jax_backbone

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "higher_hrnet", "higher_hrnet_w32_tpu.yaml")
XY_ATOL = 1e-3
SCORE_ATOL = 1e-4
CFG = BOTTOMUP_RECORD["config"]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A val frame (224x160) and a 640x480 frame holding it scaled by 2.5, the
    persons at the scale the fixture learned once the predictor rescales."""
    img_root, _ = tiny_coco.write_val(str(tmp_path_factory.mktemp("bottomup_serve")))
    val = cv2.cvtColor(cv2.imread(os.path.join(img_root, "000000000001.png")),
                       cv2.COLOR_BGR2RGB)
    big = np.zeros((480, 640, 3), np.uint8)
    big[40:440, 40:600] = cv2.resize(val, (560, 400), interpolation=cv2.INTER_LINEAR)
    return {"val 224x160": val, "640x480": big}


def _port_predictor(device="cpu", **eval_setting):
    register_port_backbone()
    args = Config(**CFG)
    with torch.device("meta"):
        skeleton = create_network_from_config(args)
    args.eval_setting = dict(args.eval_setting, **eval_setting)
    return BottomUpPredictor.from_config(args, load_net_state_dict(BOTTOMUP_CKPT, skeleton),
                                         device=device)


def _jax_predictor(**eval_setting):
    register_jax_backbone()
    net = jax_create_network(CFG["backbone_name"], CFG["head_name"], num_joints=17,
                             head_args=CFG["head_setting"])
    w, h = CFG["dataset_setting"]["image_size"]
    variables = load_variables(BOTTOMUP_CKPT, net.init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, h, w, 3)), train=False))
    return JaxBottomUpPredictor(net, variables, dataset_setting=CFG["dataset_setting"],
                                eval_setting=dict(CFG["eval_setting"], **eval_setting),
                                decoder_setting=CFG["decoder_setting"])


def _same_persons(got, want):
    (preds, scores), (w_preds, w_scores) = got, want
    assert preds.shape == w_preds.shape and scores.shape == w_scores.shape
    assert len(preds) >= 2  # the two drawn persons at least
    np.testing.assert_allclose(preds[..., :2], w_preds[..., :2], atol=XY_ATOL, rtol=0)
    np.testing.assert_allclose(preds[..., 2], w_preds[..., 2], atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(scores, w_scores, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("device_grouping", [False, True], ids=["host", "matcher"])
def test_predictor_matches_jax(frames, device_grouping):
    port = _port_predictor(device_grouping=device_grouping)
    jax_pred = _jax_predictor(device_grouping=device_grouping)
    for name, image in frames.items():
        got = port(image)
        assert got[0].dtype == np.float32 and got[0].shape[1:] == (17, 4), name
        _same_persons(got, jax_pred(image))


def _png(image_rgb):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR))  # lossless
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _post(service, payload):
    """GET /healthz and POST /predict over a real socket on 127.0.0.1; the
    server, the service and their threads are gone on return."""
    before = set(threading.enumerate())
    httpd, port = build_http_server(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        req = urllib.request.Request(url + "/predict", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.status == 200
            body = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        thread.join(timeout=10)
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert health == {"status": "ok", "mode": "bottomup", "num_joints": 17}
    return body


def test_service_answers_over_http_as_the_predictor(frames):
    image = frames["640x480"]
    predictor = _port_predictor()
    preds, scores = predictor(image)
    body = _post(PoseService(predictor, mode="bottomup", num_joints=17),
                 {"image_b64": _png(image)})
    assert set(body) == {"predictions", "scores", "latency_ms"}
    np.testing.assert_array_equal(np.asarray(body["predictions"], np.float32), preds[..., :3])
    np.testing.assert_array_equal(np.asarray(body["scores"], np.float32), scores)
    assert body["latency_ms"] > 0


def _jax_serve_module(monkeypatch):
    """``tools/serve.py`` of the JAX package, imported from its file."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location("jax_tools_serve",
                                                  os.path.join(ROOT, "tools", "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def fixture_yaml(tmp_path):
    """The fixture's config as a yaml file, as the serving CLIs read one."""
    import yaml

    path = tmp_path / "fixture_bottomup.yaml"
    path.write_text(yaml.safe_dump(CFG))
    return str(path)


def test_build_service_matches_the_jax_serve_entry(frames, fixture_yaml, monkeypatch):
    register_port_backbone()
    register_jax_backbone()
    jax_serve = _jax_serve_module(monkeypatch)
    jax_args = jax_parse_args(["--config", fixture_yaml, "--ckpt", BOTTOMUP_CKPT])
    jax_service = jax_serve.build_service(jax_args)
    args = serve.parse_serve_args(["--config", fixture_yaml, "--ckpt", BOTTOMUP_CKPT,
                                   "--device", "cpu"])
    service = serve.build_service(args, device=args.device)
    assert service.mode == jax_service.mode == "bottomup"
    assert isinstance(service.predictor, BottomUpPredictor)
    image = frames["640x480"]
    body = _post(service, {"image_b64": _png(image)})
    want = jax_service.predict({"image_b64": _png(image)})
    got = (np.asarray(body["predictions"], np.float32), np.asarray(body["scores"], np.float32))
    want = (np.asarray(want["predictions"], np.float32), np.asarray(want["scores"], np.float32))
    assert got[0].shape[1:] == (17, 3)
    _same_persons(got, want)


def test_predictor_serves_on_the_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_predictor(device=None)
    assert _port_predictor().device == torch.device("cpu")


def test_the_recipe_builds_a_bottomup_service():
    """higher_hrnet_w32_tpu.yaml through the serving entry (seeded weights):
    a BottomUpPredictor at a square 832 input, HRNet-W32 + the head."""
    args = serve.parse_serve_args(["--config", YAML, "--device", "cpu"])
    service = serve.build_service(args, device=args.device)
    try:
        assert service.mode == "bottomup" and service.health()["num_joints"] == 17
        predictor = service.predictor
        assert isinstance(predictor, BottomUpPredictor)
        assert list(predictor._rescale._transform_cfg["max_image_size"]) == [832, 832]
        assert type(predictor.net.head).__name__ == "HigherHRNetHead"
        assert not predictor.net.training
    finally:
        service.close()
