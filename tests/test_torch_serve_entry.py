"""The port's serving entry (``mindpose_tpu_torch/tools/serve.py``) on the CPU.

configs/simple_baseline/resnet50_tpu.yaml as parsed, at full width, with
the weights of one checkpoint (ResNet-50 + simple_baseline_head, flax
variables filled from a numpy seed) written both as a port checkpoint and
as the JAX package's flax msgpack file:

- ``build_service`` behind ``build_http_server`` answers ``POST /predict``
  over a real socket exactly as a ``TopDownPredictor`` built by hand on the
  same weights, from either file;
- against the JAX package's ``tools/serve.py:build_service`` on the msgpack
  file: keypoints within test_torch_predictor.py's tolerances for the cv2
  crop (JAX) against the gather warp (the port): a median distance under
  0.1 px, scores within half their mean;
- the refusals (``--quantize`` with a bottom-up config, as the JAX tool
  refuses it; int8), the CPU only on request, the seeded weights without
  ``--ckpt``, and the CLI's flags. Bottom-up serving itself is
  tests/test_torch_bottomup_serve.py's.
"""
import base64
import importlib.util
import json
import logging
import os
import threading
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from mindpose_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from mindpose_tpu_torch.engine import TopDownPredictor, build_http_server
from mindpose_tpu_torch.models import create_network_from_config
from mindpose_tpu_torch.models.convert import convert_net_variables
from mindpose_tpu_torch.tools import serve
from mindpose_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_torch_simple_baseline import full  # noqa: F401  (ResNet-50 flax variables)
from tests.fixtures.torch_threads import torch_threads  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "simple_baseline", "resnet50_tpu.yaml")
BOTTOM_UP = os.path.join(ROOT, "configs", "higher_hrnet", "higher_hrnet_w32_tpu.yaml")


def _args(*flags):
    return serve.parse_serve_args(["--config", CONFIG, "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def ckpts(full, tmp_path_factory):  # noqa: F811
    """(port checkpoint, JAX msgpack file, the port's state_dict) of one set of weights."""
    _, variables = full
    root = tmp_path_factory.mktemp("serve_ckpts")
    flax_path = str(root / "resnet50.msgpack")
    jax_save_checkpoint(flax_path, variables)
    with torch.device("meta"):
        net = create_network_from_config(_args())
    state = convert_net_variables(variables, net)
    net = net.to_empty(device="cpu")
    net.load_state_dict(state, strict=True)
    port_path = str(root / "resnet50_last.ckpt")
    save_checkpoint(port_path, net)
    return port_path, flax_path, state


def _request():
    rng = np.random.RandomState(11)
    image = cv2.GaussianBlur(rng.randint(0, 256, (240, 320, 3)).astype(np.uint8), (7, 7), 2.0)
    boxes = np.array([[10, 20, 100, 180], [150, 5, 120, 200], [200, 100, 110, 130]], np.float32)
    return image, boxes


def _png(image_rgb):
    ok, buf = cv2.imencode(".png", cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR))  # lossless
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _serve_and_post(service, payload):
    """One POST /predict and one GET /healthz over a real socket; the server
    and its thread are gone on return."""
    httpd, port = build_http_server(service, port=0)
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
    assert not thread.is_alive()
    assert health == {"status": "ok", "mode": "topdown", "num_joints": 17}
    return np.asarray(body["predictions"], np.float32)


def _by_hand(state):
    """The predictor a caller builds by hand from the yaml's settings."""
    args = _args()
    with torch.device("meta"):
        net = create_network_from_config(args)
    net = net.to_empty(device="cpu")
    net.load_state_dict(state, strict=True)
    return TopDownPredictor(net, args.dataset_setting, args.decoder_setting, args.normalize_mean,
                            args.normalize_std, batch_size=2, device="cpu")


@pytest.mark.parametrize("which", ["port checkpoint", "flax msgpack"])
def test_service_answers_over_http_as_the_predictor_built_by_hand(ckpts, which):
    port_path, flax_path, state = ckpts
    args = _args("--ckpt", port_path if which == "port checkpoint" else flax_path,
                 "--batch-size", "2")
    service = serve.build_service(args, batch_size=args.batch_size, device=args.device)
    served = service.predictor.net.state_dict()
    for k, v in state.items():
        assert torch.equal(served[k], v), k
    image, boxes = _request()
    got = _serve_and_post(service, {"image_b64": _png(image), "boxes": boxes.tolist()})
    want = _by_hand(state)(image, boxes)
    assert got.shape == (3, 17, 3)
    np.testing.assert_array_equal(got, want)


def _jax_serve_module(monkeypatch):
    """``tools/serve.py`` of the JAX package, imported from its file (it
    imports ``common`` from its own directory)."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    spec = importlib.util.spec_from_file_location("jax_tools_serve",
                                                  os.path.join(ROOT, "tools", "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_service_matches_the_jax_serve_composition(ckpts, monkeypatch):
    _, flax_path, _ = ckpts
    jax_serve = _jax_serve_module(monkeypatch)
    from mindpose_tpu.config import parse_args as jax_parse_args

    jax_args = jax_parse_args(["--config", CONFIG, "--ckpt", flax_path])
    jax_service = jax_serve.build_service(jax_args, batch_size=4)
    service = serve.build_service(_args("--ckpt", flax_path), batch_size=4, device="cpu")
    image, boxes = _request()
    want = jax_service.predictor(image, boxes)
    got = service.predictor(image, boxes)
    assert got.shape == want.shape == (3, 17, 3)
    dist = np.linalg.norm(got[..., :2] - want[..., :2], axis=-1)
    assert np.median(dist) < 0.1
    assert np.abs(got[..., 2] - want[..., 2]).mean() < 0.5 * np.abs(want[..., 2]).mean()


@pytest.mark.parametrize("case,error,item", [
    ("bottomup quantized", ValueError, "top-down predictor only"),
    ("int8", NotImplementedError, "the rest: int8"),
])
def test_refusals_name_their_roadmap_item(ckpts, case, error, item):
    if case == "bottomup quantized":
        args = serve.parse_serve_args(["--config", BOTTOM_UP, "--device", "cpu",
                                       "--quantize", "int8"])
        assert args.pipeline_method == "bottomup"
    else:
        args = _args("--ckpt", ckpts[0], "--quantize", "int8")
    with pytest.raises(error, match=item):
        serve.build_service(args, device="cpu")


def test_unknown_quantize_mode_is_an_error(ckpts):
    with pytest.raises(ValueError, match="quantize"):
        serve.build_service(_args("--ckpt", ckpts[0], "--quantize", "fp8"), device="cpu")


def test_serves_on_the_gpu_unless_asked_for_the_cpu(ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_serve_args(["--config", CONFIG, "--ckpt", ckpts[0]])
    assert args.device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build_service(args)
    service = serve.build_service(args, device="cpu")
    assert service.predictor.device == torch.device("cpu")


def test_without_ckpt_it_serves_seeded_initial_weights_and_warns(caplog):
    before = torch.random.get_rng_state()
    with caplog.at_level(logging.WARNING):
        service = serve.build_service(_args(), device="cpu")
    assert "no --ckpt" in caplog.text
    assert torch.equal(torch.random.get_rng_state(), before)  # the caller's stream untouched
    torch.manual_seed(serve.SEED)
    want = create_network_from_config(_args()).state_dict()
    torch.random.set_rng_state(before)
    got = service.predictor.net.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_cli_flags():
    args = _args()
    assert (args.host, args.port, args.batch_size, args.quantize) == ("127.0.0.1", 8080, 32, "")
    assert args.ckpt is None and args.device == "cpu"
    assert args.backbone_name == "resnet50" and args.head_name == "simple_baseline_head"
    args = serve.parse_serve_args(["--config", CONFIG, "--host", "0.0.0.0", "--port", "0",
                                   "--batch-size", "8", "--cfg-options",
                                   "decoder_setting.shift_coordinate=True"])
    assert (args.host, args.port, args.batch_size, args.device) == ("0.0.0.0", 0, 8, None)
    assert args.decoder_setting == {"shift_coordinate": True}
