"""The port's HTTP pose service: a round trip over a real socket with a tiny model.

Mirrors tests/engine/test_http_server.py, with the port's ``PoseService`` in
front of the port's ``TopDownPredictor`` (a reduced HRNet on the CPU).
"""
import base64
import json
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from mindpose_tpu_torch.engine import PoseService, TopDownPredictor, build_http_server
from mindpose_tpu_torch.models.backbones.hrnet import HRNet
from mindpose_tpu_torch.models.heads import HRNetHead
from mindpose_tpu_torch.models.networks import Net
from tests.test_torch_hrnet import CFG

SETTING = {
    "image_size": [64, 64],
    "heatmap_size": [16, 16],
    "pixel_std": 200.0,
    "scale_padding": 1.25,
}


@pytest.fixture(scope="module")
def server():
    torch.manual_seed(0)
    predictor = TopDownPredictor(Net(HRNet(CFG), HRNetHead(8, 17)), SETTING, batch_size=4,
                                 device=torch.device("cpu"))
    service = PoseService(predictor, mode="topdown", num_joints=17)
    httpd, port = build_http_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{port}"
    httpd.shutdown()
    httpd.server_close()
    service.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _jpeg(image):
    ok, buf = cv2.imencode(".jpg", image)
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def test_healthz(server):
    with urllib.request.urlopen(server + "/healthz", timeout=60) as resp:
        assert resp.status == 200
        body = json.loads(resp.read())
    assert body == {"status": "ok", "mode": "topdown", "num_joints": 17}


def test_predict_roundtrip(server):
    image = np.random.RandomState(0).randint(0, 255, (120, 160, 3), np.uint8)
    payload = {"image_b64": _jpeg(image), "boxes": [[10, 10, 60, 100], [80, 5, 70, 110]]}
    status, body = _post(server + "/predict", payload)
    assert status == 200, body
    preds = np.asarray(body["predictions"])
    assert preds.shape == (2, 17, 3)
    # coordinates map back to the original frame (the 1.25-padded crop can
    # extend past the image, so allow that margin)
    assert np.isfinite(preds).all()
    assert preds[..., 0].min() > -80 and preds[..., 0].max() < 240
    assert body["latency_ms"] > 0

    # whole-image default box
    status, body = _post(server + "/predict", {"image_b64": _jpeg(image)})
    assert status == 200
    assert np.asarray(body["predictions"]).shape == (1, 17, 3)


def test_predict_errors(server):
    status, body = _post(server + "/predict", {})
    assert status == 400 and "image_b64" in body["error"]

    status, body = _post(server + "/predict", {"image_b64": "!!!"})
    assert status == 400 and "base64" in body["error"]

    good = _jpeg(np.zeros((32, 32, 3), np.uint8))
    status, body = _post(server + "/predict", {"image_b64": good, "boxes": [[1, 2, 3]]})
    assert status == 400 and "boxes" in body["error"]

    status, body = _post(
        server + "/predict",
        {"image_b64": good, "boxes": [[0, 0, 32, 32]], "box_scores": [1, 2]},
    )
    assert status == 400 and "box_scores" in body["error"]


def test_unknown_path_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(server + "/nope", timeout=60)
    assert err.value.code == 404


def test_only_the_ported_mode_is_served():
    with pytest.raises(ValueError, match="sideways"):
        PoseService(predictor=None, mode="sideways", num_joints=17)
    for mode in ("topdown", "bottomup"):
        service = PoseService(predictor=None, mode=mode, num_joints=17)
        assert service.health() == {"status": "ok", "mode": mode, "num_joints": 17}
        service.close()


class _ThreadRecorder:
    """A predictor that records the thread each call runs on."""

    def __init__(self):
        self.threads = []

    def __call__(self, image, boxes, box_scores=None):
        self.threads.append(threading.get_ident())
        return np.zeros((len(boxes), 17, 3), np.float32)


def test_predictions_run_on_one_worker_thread():
    """The HTTP server handles each request on a new thread; the predictor runs
    on the service's one worker thread whatever thread asks, so that state
    PyTorch keeps per thread (cuDNN's convolution plans) lasts across
    requests. ``close`` ends the worker."""
    recorder = _ThreadRecorder()
    service = PoseService(recorder, mode="topdown", num_joints=17)
    httpd, port = build_http_server(service, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        payload = {"image_b64": _jpeg(np.zeros((32, 32, 3), np.uint8))}
        for _ in range(3):
            status, _ = _post(f"http://127.0.0.1:{port}/predict", payload)
            assert status == 200
        callers = []
        for _ in range(2):  # two more callers, each on a thread of its own
            t = threading.Thread(target=lambda: callers.append(service.predict(payload)))
            t.start()
            t.join(timeout=60)
        assert len(callers) == 2
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert len(recorder.threads) == 5 and len(set(recorder.threads)) == 1
    worker = [t for t in threading.enumerate() if t.ident == recorder.threads[0]]
    assert worker and worker[0].name.startswith("pose-predict")
    service.close()
    assert not worker[0].is_alive()
