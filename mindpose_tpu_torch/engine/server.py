"""HTTP pose-estimation service around the predictors (stdlib only).

Counterpart of mindpose_tpu/engine/server.py, with the same wire format,
for ``TopDownPredictor`` (``mode="topdown"``) and ``BottomUpPredictor``
(``mode="bottomup"``: every person in the image, no boxes).

Endpoints:
    GET  /healthz   -> {"status": "ok", "mode": ..., "num_joints": ...}
    POST /predict   body {"image_b64": <base64 jpeg/png>,
                          "boxes": [[x, y, w, h], ...] (top-down; optional —
                          defaults to one whole-image box),
                          "box_scores": [...] (optional)}
                    -> {"predictions": [[[x, y, score] * K] * M],
                        "scores": [...] (bottom-up only),
                        "latency_ms": float}

Inference runs on one long-lived worker thread of the service (one model,
one device, one request at a time): the HTTP server handles each request on
a new thread, and PyTorch keeps cuDNN's convolution plans per thread, so a
predictor called from each request's own thread would plan every
convolution again (on an H100, ResNet-50 at 1 box: ~80 ms a request instead
of ~7). HTTP handling is threaded so health checks never queue behind a
predict. Image decoding uses cv2, imported when a request arrives.
"""
import base64
import binascii
import json
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["PoseService", "build_http_server"]


class PoseService:
    """JSON request handling + single-flight inference over a predictor, on
    one worker thread that ``close`` ends."""

    def __init__(self, predictor, mode: str, num_joints: int) -> None:
        if mode not in ("topdown", "bottomup"):
            raise ValueError(f"unknown mode: {mode!r}")
        self.predictor = predictor
        self.mode = mode
        self.num_joints = num_joints
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="pose-predict")

    def close(self) -> None:
        """Wait for the prediction in flight, then end the worker thread."""
        self._worker.shutdown(wait=True)

    def health(self) -> Dict[str, Any]:
        return {"status": "ok", "mode": self.mode, "num_joints": self.num_joints}

    def predict(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Handle one /predict payload (raises ValueError on bad input)."""
        import cv2

        if "image_b64" not in request:
            raise ValueError("missing field: image_b64")
        try:
            raw = base64.b64decode(request["image_b64"], validate=True)
        except (binascii.Error, TypeError, ValueError) as exc:
            raise ValueError(f"invalid base64 image: {exc}") from exc
        bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError("image bytes did not decode")
        image = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

        start = time.perf_counter()
        if self.mode == "bottomup":
            preds, scores = self._worker.submit(self.predictor, image).result()
            return {
                "predictions": [np.asarray(p)[:, :3].tolist() for p in preds],
                "scores": [float(s) for s in scores],
                "latency_ms": (time.perf_counter() - start) * 1e3,
            }
        boxes = request.get("boxes")
        if boxes is None:
            boxes = [[0, 0, image.shape[1], image.shape[0]]]
        boxes = np.asarray(boxes, np.float32)
        if boxes.ndim != 2 or boxes.shape[1] != 4:
            raise ValueError("boxes must be a list of [x, y, w, h]")
        box_scores = request.get("box_scores")
        if box_scores is not None:
            box_scores = np.asarray(box_scores, np.float32)
            if box_scores.shape != (len(boxes),):
                raise ValueError("box_scores length must match boxes")
        preds = self._worker.submit(self.predictor, image, boxes, box_scores=box_scores).result()
        return {
            "predictions": np.asarray(preds).tolist(),
            "latency_ms": (time.perf_counter() - start) * 1e3,
        }


def _make_handler(service: PoseService):
    class Handler(BaseHTTPRequestHandler):
        # quiet the default per-request stderr lines; keep errors
        def log_message(self, fmt, *fmt_args):
            logging.debug("serve: " + fmt, *fmt_args)

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/healthz":
                self._send(200, service.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                request = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(request, dict):
                    raise ValueError("request body must be a JSON object")
                self._send(200, service.predict(request))
            except ValueError as exc:
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # the server keeps running; the client gets a 500
                logging.exception("predict failed")
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def build_http_server(
    service: PoseService, host: str = "127.0.0.1", port: int = 0
) -> Tuple[ThreadingHTTPServer, int]:
    """Bind (port 0 = ephemeral) and return (server, bound_port).

    The caller runs ``server.serve_forever()`` (or on a thread) and
    ``server.shutdown()`` to stop.
    """
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    return server, server.server_address[1]
