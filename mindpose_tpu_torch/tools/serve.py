"""Serving CLI: a pose model over HTTP (JSON in, keypoints out), on the GPU.

Counterpart of ``tools/serve.py`` (:36-106): the net the config names,
with the weights of ``--ckpt``, behind ``TopDownPredictor`` (or, for
``pipeline_method: bottomup``, ``BottomUpPredictor``: every person of an
image, no boxes) and the stdlib HTTP ``PoseService`` (``engine/server.py``
gives the wire format: ``POST /predict``, ``GET /healthz``). The
checkpoint is the port's own (the training entry's ``*_last.ckpt``,
``*_best.ckpt``) or the JAX package's flax msgpack file;
``utils/checkpoint.load_net_state_dict`` tells them apart. Without
``--ckpt`` it serves the net's own initial weights from a fixed seed, and
says so in a warning.

It serves on the current CUDA device unless ``--device`` says otherwise, and
raises without CUDA; it never falls back to the CPU. ``--quantize int8``
serves a top-down net with int8 weights (``TopDownPredictor``'s
``quantize``); any ``--quantize`` with a bottom-up config is refused, as the
JAX tool refuses it.

Usage:
    python3 -m mindpose_tpu_torch.tools.serve --config configs/simple_baseline/resnet50_tpu.yaml \\
        --ckpt ckpt/resnet50_tpu_last.ckpt [--host 127.0.0.1] [--port 8080] [--batch-size 32] \\
        [--quantize int8] [--device cpu]
    python3 -m mindpose_tpu_torch.tools.serve \\
        --config configs/higher_hrnet/higher_hrnet_w32_tpu.yaml --ckpt <file>
"""
import logging
from typing import Any, Optional, Sequence

import torch

from ..config import Config, parse_args
from ..engine import BottomUpPredictor, PoseService, TopDownPredictor, build_http_server
from ..models import create_network_from_config
from ..utils.checkpoint import load_net_state_dict

__all__ = ["build_service", "parse_serve_args", "main", "SEED"]

SEED = 0  # the torch seed of the initial weights served without --ckpt


def build_service(args: Any, batch_size: int = 32,
                  device: Optional[torch.device] = None) -> PoseService:
    """The service of a parsed config: its net with ``args.ckpt``'s weights
    (or seeded initial ones) behind a ``TopDownPredictor`` or, for
    ``pipeline_method: bottomup``, a ``BottomUpPredictor``, on ``device``
    (default: the current CUDA device). ``batch_size`` is the top-down
    predictor's boxes per forward pass."""
    mode = getattr(args, "pipeline_method", "topdown") or "topdown"
    quantize = getattr(args, "quantize", "") or ""
    if mode == "bottomup" and quantize:
        raise ValueError("--quantize is implemented for the top-down predictor only; "
                         "refusing to silently serve full-precision bottom-up weights")
    ckpt = getattr(args, "ckpt", None)
    if ckpt:
        # the net's structure alone picks a flax file's mapping
        with torch.device("meta"):
            skeleton = create_network_from_config(args)
        net_state = load_net_state_dict(ckpt, skeleton)
    else:
        logging.warning("no --ckpt: serving the net's initial weights (torch seed %d), "
                        "whose keypoints mean nothing", SEED)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            net_state = create_network_from_config(args).state_dict()
    if mode == "bottomup":
        predictor = BottomUpPredictor.from_config(args, net_state, device=device)
    else:
        predictor = TopDownPredictor.from_config(args, net_state, batch_size=batch_size,
                                                 quantize=quantize, device=device)
    return PoseService(predictor, mode=mode, num_joints=args.num_joints)


def parse_serve_args(argv: Optional[Sequence[str]] = None) -> Config:
    """The serving CLI's arguments: the config, ``--ckpt`` and the flags below."""
    return parse_args(argv, description="mindpose_tpu_torch pose HTTP server", extra_args=[
        {"names": ["--host"], "type": str, "default": "127.0.0.1"},
        {"names": ["--port"], "type": int, "default": 8080},
        {"names": ["--batch-size"], "type": int, "default": 32,
         "help": "boxes per forward pass (top-down)"},
        {"names": ["--quantize"], "type": str, "default": "",
         "help": "weight quantization: '' (float32) or 'int8' (top-down)"},
        {"names": ["--device"], "default": None,
         "help": "where the model runs (default: the current CUDA device)"},
    ])


def main(argv: Optional[Sequence[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_serve_args(argv)
    service = build_service(args, batch_size=args.batch_size, device=args.device)
    server, port = build_http_server(service, host=args.host, port=args.port)
    logging.info("serving %s (%d joints) on http://%s:%d", service.mode, service.num_joints,
                 args.host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
