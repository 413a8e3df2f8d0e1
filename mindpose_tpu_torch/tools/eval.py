"""Evaluation CLI: checkpoint -> COCO keypoint AP, on the GPU.

Counterpart of ``tools/eval.py`` (:36-132): the val dataset and loader, the
network with the checkpoint's weights, the inferencer (TTA as the config
says) and the evaluator (COCO AP), top-down (rescoring, OKS-NMS) or
bottom-up (``pipeline_method: bottomup``: whole images, tag grouping; on
the GPU the grouping kernel unless ``device_grouping`` is false). The
checkpoint is the port's own (``utils/checkpoint.save_checkpoint``) or the
JAX package's flax msgpack file. ``amp_level`` other than O0 runs the
forward in bf16 autocast, as the JAX tool evaluates in bf16; O0 runs it in
float32. The 10 COCO stats go to ``result_path`` (default
``./result.json``), as the JAX tool writes them.

Usage:
    python3 -m mindpose_tpu_torch.tools.eval --config configs/hrnet/hrnet_w32_tpu.yaml \\
        --ckpt ckpt/last.pt [--device cpu] [--cfg-options val_root=... val_label=...]
    python3 -m mindpose_tpu_torch.tools.eval \\
        --config configs/higher_hrnet/higher_hrnet_w32_tpu.yaml --ckpt <file> ...
"""
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from ..config import parse_args
from ..data import create_dataset, create_pipeline
from ..engine import create_evaluator, create_inferencer
from ..models import create_decoder, create_eval_network, create_network_from_config
from ..utils.checkpoint import load_net_state_dict

__all__ = ["evaluate"]


def evaluate(args: Any, device: Optional[torch.device] = None,
             timings: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Evaluate ``args.ckpt`` as the config ``args`` says; returns the COCO stats.

    ``device``: where the net runs; default the current CUDA device, and
    without CUDA it raises (pass ``"cpu"`` to evaluate on the CPU). Given a
    dict, ``timings`` receives the wall seconds of the inferencer
    (``infer_s``, loading included) and of the evaluator (``eval_s``), and
    the ``records`` and ``batches`` inferred.
    """
    dataset_val = create_dataset(
        args.val_root,
        args.val_label,
        dataset_format=args.dataset_format,
        is_train=False,
        use_gt_bbox_for_val=getattr(args, "val_use_gt_bbox", True),
        detection_file=getattr(args, "val_detection_result", None),
        num_workers=getattr(args, "num_parallel_workers", 4),
        config=args.dataset_setting,
    )
    loader_val = create_pipeline(
        dataset_val,
        transforms=args.val_transforms,
        method=args.pipeline_method,
        batch_size=args.batch_size,
        is_train=False,
        normalize_mean=args.normalize_mean,
        normalize_std=args.normalize_std,
        num_workers=getattr(args, "num_parallel_workers", 4),
        config=args.dataset_setting,
        decode_cache_mb=getattr(args, "decode_cache_mb", 0) or 0,
    )

    net = create_network_from_config(args)
    if not getattr(args, "ckpt", None):
        raise ValueError("--ckpt is required for evaluation")
    net.load_state_dict(load_net_state_dict(args.ckpt, net), strict=True)

    decoder = create_decoder(
        args.decoder_name, **(getattr(args, "decoder_setting", None) or {})
    )
    eval_net = create_eval_network(
        net, decoder, output_raw=args.eval_setting.get("has_heatmap_output", True)
    )
    inferencer = create_inferencer(
        eval_net,
        name=args.inference_method,
        config=args.eval_setting,
        dataset_config=args.dataset_setting,
        device=device,
        amp_level=getattr(args, "amp_level", "O0") or "O0",
    )
    result_path = getattr(args, "result_path", "./result.json")
    evaluator = create_evaluator(
        args.val_label,
        name=args.eval_method,
        metric=args.eval_metric,
        config=args.eval_setting,
        dataset_config=args.dataset_setting,
        num_joints=args.num_joints,
        result_path=os.path.join(os.path.dirname(os.path.abspath(result_path)),
                                 "result_keypoints.json"),
    )

    start = time.perf_counter()
    outputs = inferencer(loader_val)
    infer_s = time.perf_counter() - start
    start = time.perf_counter()
    result = evaluator(outputs)
    eval_s = time.perf_counter() - start
    logging.info("evaluation result: %s", result)
    logging.info("%d records in %d batches: inferencer %.3f s, evaluator %.3f s",
                 len(outputs), len(loader_val), infer_s, eval_s)
    if timings is not None:
        timings.update(infer_s=infer_s, eval_s=eval_s, records=len(outputs),
                       batches=len(loader_val))

    with open(result_path, "w") as f:
        json.dump({k: float(v) for k, v in result.items()}, f, indent=4)
    logging.info("result saved to %s", result_path)
    return result


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(description="mindpose_tpu_torch evaluation", extra_args=[
        {"names": ["--device"], "default": None,
         "help": "where the net runs (default: the current CUDA device)"}])
    evaluate(args, device=args.device)


if __name__ == "__main__":
    main()
