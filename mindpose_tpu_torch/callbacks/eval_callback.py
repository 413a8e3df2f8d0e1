"""Train-time evaluation callback: val-while-train, best/last checkpoints,
metric logging.

Counterpart of ``mindpose_tpu/callbacks/eval_callback.py:24-177`` on one
process: per-epoch loss and lr logging, inference and evaluation every
``interval`` epochs and at the last one, the best-by-target-metric and the
last checkpoints (the port's ``torch.save`` format, under the JAX
package's names), a ``.ema`` file beside each when the run keeps averaged
weights (evaluation then runs on them), and ``metrics.jsonl``. The loss
vectors stay on the device through the epoch and are read once at its end,
as the JAX callback holds its device arrays. The rank and device count of
a multi-process run come with DDP.
"""
import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils.checkpoint import save_checkpoint, save_ema
from ..utils.misc import AverageMeter, allreduce_mean

__all__ = ["EvalCallback"]


@contextlib.contextmanager
def _parameters_swapped(net: torch.nn.Module, params: Optional[Dict[str, torch.Tensor]]):
    """Run the block with ``net``'s parameters set to ``params`` (if given)."""
    if params is None:
        yield
        return
    kept = {}
    with torch.no_grad():
        for name, p in net.named_parameters():
            kept[name] = p.detach().clone()
            p.copy_(params[name])
    try:
        yield
    finally:
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(kept[name])


class EvalCallback:
    """Hooks: on_epoch_begin / on_step_end / on_epoch_end(net, optimizer, step)."""

    def __init__(
        self,
        inferencer=None,
        evaluator=None,
        dataset_val=None,
        interval: int = 1,
        max_epoch: int = 1,
        save_best: bool = False,
        save_last: bool = False,
        best_ckpt_path: str = "./best.ckpt",
        last_ckpt_path: str = "./last.ckpt",
        target_metric_name: str = "AP",
        summary_dir: str = "./summary",
        async_checkpoint: bool = False,
    ) -> None:
        self.inferencer = inferencer
        self.evaluator = evaluator
        self.dataset_val = dataset_val
        self.interval = interval
        self.max_epoch = max_epoch
        self.save_best = save_best
        self.save_last = save_last
        self.best_ckpt_path = best_ckpt_path
        self.last_ckpt_path = last_ckpt_path
        self.target_metric_name = target_metric_name
        # EPE/NME are error metrics (lower is better); the rest higher-is-better
        self._metric_sign = -1.0 if target_metric_name in ("EPE", "NME") else 1.0
        self.async_checkpoint = async_checkpoint

        self.best_metric = -np.inf
        self.loss_meter = AverageMeter()
        self._epoch_start = 0.0
        self._loss_vectors = []
        os.makedirs(summary_dir, exist_ok=True)
        self._metrics_file = os.path.join(summary_dir, "metrics.jsonl")

    def _write_summary(self, record: Dict[str, Any]) -> None:
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    def on_epoch_begin(self, epoch: int) -> None:
        self.loss_meter.reset()
        self._loss_vectors = []
        self._epoch_start = time.time()

    def on_step_end(self, loss_vector: torch.Tensor) -> None:
        # keep the device tensor: reading it now would wait for the step
        self._loss_vectors.append(loss_vector)

    def _save(self, path: str, net, optimizer, step: int, ema_params) -> None:
        save_checkpoint(path, net, optimizer, step, async_write=self.async_checkpoint)
        if ema_params is not None:
            save_ema(path + ".ema", ema_params, async_write=self.async_checkpoint)

    def on_epoch_end(self, epoch: int, net: torch.nn.Module, optimizer, step: int, lr: float,
                     ema_params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, Any]:
        """Log, maybe evaluate, maybe checkpoint. Returns eval metrics (or {}).

        ``ema_params``: when given, evaluation runs on these averaged
        parameters (swapped into ``net`` for it) and best/last saves also
        write a ``<path>.ema`` file with ``{"params": ema}``.
        """
        epoch_time = time.time() - self._epoch_start
        last_loss_vector = None
        if self._loss_vectors:
            stacked = torch.stack([torch.atleast_1d(v.detach()).float()
                                   for v in self._loss_vectors]).cpu().numpy()
            last_loss_vector = stacked.mean(axis=0)
            self.loss_meter.update(float(stacked.sum(axis=1).mean()), len(stacked))
        loss_avg = float(allreduce_mean(np.asarray(self.loss_meter.avg)))
        logging.info("epoch: [%d/%d], loss: %.6f, lr: %.6f, time: %.1fs",
                     epoch, self.max_epoch, loss_avg, lr, epoch_time)

        record: Dict[str, Any] = {
            "epoch": epoch,
            "train/loss": loss_avg,
            "train/lr": float(lr),
            "train/epoch_time": epoch_time,
        }
        if last_loss_vector is not None and len(last_loss_vector) > 1:
            for i, v in enumerate(last_loss_vector):
                record[f"train/loss_{i}"] = float(v)

        metrics: Dict[str, Any] = {}
        run_eval = (
            self.inferencer is not None
            and self.evaluator is not None
            and self.dataset_val is not None
            and (epoch % self.interval == 0 or epoch == self.max_epoch)
        )
        if self.save_last:
            self._save(self.last_ckpt_path, net, optimizer, step, ema_params)
        if run_eval:
            with _parameters_swapped(net, ema_params):
                outputs = self.inferencer(self.dataset_val)
            metrics = self.evaluator(outputs)
            for name, value in metrics.items():
                record[f"val/{name}"] = float(value)
            target = float(metrics[self.target_metric_name])
            logging.info("epoch: [%d/%d], %s%s: %.4f", epoch, self.max_epoch,
                         self.target_metric_name, " (EMA)" if ema_params is not None else "",
                         target)
            if self.save_best and self._metric_sign * target > self.best_metric:
                self.best_metric = self._metric_sign * target
                self._save(self.best_ckpt_path, net, optimizer, step, ema_params)
                logging.info("best %s = %.4f, checkpoint saved.", self.target_metric_name, target)
        self._write_summary(record)
        return metrics
