"""Train-time evaluation callback: val-while-train, best/last checkpoints,
metric logging.

Counterpart of ``mindpose_tpu/callbacks/eval_callback.py:24-177``:
per-epoch loss and lr logging (the epoch's loss averaged over the ranks),
inference and evaluation every ``interval`` epochs and at the last one,
the best-by-target-metric and the last checkpoints (the port's
``torch.save`` format, under the JAX package's names), a ``.ema`` file
beside each when the run keeps averaged weights (evaluation then runs on
them), and ``metrics.jsonl``. The loss vectors stay on the device through
the epoch and are read once at its end, as the JAX callback holds its
device arrays.

In a data-parallel run rank 0 alone evaluates, writes the checkpoints and
``metrics.jsonl``; it evaluates the unwrapped net it is given (the
inferencer's), never through DDP's forward on one rank. Every rank then
waits at a barrier, so that the others wait for rank 0's evaluation there
rather than time out in the next step's collective.

A sharded net (``parallel_mode: fsdp``) cannot run on rank 0 alone: its
forward all-gathers from ranks that wait at the barrier. So every rank
first gathers the whole net, optimizer and EMA state
(``parallel/fsdp.full_state``, as the JAX callback calls
``replicate_sharded`` before its rank gate, :128-139); rank 0 loads it into
``eval_net``, an unsharded copy of the net that its inferencer holds (the
other ranks hold neither), evaluates that (the EMA swapped into it), and
writes the checkpoints from the gathered dicts: the same files a
single-device run writes.
"""
import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.fsdp import full_state, is_sharded
from ..parallel.mesh import is_distributed, is_main_process
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
        rank_id: Optional[int] = None,
        device_num: Optional[int] = None,
        async_checkpoint: bool = False,
        eval_net: Optional[torch.nn.Module] = None,
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
        self.eval_net = eval_net  # the unsharded copy a sharded run evaluates
        self.rank_id = rank_id if rank_id is not None else 0
        self.device_num = device_num or 1

        self.best_metric = -np.inf
        self.loss_meter = AverageMeter()
        self._epoch_start = 0.0
        self._loss_vectors = []
        self._metrics_file = None
        if self._is_rank0():
            os.makedirs(summary_dir, exist_ok=True)
            self._metrics_file = os.path.join(summary_dir, "metrics.jsonl")

    def _is_rank0(self) -> bool:
        return self.rank_id == 0 and is_main_process()

    def _write_summary(self, record: Dict[str, Any]) -> None:
        if self._metrics_file:
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
        write a ``<path>.ema`` file with ``{"params": ema}``. A sharded
        ``net`` is gathered first, on every rank, and evaluated through
        ``eval_net``.
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
        # the same on every rank (each builds the val loader); a sharded run
        # builds the inferencer and the evaluator on rank 0 only
        eval_due = self.dataset_val is not None and (
            epoch % self.interval == 0 or epoch == self.max_epoch)
        run_eval = eval_due and self.inferencer is not None and self.evaluator is not None
        eval_net = net
        if is_sharded(net) and (self.save_last or eval_due):
            # a collective: every rank gathers, rank 0 alone receives
            net, optimizer, ema_params = full_state(net, optimizer, ema_params)
            eval_net = self.eval_net
            if self._is_rank0() and run_eval:
                eval_net.load_state_dict(net)
        if self._is_rank0():
            if self.save_last:
                self._save(self.last_ckpt_path, net, optimizer, step, ema_params)
            if run_eval:
                with _parameters_swapped(eval_net, ema_params):
                    outputs = self.inferencer(self.dataset_val)
                metrics = self.evaluator(outputs)
                for name, value in metrics.items():
                    record[f"val/{name}"] = float(value)
                target = float(metrics[self.target_metric_name])
                logging.info("epoch: [%d/%d], %s%s: %.4f", epoch, self.max_epoch,
                             self.target_metric_name,
                             " (EMA)" if ema_params is not None else "", target)
                if self.save_best and self._metric_sign * target > self.best_metric:
                    self.best_metric = self._metric_sign * target
                    self._save(self.best_ckpt_path, net, optimizer, step, ema_params)
                    logging.info("best %s = %.4f, checkpoint saved.", self.target_metric_name,
                                 target)
            self._write_summary(record)
        if is_distributed():
            dist.barrier()  # the other ranks wait here for rank 0's evaluation
        return metrics
