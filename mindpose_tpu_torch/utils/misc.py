"""Metric averaging, the cross-process mean and the throughput meter.

Counterpart of ``mindpose_tpu/utils/misc.py``: ``AverageMeter`` (a copy),
``allreduce_mean`` (the mean across the ranks of the process group;
identity on one process) and
``StepTimer``, which also keeps each step's wait on the loader and its
time, so that a run can say whether the host or the step sets its pace.
"""
import statistics
import time
from typing import List, Optional

import numpy as np

__all__ = ["AverageMeter", "allreduce_mean", "StepTimer"]


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def allreduce_mean(value: np.ndarray) -> np.ndarray:
    """Mean across the ranks of the process group: the value itself on one
    process. A collective: every rank calls it. The host-side mean for logs;
    the train step averages its own tensors."""
    import torch
    import torch.distributed as dist

    value = np.asarray(value)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return value
    # nccl reduces device tensors only
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    total = torch.from_numpy(value.astype(np.float64)).to(device)
    dist.all_reduce(total)
    mean = (total / dist.get_world_size()).cpu().numpy()
    return mean.astype(value.dtype) if np.issubdtype(value.dtype, np.floating) else mean


class StepTimer:
    """Throughput meter over a loop's steps, on the host clock.

    ``start`` before the loop asks for a batch, ``loaded`` when it has one,
    ``stop(n)`` after the step on ``n`` images has been issued. The device
    runs behind the host, so a step's time is its issue time, which the
    device's queue holds to the device's pace once that queue is full.
    """

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self._t_loaded: Optional[float] = None
        self._images = 0
        self._steps = 0
        self._elapsed = 0.0
        self.waits: List[float] = []  # seconds each step waited on the loader
        self.step_times: List[float] = []  # seconds from batch in hand to stop

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._t_loaded = None

    def loaded(self) -> None:
        assert self._t0 is not None
        self._t_loaded = time.perf_counter()
        self.waits.append(self._t_loaded - self._t0)

    def stop(self, num_images: int) -> None:
        assert self._t0 is not None
        now = time.perf_counter()
        self._elapsed += now - self._t0
        if self._t_loaded is not None:
            self.step_times.append(now - self._t_loaded)
        self._images += num_images
        self._steps += 1
        self._t0 = None

    @property
    def images_per_sec(self) -> float:
        return self._images / self._elapsed if self._elapsed else 0.0

    def summary(self) -> dict:
        """Steps, images, img/s, and the median step time and median and total wait (s)."""
        return {
            "steps": self._steps,
            "images": self._images,
            "images_per_sec": self.images_per_sec,
            "step_median_s": statistics.median(self.step_times) if self.step_times else 0.0,
            "wait_median_s": statistics.median(self.waits) if self.waits else 0.0,
            "wait_total_s": sum(self.waits),
        }
