"""Profiling helpers over ``torch.profiler``.

Counterpart of ``mindpose_tpu/utils/profiler.py``: ``trace`` records the
enclosed block and writes a Chrome trace (``*.pt.trace.json``, which
TensorBoard's profiler plugin and chrome://tracing read) under its log
directory; ``annotate`` and ``StepTraceContext`` name a region and a train
step in it. The train entry wires them in with ``--cfg-options profile=True
[profile_dir=...]`` and traces epoch 2 only (the first holds cuDNN's
autotuning), as the JAX entry does. On a CUDA device the trace holds the
CPU's operations and the device's kernels; on the CPU, the CPU's alone.
"""
import contextlib
import logging
from typing import Iterator, Optional

import torch

__all__ = ["trace", "annotate", "StepTraceContext"]


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True,
          device: Optional[torch.device] = None) -> Iterator[None]:
    """Trace the enclosed block into ``log_dir`` (nothing when disabled).

    CUDA activity is recorded when ``device`` is a CUDA device, or, without
    ``device``, when CUDA is available."""
    if not enabled or not log_dir:
        yield
        return
    cuda = (torch.device(device).type == "cuda" if device is not None
            else torch.cuda.is_available())
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logging.info("profiler trace -> %s", log_dir)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
    logging.info("profiler trace done")


def annotate(name: str):
    """A named region of the trace: ``with annotate("decode"):``."""
    return torch.profiler.record_function(name)


class StepTraceContext:
    """A train step's region of the trace: ``with StepTraceContext("train", step):``."""

    def __init__(self, name: str, step: int) -> None:
        self._ctx = torch.profiler.record_function(f"{name} step {step}")

    def __enter__(self):
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)
