"""Learning-rate schedules: step -> lr functions.

Counterpart of mindpose_tpu/scheduler/schedulers.py, with the same float32
arithmetic: linear warmup from 0, then cosine decay to ``min_lr`` or
per-epoch milestone decay (at step ``(milestone - 1) * steps_per_epoch``,
like the reference's precomputed table). A schedule returns a Python float
(the float32 value, exactly). The train step evaluates it at the number of
optimizer steps taken *before* the current one, as optax does, so under
warmup the first step's learning rate is ``schedule(0) = 0``.
"""
import math
from typing import Callable, List, Union

import torch

from ..register import entrypoint, register

__all__ = ["warmup_cosine_decay", "warmup_multi_step_decay", "create_lr_scheduler"]

Schedule = Callable[[int], float]


def _resolve_warmup(warmup: Union[int, float], total_steps: int) -> int:
    if isinstance(warmup, float) and not warmup.is_integer():
        steps = int(warmup * total_steps)
    else:
        steps = int(warmup)
    if steps > total_steps:
        raise ValueError("Warmup steps must be smaller than total steps")
    return steps


def _f32(value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32)


def _warm(lr: float, step: torch.Tensor, warmup_steps: int) -> torch.Tensor:
    return _f32(lr) * torch.clamp_max(step / _f32(max(warmup_steps, 1)), 1.0)


@register("lr_scheduler", extra_name="warmup_cosine_decay")
def warmup_cosine_decay(
    lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    warmup: Union[int, float] = 0,
    min_lr: float = 0.0,
    **kwargs,
) -> Schedule:
    total_steps = total_epochs * steps_per_epoch
    warmup_steps = _resolve_warmup(warmup, total_steps)
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        s = _f32(step)
        t = torch.clamp((s - warmup_steps) / _f32(decay_steps), 0.0, 1.0)
        cos = _f32(min_lr) + _f32(0.5 * (lr - min_lr)) * (1.0 + torch.cos(_f32(math.pi) * t))
        out = _warm(lr, s, warmup_steps) if step < warmup_steps else cos
        return float(torch.clamp_min(out, _f32(min_lr)))

    return schedule


@register("lr_scheduler", extra_name="warmup_multi_step_decay")
def warmup_multi_step_decay(
    lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    milestones: List[int],
    decay_rate: float = 0.1,
    warmup: Union[int, float] = 0,
    **kwargs,
) -> Schedule:
    total_steps = total_epochs * steps_per_epoch
    warmup_steps = _resolve_warmup(warmup, total_steps)
    boundaries = _f32([(m - 1) * steps_per_epoch for m in milestones])

    def schedule(step: int) -> float:
        s = _f32(step)
        if step < warmup_steps:
            return float(_warm(lr, s, warmup_steps))
        num_decays = (s >= boundaries).sum().float()
        return float(_f32(lr) * torch.pow(_f32(decay_rate), num_decays))

    return schedule


def create_lr_scheduler(
    name: str,
    lr: float,
    total_epochs: int,
    steps_per_epoch: int,
    warmup: Union[int, float] = 0,
    **kwargs,
) -> Schedule:
    return entrypoint("lr_scheduler", name)(
        lr=lr,
        total_epochs=total_epochs,
        steps_per_epoch=steps_per_epoch,
        warmup=warmup,
        **kwargs,
    )
