"""Temporal keypoint smoothing for video inference: the One-Euro filter.

A copy of ``mindpose_tpu/utils/smoothing.py`` (numpy; the port cannot
import the JAX package), pinned to it by ``tests/test_torch_host_copies.py``.
One-Euro (Casiez et al., CHI 2012) is the standard pose-tracking smoother:
an adaptive low-pass whose cutoff rises with speed — strong jitter removal
when still, low lag when moving. Vectorized over an arbitrary keypoint array
shape; state is carried per element.
"""
from typing import Optional

import numpy as np

__all__ = ["OneEuroFilter"]


def _alpha(cutoff: np.ndarray, dt: float) -> np.ndarray:
    """Low-pass smoothing factor for a given cutoff frequency (Hz)."""
    tau = 1.0 / (2.0 * np.pi * cutoff)
    return 1.0 / (1.0 + tau / dt)


class OneEuroFilter:
    """Smooth a stream of keypoint arrays (e.g. [K, 2] or [M, K, 2]).

    Args:
        freq: nominal sampling rate in Hz (video fps).
        min_cutoff: baseline cutoff (Hz); lower = smoother when still.
        beta: speed coefficient; higher = less lag when moving.
        d_cutoff: cutoff for the derivative low-pass.
    """

    def __init__(
        self,
        freq: float = 30.0,
        min_cutoff: float = 1.0,
        beta: float = 0.007,
        d_cutoff: float = 1.0,
    ) -> None:
        if freq <= 0:
            raise ValueError("freq must be positive")
        self.freq = float(freq)
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self._x_prev: Optional[np.ndarray] = None
        self._dx_prev: Optional[np.ndarray] = None

    def reset(self) -> None:
        """Forget history (e.g. on scene cut or person re-acquisition)."""
        self._x_prev = None
        self._dx_prev = None

    def __call__(self, x: np.ndarray, dt: Optional[float] = None) -> np.ndarray:
        """Filter one frame; ``dt`` overrides 1/freq (irregular streams)."""
        x = np.asarray(x, np.float64)
        dt = 1.0 / self.freq if dt is None else float(dt)

        if self._x_prev is None or self._x_prev.shape != x.shape:
            # first frame (or instance count changed): pass through
            self._x_prev = x
            self._dx_prev = np.zeros_like(x)
            return x.copy()

        dx = (x - self._x_prev) / dt
        a_d = _alpha(np.full_like(x, self.d_cutoff), dt)
        dx_hat = a_d * dx + (1.0 - a_d) * self._dx_prev

        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _alpha(cutoff, dt)
        x_hat = a * x + (1.0 - a) * self._x_prev

        self._x_prev = x_hat
        self._dx_prev = dx_hat
        return x_hat
