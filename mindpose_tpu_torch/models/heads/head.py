"""Head interface (counterpart of mindpose_tpu/models/heads/head.py)."""
import torch
from torch import nn


class Head(nn.Module):
    """Abstract head: maps NCHW backbone features to heatmap outputs."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("Head must implement forward.")
