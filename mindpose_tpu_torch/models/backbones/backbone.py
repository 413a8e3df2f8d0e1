"""Backbone interface (counterpart of mindpose_tpu/models/backbones/backbone.py)."""
import torch
from torch import nn


class Backbone(nn.Module):
    """Abstract backbone: ``forward(x)`` maps NCHW images to one NCHW feature map."""

    @property
    def out_channels(self) -> int:
        raise NotImplementedError("Backbone must define out_channels.")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("Backbone must implement forward.")
