"""Network composition: Net, EvalNet and NetWithLoss.

Counterpart of mindpose_tpu/models/networks.py. ``Net`` (backbone -> neck?
-> head) owns the parameters; ``EvalNet`` runs it in eval mode and decodes;
``NetWithLoss`` runs it in train mode and takes the loss.
"""
from typing import Any, Optional

import torch
from torch import nn


class Net(nn.Module):
    """backbone -> neck? -> head."""

    def __init__(self, backbone: nn.Module, head: nn.Module,
                 neck: Optional[nn.Module] = None) -> None:
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.head = head

    def forward(self, x: torch.Tensor) -> Any:
        x = self.backbone(x)
        if self.neck is not None:
            x = self.neck(x)
        return self.head(x)


class EvalNet:
    """Eval-mode forward + decode: ``evalnet(image, *decoder_inputs)``.

    Puts ``net`` in eval mode when built, as the JAX package always applies
    the net with ``train=False`` here.
    """

    def __init__(self, net: Net, decoder: Any, output_raw: bool = True) -> None:
        self.net = net.eval()
        self.decoder = decoder
        self.output_raw = output_raw

    @torch.inference_mode()
    def __call__(self, *inputs: torch.Tensor) -> Any:
        x = self.net(inputs[0])
        result = self.decoder(x, *inputs[1:])
        if self.output_raw:
            return result, x
        return result


class NetWithLoss(nn.Module):
    """Train-mode forward + loss: ``net_with_loss(data, label, *extra)``.

    Returns the loss as a 1-D vector (one entry per loss component), as the
    JAX package's train step sees it. The BatchNorm running statistics update
    in place during the forward, where the JAX package returns them.
    """

    def __init__(self, net: Net, loss: Any, has_extra_inputs: bool = False) -> None:
        super().__init__()
        self.net = net
        self.loss = loss
        self.has_extra_inputs = has_extra_inputs

    def forward(self, data: torch.Tensor, label: torch.Tensor,
                *extra_inputs: torch.Tensor) -> torch.Tensor:
        if not self.net.training:
            # EvalNet may have put the shared net in eval mode
            self.net.train()
        out = self.net(data)
        if self.has_extra_inputs:
            loss = self.loss(out, label, *extra_inputs)
        else:
            loss = self.loss(out, label)
        return torch.atleast_1d(loss)
