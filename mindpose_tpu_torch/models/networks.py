"""Network composition: Net and EvalNet.

Counterpart of mindpose_tpu/models/networks.py. ``Net`` (backbone -> neck?
-> head) owns the parameters; ``EvalNet`` runs it in eval mode and decodes.
``NetWithLoss`` is not ported yet (training comes in a later slice).
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
