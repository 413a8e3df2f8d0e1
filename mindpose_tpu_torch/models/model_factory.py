"""Model factories: create_* entry points resolving registry names.

Counterpart of mindpose_tpu/models/model_factory.py for what the top-down
path uses. The factory wires ``backbone.out_channels`` into the
head's input width, and, for a head whose Linear layers take the flattened
map (``needs_feature_size``: ``simcc_head``), the backbone's output size at
the head's ``input_size``, traced on the meta device. Necks are not ported yet.
"""
import inspect
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..register import entrypoint
from .networks import EvalNet, Net, NetWithLoss

__all__ = [
    "create_backbone",
    "create_head",
    "create_decoder",
    "create_loss",
    "create_network",
    "create_network_from_config",
    "create_eval_network",
    "create_network_with_loss",
    "feature_size",
]


def create_backbone(name: str, pretrained: bool = False, ckpt_url: str = "",
                    in_channels: int = 3, **kwargs: Any):
    """Create a backbone module by registry name."""
    return entrypoint("backbone", name)(
        pretrained=pretrained, ckpt_url=ckpt_url, in_channels=in_channels, **kwargs
    )


def create_head(name: str, in_channels: int, num_joints: int = 17, **kwargs: Any):
    return entrypoint("head", name)(in_channels=in_channels, num_joints=num_joints, **kwargs)


def create_decoder(name: str, **kwargs: Any):
    return entrypoint("decoder", name)(**kwargs)


def create_loss(name: str, **kwargs: Any):
    return entrypoint("loss", name)(**kwargs)


def feature_size(backbone: nn.Module, in_channels: int,
                 input_size: Sequence[int]) -> Tuple[int, int]:
    """(h, w) of ``backbone``'s output for an input of ``input_size`` (W, H),
    from a forward on the meta device: no arithmetic runs and the backbone's
    own tensors are neither read nor changed."""
    w, h = int(input_size[0]), int(input_size[1])
    tensors = {name: torch.empty_like(t, device="meta") for name, t in
               [*backbone.named_parameters(), *backbone.named_buffers()]}
    x = torch.empty(1, in_channels, h, w, device="meta")
    with torch.no_grad():
        out = torch.func.functional_call(backbone, tensors, (x,))
    return int(out.shape[2]), int(out.shape[3])


def create_network(
    backbone_name: str,
    head_name: str,
    neck_name: str = "",
    backbone_pretrained: bool = False,
    backbone_ckpt_url: str = "",
    in_channels: int = 3,
    num_joints: int = 17,
    backbone_args: Optional[Dict[str, Any]] = None,
    head_args: Optional[Dict[str, Any]] = None,
) -> Net:
    """Create the network (float32; weights come from a state_dict)."""
    if neck_name:
        raise NotImplementedError(f"necks are not ported yet (got {neck_name!r})")
    backbone = create_backbone(
        backbone_name,
        pretrained=backbone_pretrained,
        ckpt_url=backbone_ckpt_url,
        in_channels=in_channels,
        **dict(backbone_args or {}),
    )
    head_args = dict(head_args or {})
    head_fn = entrypoint("head", head_name)
    if getattr(head_fn, "needs_feature_size", False):
        input_size = head_args.get(
            "input_size", inspect.signature(head_fn).parameters["input_size"].default)
        head_args.setdefault("feature_size", feature_size(backbone, in_channels, input_size))
    head = create_head(head_name, in_channels=backbone.out_channels,
                       num_joints=num_joints, **head_args)
    return Net(backbone=backbone, head=head)


def create_network_from_config(args: Any) -> Net:
    """The network a parsed config names: ``backbone_name``, ``head_name``,
    ``neck_name``, ``in_channels``, ``num_joints``, ``backbone_setting`` and
    ``head_setting``, with the module's own initial weights."""
    return create_network(
        backbone_name=args.backbone_name,
        head_name=args.head_name,
        neck_name=getattr(args, "neck_name", "") or "",
        in_channels=getattr(args, "in_channels", 3),
        num_joints=args.num_joints,
        backbone_args=getattr(args, "backbone_setting", None),
        head_args=getattr(args, "head_setting", None),
    )


def create_eval_network(net: Net, decoder: Any, output_raw: bool = True) -> EvalNet:
    return EvalNet(net=net, decoder=decoder, output_raw=output_raw)


def create_network_with_loss(net: Net, loss: Any, has_extra_inputs: bool = False) -> NetWithLoss:
    return NetWithLoss(net=net, loss=loss, has_extra_inputs=has_extra_inputs)
