"""Model factories: create_* entry points resolving registry names.

Counterpart of mindpose_tpu/models/model_factory.py for what the top-down
path uses. The factory wires ``backbone.out_channels`` into the
head's input width. Necks are not ported yet.
"""
from typing import Any, Dict, Optional

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
    head = create_head(head_name, in_channels=backbone.out_channels,
                       num_joints=num_joints, **dict(head_args or {}))
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
