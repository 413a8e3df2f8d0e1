"""Teacher-in-the-loop knowledge distillation.

Counterpart of mindpose_tpu/models/distill.py. The frozen teacher runs in
the train step's ``preprocess`` (parallel/train.py), after the base
preprocess: it takes column 0, the normalized NCHW image the student sees,
and appends its heatmaps as the last column, which ``joint_mse_distill``
(models/loss/distill.py) takes as its extra input. The preprocess runs
outside the step's autocast, so the teacher runs in float32, as JAX's
teacher is built without a dtype. Each rank holds a whole teacher, never
wrapped by DDP or FSDP, as JAX captures its variables as a replicated
constant.

Config (tools/train.py):

    loss: joint_mse_distill
    loss_setting: {use_target_weight: true, alpha: 0.5}
    distill_setting:
      teacher_backbone: hrnet_w48
      teacher_head: hrnet_head
      teacher_backbone_setting: {}
      teacher_head_setting: {}
      teacher_ckpt: ckpt/hrnet_w48_tpu_best.ckpt
"""
from typing import Any, Callable, Dict, Optional

import torch

from ..utils.checkpoint import load_net_state_dict
from .model_factory import create_network
from .networks import Net

__all__ = ["build_teacher", "build_teacher_preprocess"]


def build_teacher(distill_setting: Dict[str, Any], num_joints: int, in_channels: int = 3,
                  device: Any = "cpu") -> Net:
    """The frozen teacher net, in eval mode on ``device``, from a distill_setting.

    ``teacher_ckpt`` is a JAX package checkpoint (a flax msgpack TrainState
    or a bare variables tree, as ``load_variables`` reads them) or a port
    checkpoint; it loads strictly.
    """
    ckpt = distill_setting.get("teacher_ckpt")
    if not ckpt:
        raise ValueError("distill_setting.teacher_ckpt is required")
    net = create_network(
        backbone_name=distill_setting["teacher_backbone"],
        head_name=distill_setting["teacher_head"],
        neck_name=distill_setting.get("teacher_neck", "") or "",
        num_joints=num_joints, in_channels=in_channels,
        backbone_args=distill_setting.get("teacher_backbone_setting"),
        head_args=distill_setting.get("teacher_head_setting"))
    net.load_state_dict(load_net_state_dict(ckpt, net), strict=True)
    net.requires_grad_(False)
    return net.to(device).eval()


def build_teacher_preprocess(teacher: torch.nn.Module,
                             base_preprocess: Optional[Callable] = None) -> Callable:
    """Wrap ``base_preprocess`` so that it appends the teacher's heatmaps.

    Columns in: the loader's (or ``base_preprocess``'s) (image, target,
    target_weight, ...), the image NCHW; out: the same with the teacher's
    output of column 0 last, computed without gradients in the teacher's
    dtype, to which the image is cast, as a flax module casts its input.
    """
    dtype = next(teacher.parameters()).dtype

    def preprocess(*cols):
        if base_preprocess is not None:
            cols = base_preprocess(*cols)
        with torch.no_grad():
            teacher_out = teacher(cols[0].to(dtype))
        return tuple(cols) + (teacher_out,)

    return preprocess
