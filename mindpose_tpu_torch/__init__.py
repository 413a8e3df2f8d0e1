"""mindpose_tpu_torch: the PyTorch/CUDA port of mindpose_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference, and imports
neither JAX nor ``mindpose_tpu``. Models are NCHW; every TPU kernel on a
ported path is a hand-written CUDA kernel (``csrc/*.cu``) with a plain
PyTorch version beside it, and the host C++ of evaluation
(``csrc/coco_native.cpp``) is built with ``g++``. It does what the JAX
package does: every recipe under ``configs/`` (HRNet, SimpleBaseline, UDP
and DARK-UDP, ViTPose, SimCC, RLE, MPII, bottom-up HigherHRNet) trains on
one card, in data-parallel or sharded ranks, with distillation and remat;
evaluates (COCO OKS AP, MPII's PCKh); and serves over HTTP, in float32 or
with int8 weights, or from a ``torch.export`` artifact. Its command lines
are ``python3 -m mindpose_tpu_torch.tools.<name>``: train, eval, serve,
export, demo, demo_video, convert_ckpt, the visualisation tools, the data
tools and the pod launcher, the conv-chain probe (``ablate_pallas_chain``),
and the experiment and ablation tools (``ablate_accuracy``,
``exp_grouping``, ``exp_warmstart``, ``ablate_step``, ``profile_parts``,
``ablate_bottomup``, ``ablate_bu_*``, ``ablate_conv_*``,
``ablate_s2d_head``, ``probe_layout``).
"""
from . import engine, models  # noqa: F401
from .engine import PoseService, TopDownPredictor, build_http_server  # noqa: F401
from .models import (  # noqa: F401
    create_backbone,
    create_decoder,
    create_eval_network,
    create_head,
    create_loss,
    create_network,
    create_network_with_loss,
)
from .register import entrypoint, list_components, list_modules, register  # noqa: F401
from .version import __version__  # noqa: F401
