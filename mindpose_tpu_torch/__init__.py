"""mindpose_tpu_torch: the PyTorch/CUDA port of mindpose_tpu for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference, and imports
neither JAX nor ``mindpose_tpu``. Models are NCHW; every TPU kernel on a
ported path is a hand-written CUDA kernel (``csrc/``) with a plain PyTorch
version beside it. Ported so far: the top-down HRNet serving path, the
single-device top-down train step (``parallel.build_train_step``), and the
conv-chain probe's kernel (``tools/ablate_conv_chain.py``).
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
