"""Inferencer base: an ``EvalNet`` run over the batches of a loader.

Counterpart of ``mindpose_tpu/engine/inferencer/inferencer.py``. The net
holds its weights, so the port's inferencer takes no variables. It runs on
one device: the JAX package's mesh and its padding of ragged batches serve
XLA's static shapes and many TPU chips, and are dropped.

``amp_level`` sets the precision of the forward, as the eval tool of the
JAX package does (bf16 unless O0): under O1-O3 the net runs in
``torch.autocast(bfloat16)``, as the port's train step does; under O0 in
float32 with TF32 off, as the predictor serves.
"""
import contextlib
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...models.networks import EvalNet

_AMP_LEVELS = ("O0", "O1", "O2", "O3")


class Inferencer:
    def __init__(
        self,
        net: EvalNet,
        config: Optional[Dict[str, Any]] = None,
        device: Optional[torch.device] = None,
        amp_level: str = "O0",
    ) -> None:
        if amp_level not in _AMP_LEVELS:
            raise ValueError(f"amp_level must be one of {_AMP_LEVELS}, got {amp_level!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("the inferencer runs on the GPU by default, and CUDA is not "
                                   "available; pass device='cpu' to run on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.net = net
        self.net.net.to(self.device).eval()
        self.amp_level = amp_level
        self.config = config if config else dict()
        self._inference_cfg = self.load_inference_cfg()

    def precision(self):
        """The context the forward runs in (autocast bf16, or float32 without TF32)."""
        if self.amp_level != "O0":
            return torch.autocast(self.device.type, dtype=torch.bfloat16)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return contextlib.nullcontext()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host batch column as float32 on the inferencer's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def load_inference_cfg(self) -> Dict[str, Any]:
        raise NotImplementedError("Child class must implement this method.")

    def infer(self, dataset) -> List[Dict[str, Any]]:
        raise NotImplementedError("Child class must implement this method.")

    def __call__(self, dataset) -> List[Dict[str, Any]]:
        logging.info("Start inferencing...")
        result = self.infer(dataset)
        logging.info("Start inferencing...done.")
        return result
