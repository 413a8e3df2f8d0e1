"""Serving API: raw image + person boxes -> keypoints.

Counterpart of ``mindpose_tpu/engine/predictor.py:TopDownPredictor``, with
the same call: ``predictor(image HWC uint8 RGB, boxes xywh [M, 4],
box_scores) -> [M, K, 3]`` in the original image frame. The host computes
each box's center/scale and warp matrix in numpy; the device does the rest:
the crop (a bilinear warp by gather, ``ops/image.affine_warp``, in place of
the JAX predictor's cv2.warpAffine), normalization, the forward pass and the
decode, whose argmax+shift is the hand-written kernel on a CUDA device.
"""
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.transform.topdown_transform import box_to_center_scale, crop_matrix
from ..models.model_factory import (
    create_decoder,
    create_eval_network,
    create_network_from_config,
)
from ..ops.image import affine_warp, normalize_image

__all__ = ["TopDownPredictor"]


class TopDownPredictor:
    """Single-image multi-instance top-down predictor.

    Args:
        net: the port's ``Net``, with its weights loaded; it is moved to
            ``device`` and put in eval mode.
        dataset_setting: the config's dataset_setting dict (image_size,
            heatmap_size, pixel_std, scale_padding, ...).
        decoder_setting: decoder kwargs (use_udp, shift_coordinate, ...).
        batch_size: boxes go through the model in chunks of at most this
            many. A partial chunk is not padded: the JAX predictor pads it so
            that XLA never recompiles, and eval-mode rows are independent, so
            padding would change nothing here but the work done.
        quantize: only "" (float32); "int8" is refused (not ported yet),
            any other value is an error, as in the JAX predictor.
        device: where crop, forward and decode run. Default: the current
            CUDA device; without CUDA the default raises, and a caller who
            wants the CPU passes ``device="cpu"``.

    The predictor serves in full float32, as the configs state. PyTorch lets
    cuDNN run float32 convolutions in TF32 by default, so on a CUDA device
    every call turns TF32 off for cuDNN and CUDA matmuls; these are
    process-wide PyTorch flags, and the predictor leaves them off.
    """

    def __init__(
        self,
        net: torch.nn.Module,
        dataset_setting: Dict[str, Any],
        decoder_setting: Optional[Dict[str, Any]] = None,
        normalize_mean=(0.485, 0.456, 0.406),
        normalize_std=(0.229, 0.224, 0.225),
        batch_size: int = 32,
        decoder_name: str = "topdown_heatmap",
        quantize: str = "",
        device: Optional[torch.device] = None,
    ) -> None:
        if quantize == "int8":
            raise NotImplementedError(
                "int8 weights are not ported (ROADMAP.md, Queue 1, the rest: int8)")
        if quantize:
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("TopDownPredictor serves on the GPU by default, and CUDA is "
                                   "not available; pass device='cpu' to serve on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.mean = tuple(normalize_mean)
        self.std = tuple(normalize_std)
        self.image_size = tuple(int(v) for v in dataset_setting["image_size"])  # (W, H)
        self.pixel_std = float(dataset_setting["pixel_std"])
        self.scale_padding = float(dataset_setting["scale_padding"])
        decoder_setting = dict(decoder_setting or {})
        self.use_udp = bool(decoder_setting.get("use_udp", False))
        decoder = create_decoder(decoder_name, **decoder_setting)
        self._eval_net = create_eval_network(net.to(self.device), decoder, output_raw=False)

    @classmethod
    def from_config(cls, args: Any, net_state: Mapping[str, torch.Tensor],
                    **kwargs: Any) -> "TopDownPredictor":
        """Build from a parsed config namespace and the net's weights.

        The net is the one the config names (``backbone_name``,
        ``head_name``, ``backbone_setting``, ``head_setting``, ...);
        ``net_state`` loads into it strictly (the net is built without
        initializing its weights, which ``net_state`` overwrites all). The
        config's dataset, decoder and normalization settings pass through;
        ``kwargs`` (``batch_size``, ``quantize``, ``device``) go to the
        constructor.
        """
        with torch.device("meta"):
            net = create_network_from_config(args)
        net = net.to_empty(device="cpu")
        net.load_state_dict(net_state, strict=True)
        return cls(
            net,
            dataset_setting=args.dataset_setting,
            decoder_setting=getattr(args, "decoder_setting", None),
            normalize_mean=args.normalize_mean,
            normalize_std=args.normalize_std,
            decoder_name=getattr(args, "decoder_name", "topdown_heatmap") or "topdown_heatmap",
            **kwargs,
        )

    @property
    def net(self) -> torch.nn.Module:
        """The served net (eval mode, on ``self.device``)."""
        return self._eval_net.net

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    @torch.inference_mode()
    def preprocess(
        self, image: np.ndarray, boxes: np.ndarray
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Crop and normalize every box on the device.

        Returns (crops [M, 3, H, W] float32, centers [M, 2], scales [M, 2]),
        all on ``self.device``.
        """
        image = np.asarray(image)
        if image.ndim != 3 or image.dtype != np.uint8:
            raise ValueError(f"want an HWC uint8 image, got {image.dtype} {image.shape}")
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        if len(boxes) == 0:
            raise ValueError("need at least one box")

        centers, scales, mats = [], [], []
        for box in boxes:
            center, scale = box_to_center_scale(
                box, self.image_size, self.pixel_std, self.scale_padding)
            mats.append(crop_matrix(center, scale, self.image_size, self.pixel_std, self.use_udp))
            centers.append(center)
            scales.append(scale)

        ow, oh = self.image_size
        img = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
        crops = affine_warp(img.expand(len(boxes), *img.shape), self._upload(np.stack(mats)),
                            (oh, ow))
        crops = normalize_image(crops, self.mean, self.std)
        x = crops.permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW, once
        return x, self._upload(np.stack(centers)), self._upload(np.stack(scales))

    @torch.inference_mode()
    def __call__(
        self, image: np.ndarray, boxes: np.ndarray, box_scores=None
    ) -> np.ndarray:
        """Predict keypoints for each xywh box in an RGB uint8 image.

        Returns [M, K, 3] (x, y, score) in the original image frame.
        """
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        x, centers, scales = self.preprocess(image, boxes)
        m = x.shape[0]
        if box_scores is None:
            box_scores = np.ones(m, np.float32)
        scores = self._upload(np.asarray(box_scores, np.float32).reshape(m))
        preds = []
        for i in range(0, m, self.batch_size):
            chunk = slice(i, min(i + self.batch_size, m))
            preds.append(self._eval_net(x[chunk], centers[chunk], scales[chunk], scores[chunk])[0])
        return torch.cat(preds).cpu().numpy()
