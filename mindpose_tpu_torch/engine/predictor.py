"""Serving API: a raw image (and, top-down, person boxes) -> keypoints.

Counterpart of ``mindpose_tpu/engine/predictor.py``, with the same calls.

``TopDownPredictor``: ``predictor(image HWC uint8 RGB, boxes xywh [M, 4],
box_scores) -> [M, K, 3]`` in the original image frame. The host computes
each box's center/scale and warp matrix in numpy; the device does the rest:
the crop (a bilinear warp by gather, ``ops/image.affine_warp``, in place of
the JAX predictor's cv2.warpAffine), normalization, the forward pass and the
decode, whose argmax+shift is the hand-written kernel on a CUDA device.
With ``quantize="int8"`` the device keeps the conv and dense weights as int8
with float32 scales and dequantizes them inside every forward
(``models/quantize.py``).

``BottomUpPredictor``: ``predictor(image) -> (preds [P, K, 3 + L], scores
[P])``, every person in the image, no boxes given: the host rescales and
pads the image (the val transforms, cv2), the device normalizes it and runs
the forward, the decode and the tag grouping (the matcher's kernel, one
launch per request), and the host maps the persons back to the original
frame.
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
from ..models.quantize import quantize_variables, quantized_eval_apply
from ..ops.image import affine_warp, normalize_image

__all__ = ["TopDownPredictor", "BottomUpPredictor"]


def _default_device(device: Optional[torch.device], who: str) -> torch.device:
    """``device``, or the current CUDA device; without CUDA the default raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who} serves on the GPU by default, and CUDA is not "
                               "available; pass device='cpu' to serve on the CPU")
        device = "cuda"
    return torch.device(device)


def _net_from_config(args: Any, net_state: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """The net the config names, built without initializing its weights, which
    ``net_state`` then overwrites all (a strict load)."""
    with torch.device("meta"):
        net = create_network_from_config(args)
    net = net.to_empty(device="cpu")
    net.load_state_dict(net_state, strict=True)
    return net


class TopDownPredictor:
    """Single-image multi-instance top-down predictor.

    Args:
        net: the port's ``Net``, with its weights loaded; it is moved to
            ``device`` and put in eval mode. With ``quantize="int8"`` its
            quantized weights are replaced by tensors on the meta device:
            the predictor serves its int8 copies of them (``qstate``).
        dataset_setting: the config's dataset_setting dict (image_size,
            heatmap_size, pixel_std, scale_padding, ...).
        decoder_setting: decoder kwargs (use_udp, shift_coordinate, ...).
        batch_size: boxes go through the model in chunks of at most this
            many. A partial chunk is not padded: the JAX predictor pads it so
            that XLA never recompiles, and eval-mode rows are independent, so
            padding would change nothing here but the work done.
        quantize: "" (float32 weights) or "int8": the net's conv and dense
            weights are quantized on the host (``models/quantize.py``, the
            JAX package's rule), only the int8 tensors and their scales
            are kept on ``device``, and every forward dequantizes them, as
            the JAX predictor's jit does. Any other value is an error, as
            in the JAX predictor.
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
        if quantize not in ("", "int8"):
            raise ValueError(f"unknown quantize mode: {quantize!r}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.device = _default_device(device, "TopDownPredictor")
        self.batch_size = batch_size
        self.mean = tuple(normalize_mean)
        self.std = tuple(normalize_std)
        self.image_size = tuple(int(v) for v in dataset_setting["image_size"])  # (W, H)
        self.pixel_std = float(dataset_setting["pixel_std"])
        self.scale_padding = float(dataset_setting["scale_padding"])
        decoder_setting = dict(decoder_setting or {})
        self.use_udp = bool(decoder_setting.get("use_udp", False))
        decoder = create_decoder(decoder_name, **decoder_setting)
        self.qstate = None
        if quantize == "int8":
            self.qstate = quantize_variables(
                {k: v.detach().cpu() for k, v in net.state_dict().items()}, net)
        self._eval_net = create_eval_network(net.to(self.device), decoder, output_raw=False)
        self._forward = self._eval_net
        if self.qstate is not None:
            self._forward = quantized_eval_apply(self._eval_net, self.qstate)

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
        return cls(
            _net_from_config(args, net_state),
            dataset_setting=args.dataset_setting,
            decoder_setting=getattr(args, "decoder_setting", None),
            normalize_mean=args.normalize_mean,
            normalize_std=args.normalize_std,
            decoder_name=getattr(args, "decoder_name", "topdown_heatmap") or "topdown_heatmap",
            **kwargs,
        )

    @property
    def net(self) -> torch.nn.Module:
        """The served net (eval mode, on ``self.device``; with int8 weights
        its quantized parameters lie on the meta device, and ``qstate``
        holds them)."""
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
            preds.append(self._forward(x[chunk], centers[chunk], scales[chunk], scores[chunk])[0])
        return torch.cat(preds).cpu().numpy()


class BottomUpPredictor:
    """Single-image multi-person bottom-up predictor (no detector needed).

    Args:
        net: the port's ``Net`` (backbone + ``higher_hrnet_head``), with its
            weights loaded; it is moved to ``device`` and put in eval mode.
        dataset_setting: the config's dataset_setting dict (max_image_size,
            pixel_std, flip_pairs, ...). ``max_image_size`` is made square
            (its longer side), as the JAX predictor does, so that landscape
            and portrait images take one shape: a 640x480 image at the
            HigherHRNet-W32 recipe's [832, 512] runs at 832x832.
        eval_setting: the config's eval_setting dict (joint_order, tag_thr,
            vis_thr, downsample_scale, device_grouping, TTA, ...).
        decoder_setting: the ``bottomup_heatmap_ae`` decoder's kwargs.
        device: where the forward, the decode and the grouping run. Default:
            the current CUDA device; without CUDA the default raises, and a
            caller who wants the CPU passes ``device="cpu"``.

    It serves in float32 with TF32 off, as the inferencer runs at O0.
    """

    def __init__(
        self,
        net: torch.nn.Module,
        dataset_setting: Dict[str, Any],
        eval_setting: Dict[str, Any],
        decoder_setting: Optional[Dict[str, Any]] = None,
        normalize_mean=(0.485, 0.456, 0.406),
        normalize_std=(0.229, 0.224, 0.225),
        device: Optional[torch.device] = None,
    ) -> None:
        from ..data.transform.bottomup_transform import BottomUpPad, BottomUpRescale
        from .factory import create_inferencer

        self.device = _default_device(device, "BottomUpPredictor")
        self.mean = tuple(normalize_mean)
        self.std = tuple(normalize_std)
        setting = dict(dataset_setting)
        mw, mh = setting["max_image_size"]
        side = max(int(mw), int(mh))
        setting["max_image_size"] = [side, side]
        self._rescale = BottomUpRescale(is_train=False, config=setting)
        self._pad = BottomUpPad(is_train=False, config=setting)
        self._num_joints = int((decoder_setting or {}).get("num_joints", 17))
        decoder = create_decoder("bottomup_heatmap_ae", **(decoder_setting or {}))
        eval_net = create_eval_network(
            net, decoder, output_raw=eval_setting.get("has_heatmap_output", True))
        self.inferencer = create_inferencer(
            eval_net, name="bottomup_heatmap_ae", config=dict(eval_setting),
            dataset_config=setting, device=self.device)

    @classmethod
    def from_config(cls, args: Any, net_state: Mapping[str, torch.Tensor],
                    device: Optional[torch.device] = None) -> "BottomUpPredictor":
        """Build from a parsed config namespace and the net's weights, as
        ``TopDownPredictor.from_config`` does."""
        return cls(
            _net_from_config(args, net_state),
            dataset_setting=args.dataset_setting,
            eval_setting=args.eval_setting,
            decoder_setting=getattr(args, "decoder_setting", None),
            normalize_mean=args.normalize_mean,
            normalize_std=args.normalize_std,
            device=device,
        )

    @property
    def net(self) -> torch.nn.Module:
        """The served net (eval mode, on ``self.device``)."""
        return self.inferencer.net.net

    @torch.inference_mode()
    def __call__(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Predict all persons in an RGB uint8 image.

        Returns ``(preds, scores)``: keypoints [P, K, 3 + L] (x, y, score,
        tags) in the original image frame and per-person scores [P].
        """
        image = np.asarray(image)
        if image.ndim != 3 or image.dtype != np.uint8:
            raise ValueError(f"want an HWC uint8 image, got {image.dtype} {image.shape}")
        state = {"image": image}
        state.update(self._rescale.transform(state))
        state.update(self._pad.transform(state))
        img = torch.from_numpy(np.ascontiguousarray(state["image"])).to(self.device)
        x = normalize_image(img[None], self.mean, self.std).permute(0, 3, 1, 2).contiguous()
        mask = torch.from_numpy(state["mask"]).to(self.device)[None].float()
        batch = {key: np.asarray(state[key])[None] for key in ("center", "scale", "image_shape")}
        (preds,), (scores,) = self.inferencer.persons(self.inferencer.forward_decode(x, mask),
                                                       batch)
        preds = np.asarray(preds, np.float32)
        if preds.size == 0:
            return (np.zeros((0, self._num_joints, 3), np.float32),
                    np.zeros((0,), np.float32))
        return preds, np.asarray(scores, np.float32).reshape(-1)
