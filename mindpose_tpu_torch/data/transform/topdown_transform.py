"""Top-down crop geometry in numpy, and the top-down transforms of the loaders.

Copies of ``mindpose_tpu/data/transform/topdown_transform.py``:

- ``TopDownBoxToCenterScale._xywh2cs`` (:71-87) and the warp matrix of
  ``TopDownAffine._matrix_and_keypoints`` (:103-124, standard and UDP), as
  the functions ``box_to_center_scale`` and ``crop_matrix``; serving warps
  the pixels on the device with them (``ops/image.affine_warp``);
- the transforms, registered under the JAX package's names, for evaluation
  and training: ``topdown_box_to_center_scale`` (with the train-mode center
  jitter, :76-77), ``topdown_affine`` (the host cv2 crop and the keypoints
  mapped into it, :103-148), ``topdown_affine_matrix`` (the same matrix
  and keypoints, the pixels left to the device warp of ``device_pipeline:
  full``: a deferred flip folded into the matrix, and with
  ``crop_source_patch`` the frame cut to the warp's source rectangle and the
  matrix rebased onto it, :152-235), ``topdown_generate_target`` (the Gaussian
  heatmaps in HWK layout and the target weights, :237-328),
  ``topdown_horizontal_random_flip`` (:332), ``topdown_halfbody_transform``
  (:371), ``topdown_randomscale_rotation`` (:436), and the targets of the
  SimCC and RLE heads, ``topdown_generate_simcc_target`` (:462: per-axis
  discrete Gaussians over the x and y bins) and
  ``topdown_generate_regression_target`` (:515: coordinates over the input
  size);
- ``topdown_photometric_distortion`` (:551: brightness, contrast,
  saturation and hue jitter on the uint8 pixels; no recipe sets it).

Every random draw is made on the global ``np.random`` stream, in the JAX
package's order, so that with one loader worker and one seed the port's
crops and targets equal the JAX package's bit for bit. The flip's
``defer_to_warp`` (``device_pipeline: full``) draws as the host flip does,
leaves the pixels alone and flags the record (``hflip``) for
``topdown_affine_matrix``. cv2 is imported, with ``cv2.setNumThreads(2)`` as the JAX module
sets at import, when a transform first needs it, so serving never imports
it. tests/test_torch_host_copies.py, tests/test_torch_eval_copies.py and
tests/test_torch_train_loader.py hold each copy equal to its original
(the SimCC and regression targets: tests/test_torch_simcc.py and
tests/test_torch_rle.py).
"""
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ...register import register
from .transform import Transform
from .utils import (
    affine_transform,
    compose_affine,
    fliplr_joints,
    flip_index_from_pairs,
    get_affine_transform,
    get_warp_matrix,
    hflip_matrix,
    warp_affine_joints,
)

__all__ = ["box_to_center_scale", "crop_matrix", "TopDownTransform",
           "TopDownBoxToCenterScale", "TopDownAffine", "TopDownAffineMatrix",
           "TopDownGenerateTarget",
           "TopDownHorizontalRandomFlip", "TopDownHalfBodyTransform",
           "TopDownRandomScaleRotation", "TopDownGenerateSimCCTarget",
           "TopDownGenerateRegressionTarget", "TopDownPhotometricDistortion"]

_CV2 = []


def _cv2():
    """cv2, with two threads per call as the JAX transforms set it at import."""
    if not _CV2:
        import cv2

        cv2.setNumThreads(2)
        _CV2.append(cv2)
    return _CV2[0]


def box_to_center_scale(
    box: Sequence[float],
    image_size: Sequence[int],
    pixel_std: float = 200.0,
    scale_padding: float = 1.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """xywh box -> (center [2] float32, scale [2] float32), aspect-fixed and padded."""
    x, y, w, h = box
    image_size = np.array(image_size)
    pixel_std = float(pixel_std)
    aspect_ratio = image_size[0] / image_size[1]
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)

    if w > aspect_ratio * h:
        h = w * 1.0 / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio

    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
    scale = scale * float(scale_padding)
    return center, scale


def crop_matrix(
    center: np.ndarray,
    scale: np.ndarray,
    image_size: Sequence[int],
    pixel_std: float = 200.0,
    use_udp: bool = False,
    rotation: float = 0.0,
) -> np.ndarray:
    """Forward 2x3 matrix mapping the source image onto the (W, H) crop."""
    image_size = np.array(image_size)
    pixel_std = float(pixel_std)
    if use_udp:
        return get_warp_matrix(
            rotation, center * 2.0, image_size - 1.0, scale * pixel_std
        )
    return get_affine_transform(center, scale, rotation, image_size, pixel_std=pixel_std)


class TopDownTransform(Transform):
    """Base of the top-down transforms: reads the dataset setting."""

    def load_transform_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["image_size"] = np.array(self.config["image_size"])
        cfg["heatmap_size"] = np.array(self.config["heatmap_size"])
        if len(cfg["image_size"]) != 2 or len(cfg["heatmap_size"]) != 2:
            raise ValueError("image_size and heatmap_size are (W, H) pairs")

        flip_pairs = np.array(self.config["flip_pairs"])
        cfg["flip_pairs"] = flip_pairs
        cfg["flip_index"] = flip_index_from_pairs(flip_pairs)
        cfg["upper_body_ids"] = np.array(self.config["upper_body_ids"])
        cfg["pixel_std"] = float(self.config["pixel_std"])
        cfg["scale_padding"] = float(self.config["scale_padding"])
        cfg["joint_weights"] = (
            np.array(self.config["joint_weights"])
            if "joint_weights" in self.config
            else None
        )
        return cfg


@register("transform", extra_name="topdown_box_to_center_scale")
class TopDownBoxToCenterScale(TopDownTransform):
    """xywh box -> (center, scale); random center jitter (p=0.3) on train."""

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self._transform_cfg
        if not self.is_train:
            center, scale = box_to_center_scale(state["boxes"], cfg["image_size"],
                                                cfg["pixel_std"], cfg["scale_padding"])
            return dict(center=center, scale=scale)
        # the JAX package's _xywh2cs with its jitter, line for line: the
        # draws sit between the center and the aspect fix
        x, y, w, h = state["boxes"]
        aspect_ratio = cfg["image_size"][0] / cfg["image_size"][1]
        center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)

        if np.random.rand() < 0.3:
            center += np.random.uniform(-0.2, 0.2, size=2) * [w, h]

        if w > aspect_ratio * h:
            h = w * 1.0 / aspect_ratio
        elif w < aspect_ratio * h:
            w = h * aspect_ratio

        pixel_std = cfg["pixel_std"]
        scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
        scale = scale * cfg["scale_padding"]
        return dict(center=center, scale=scale)


@register("transform", extra_name="topdown_affine")
class TopDownAffine(TopDownTransform):
    """Crop the instance to image_size with cv2.warpAffine (standard or UDP
    matrix) and map its keypoints, where the record has them, into the crop."""

    def __init__(self, is_train: bool = True, config: Optional[Dict[str, Any]] = None,
                 use_udp: bool = False) -> None:
        super().__init__(is_train=is_train, config=config)
        self.use_udp = use_udp

    def _matrix_and_keypoints(self, state: Dict[str, Any]) -> Tuple[np.ndarray, Dict[str, Any]]:
        """The crop's matrix, and the record's keypoints mapped through it."""
        cfg = self._transform_cfg
        trans = crop_matrix(state["center"], state["scale"], cfg["image_size"], cfg["pixel_std"],
                            self.use_udp, state.get("rotation", 0.0))
        out: Dict[str, Any] = {}
        if "keypoints" in state:
            keypoints = state["keypoints"].copy()
            if self.use_udp:
                keypoints[:, 0:2] = warp_affine_joints(keypoints[:, 0:2], trans)
            else:
                for i in range(keypoints.shape[0]):
                    if keypoints[i, 2] > 0.0:
                        keypoints[i, 0:2] = affine_transform(keypoints[i, 0:2], trans)
            out["keypoints"] = keypoints
        return trans, out

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image_size = self._transform_cfg["image_size"]
        trans, out = self._matrix_and_keypoints(state)
        out["image"] = _cv2().warpAffine(
            state["image"],
            np.asarray(trans, dtype=np.float64),
            (int(image_size[0]), int(image_size[1])),
            flags=_cv2().INTER_LINEAR,
        )
        return out


@register("transform", extra_name="topdown_affine_matrix")
class TopDownAffineMatrix(TopDownAffine):
    """``topdown_affine`` for ``device_pipeline: full``: the matrix and the
    keypoints, with the pixels left to the device warp
    (``ops/image.affine_warp``). A deferred flip (``state["hflip"]``) is
    folded into the matrix: the keypoints and center are already mirrored,
    so the warp mirrors the original frame first.

    ``crop_source_patch`` (on by default) ships only the axis-aligned source
    rectangle that the crop samples (the preimage of the crop's corners,
    with ``patch_margin`` pixels for the bilinear support, clamped to the
    frame) and rebases the matrix onto it. Every pixel the warp reads lies
    in the patch and outside the frame reads 0 in both, so the warp is the
    frame's up to float32 rounding: the rebased translation reorders the sum
    of each sample coordinate.
    """

    def __init__(self, is_train: bool = True, config: Optional[Dict[str, Any]] = None,
                 use_udp: bool = False, crop_source_patch: bool = True,
                 patch_margin: int = 2) -> None:
        super().__init__(is_train=is_train, config=config, use_udp=use_udp)
        self.crop_source_patch = crop_source_patch
        self.patch_margin = int(patch_margin)

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        trans, out = self._matrix_and_keypoints(state)
        if state.get("hflip", False):
            trans = compose_affine(trans, hflip_matrix(state["image"].shape[1]))
        if self.crop_source_patch:
            out["image"], trans = self._crop_to_patch(state["image"], trans)
        out["warp_mat"] = np.asarray(trans, np.float32)
        return out

    def _crop_to_patch(self, frame: np.ndarray,
                       trans: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The frame cut to the warp's source rectangle, and the matrix rebased onto it."""
        h, w = frame.shape[:2]
        ow, oh = (int(x) for x in self._transform_cfg["image_size"])
        m = np.vstack([np.asarray(trans, np.float64), [0.0, 0.0, 1.0]])
        corners = np.array(
            [[0, 0, 1], [ow - 1, 0, 1], [0, oh - 1, 1], [ow - 1, oh - 1, 1]],
            np.float64,
        ).T
        src = np.linalg.inv(m) @ corners  # [3, 4] source coords
        mg = self.patch_margin
        x0 = max(0, int(np.floor(src[0].min())) - mg)
        y0 = max(0, int(np.floor(src[1].min())) - mg)
        x1 = min(w, int(np.ceil(src[0].max())) + mg + 1)
        y1 = min(h, int(np.ceil(src[1].max())) + mg + 1)
        # a box wholly off the frame keeps a 1-pixel patch: its samples are
        # off the frame and read 0 either way, as cv2's border does
        x0 = min(x0, w - 1)
        y0 = min(y0, h - 1)
        x1 = max(x1, x0 + 1)
        y1 = max(y1, y0 + 1)
        patch = np.ascontiguousarray(frame[y0:y1, x0:x1])
        # patch coordinates q are source s = q + (x0, y0): trans'(q) = A q + (A @ offset + b)
        a = np.asarray(trans, np.float64)[:, :2]
        b = np.asarray(trans, np.float64)[:, 2]
        b2 = a @ np.array([x0, y0], np.float64) + b
        return patch, np.concatenate([a, b2[:, None]], axis=1)


@register("transform", extra_name="topdown_generate_target")
class TopDownGenerateTarget(TopDownTransform):
    """Rasterize per-joint Gaussian heatmaps (HWK layout) + target weights.

    ``use_udp`` switches from round-to-pixel centers with a shared kernel to
    the UDP unbiased sub-pixel-centered kernel. The train entry turns the
    batch's HWK targets to NCHW on the device, as it does the images.
    """

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        sigma: float = 2.0,
        use_different_joint_weights: bool = False,
        use_udp: bool = False,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.sigma = sigma
        self.use_different_joint_weights = use_different_joint_weights
        self.use_udp = use_udp
        if use_different_joint_weights and self._transform_cfg["joint_weights"] is None:
            raise ValueError(
                "`joint_weights` must be provided if "
                "`use_different_joint_weights` is True."
            )

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image_size = self._transform_cfg["image_size"]
        w, h = self._transform_cfg["heatmap_size"]
        keypoints = state["keypoints"]
        num_joints = keypoints.shape[0]

        target_weight = np.zeros(num_joints, dtype=np.float32)
        target = np.zeros((num_joints, h, w), dtype=np.float32)

        tmp_size = self.sigma * 3
        # float size semantics: the kernel grid has ceil(size) samples and
        # its peak sits at the float floor-half
        size = 2 * tmp_size + 1
        x = np.arange(0, size, 1, np.float32)
        y = x[:, None]
        x0 = y0 = size // 2
        if not self.use_udp:
            g_shared = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * self.sigma**2))

        for j in range(num_joints):
            target_weight[j] = keypoints[j, 2]

            if self.use_udp:
                feat_stride = (image_size - 1.0) / (np.array([w, h]) - 1.0)
                mu_x = int(keypoints[j][0] / feat_stride[0] + 0.5)
                mu_y = int(keypoints[j][1] / feat_stride[1] + 0.5)
            else:
                feat_stride = image_size / np.array([w, h])
                mu_x = round(keypoints[j][0] / feat_stride[0])
                mu_y = round(keypoints[j][1] / feat_stride[1])

            ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
            br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
            if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
                target_weight[j] = 0
                continue

            if target_weight[j] > 0.5:
                if self.use_udp:
                    mu_x_ac = keypoints[j][0] / feat_stride[0]
                    mu_y_ac = keypoints[j][1] / feat_stride[1]
                    x0_p = x0 + mu_x_ac - mu_x
                    y0_p = y0 + mu_y_ac - mu_y
                    g = np.exp(
                        -((x - x0_p) ** 2 + (y - y0_p) ** 2) / (2 * self.sigma**2)
                    )
                else:
                    g = g_shared

                g_x = max(0, -ul[0]), min(br[0], w) - ul[0]
                g_y = max(0, -ul[1]), min(br[1], h) - ul[1]
                img_x = max(0, ul[0]), min(br[0], w)
                img_y = max(0, ul[1]), min(br[1], h)
                target[j][img_y[0] : img_y[1], img_x[0] : img_x[1]] = g[
                    g_y[0] : g_y[1], g_x[0] : g_x[1]
                ]

        if self.use_different_joint_weights:
            target_weight = target_weight * self._transform_cfg["joint_weights"]

        return dict(
            target=np.ascontiguousarray(target.transpose(1, 2, 0)),
            target_weight=target_weight,
        )


@register("transform", extra_name="topdown_horizontal_random_flip")
class TopDownHorizontalRandomFlip(TopDownTransform):
    """Mirror the frame, its keypoints (left/right swapped) and the center
    with probability ``flip_prob``."""

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        flip_prob: float = 0.5,
        defer_to_warp: bool = False,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.flip_prob = flip_prob
        # device_pipeline: full leaves the pixels alone and flags the flip,
        # which topdown_affine_matrix folds into the warp matrix
        self.defer_to_warp = defer_to_warp

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image = state["image"]
        keypoints = state["keypoints"]
        center = state["center"]

        if np.random.rand() <= self.flip_prob:
            if not self.defer_to_warp:
                image = _cv2().flip(image, 1)
            flip_index = self._transform_cfg["flip_index"]
            if len(flip_index) != keypoints.shape[-2]:
                # trailing unpaired joints (cfg index inferred K = max+1)
                flip_index = flip_index_from_pairs(
                    self._transform_cfg["flip_pairs"], keypoints.shape[-2]
                )
            keypoints = fliplr_joints(
                keypoints, image.shape[1], flip_index=flip_index
            )
            center = center.copy()
            center[0] = image.shape[1] - center[0]
            if self.defer_to_warp:
                return dict(keypoints=keypoints, center=center, hflip=True)
        return dict(image=image, keypoints=keypoints, center=center)


@register("transform", extra_name="topdown_halfbody_transform")
class TopDownHalfBodyTransform(TopDownTransform):
    """Randomly crop to upper/lower body when enough joints are visible."""

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        num_joints_half_body: int = 8,
        prob_half_body: float = 0.3,
        scale_padding: float = 1.5,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.num_joints_half_body = num_joints_half_body
        self.prob_half_body = prob_half_body
        self.scale_padding = scale_padding

    def half_body_transform(self, keypoints: np.ndarray, num_joints: int = 17):
        upper, lower = [], []
        upper_ids = set(self._transform_cfg["upper_body_ids"].tolist())
        for j in range(num_joints):
            if keypoints[j][2] > 0:
                (upper if j in upper_ids else lower).append(keypoints[j])

        if np.random.randn() < 0.5 and len(upper) > 2:
            selected = upper
        elif len(lower) > 2:
            selected = lower
        else:
            selected = upper
        if len(selected) < 2:
            return None, None

        selected = np.array(selected, dtype=np.float32)
        center = selected.mean(axis=0)[:2]
        left_top = np.amin(selected, axis=0)
        right_bottom = np.amax(selected, axis=0)
        w = right_bottom[0] - left_top[0]
        h = right_bottom[1] - left_top[1]

        image_size = self._transform_cfg["image_size"]
        aspect_ratio = image_size[0] / image_size[1]
        if w > aspect_ratio * h:
            h = w * 1.0 / aspect_ratio
        elif w < aspect_ratio * h:
            w = h * aspect_ratio

        pixel_std = self._transform_cfg["pixel_std"]
        scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
        return center, scale * self.scale_padding

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        keypoints = state["keypoints"]
        if (
            np.sum(keypoints[:, 2]) > self.num_joints_half_body
            and np.random.rand() < self.prob_half_body
        ):
            center, scale = self.half_body_transform(
                keypoints, num_joints=keypoints.shape[0]
            )
            if center is not None and scale is not None:
                return dict(center=center, scale=scale)
        return dict()


@register("transform", extra_name="topdown_randomscale_rotation")
class TopDownRandomScaleRotation(TopDownTransform):
    """Random scale in [1 - sf, 1 + sf] and, with probability ``rot_prob``, a
    random rotation in [-2 rf, 2 rf] degrees."""

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        rot_factor: float = 40.0,
        scale_factor: float = 0.5,
        rot_prob: float = 0.6,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.rot_factor = rot_factor
        self.scale_factor = scale_factor
        self.rot_prob = rot_prob

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        s = state["scale"]
        sf = self.scale_factor
        rf = self.rot_factor

        s_factor = np.clip(np.random.randn() * sf + 1, 1 - sf, 1 + sf)
        s = s * np.float32(s_factor)
        r_factor = np.clip(np.random.randn() * rf, -rf * 2, rf * 2)
        r = np.float32(r_factor) if np.random.rand() <= self.rot_prob else np.float32(0.0)
        return dict(scale=s, rotation=r)


@register("transform", extra_name="topdown_generate_simcc_target")
class TopDownGenerateSimCCTarget(TopDownTransform):
    """Per-axis discrete Gaussian label distributions over SimCC bins.

    Copy of the JAX package's (:462); pairs with models/heads/simcc_head.py
    (arXiv:2107.03332). For each visible joint at input-image coords (x, y),
    the labels are Gaussians centered at x*split_ratio / y*split_ratio over
    the bin axes, each normalized to sum 1 (proper distributions for the
    KL loss). Emits ``target`` [K, Bx+By] (x labels then y labels) and
    ``target_weight`` [K]; joints whose peak falls outside the bin range
    get weight 0, mirroring the heatmap encoder's out-of-window rule.
    """

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        sigma: float = 6.0,
        split_ratio: float = 2.0,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.sigma = sigma
        self.split_ratio = split_ratio

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image_size = self._transform_cfg["image_size"]
        bx = int(round(float(image_size[0]) * self.split_ratio))
        by = int(round(float(image_size[1]) * self.split_ratio))
        keypoints = state["keypoints"]
        num_joints = keypoints.shape[0]

        mu = keypoints[:, :2].astype(np.float32) * self.split_ratio  # [K, 2]
        vis = keypoints[:, 2] > 0
        inside = (
            (mu[:, 0] >= 0) & (mu[:, 0] < bx)
            & (mu[:, 1] >= 0) & (mu[:, 1] < by)
        )
        target_weight = (vis & inside).astype(np.float32)

        def labels(centers, n_bins):
            grid = np.arange(n_bins, dtype=np.float32)[None, :]
            g = np.exp(
                -((grid - centers[:, None]) ** 2) / (2.0 * self.sigma**2)
            )
            s = g.sum(axis=1, keepdims=True)
            return g / np.maximum(s, 1e-12)

        target = np.zeros((num_joints, bx + by), dtype=np.float32)
        target[:, :bx] = labels(mu[:, 0], bx)
        target[:, bx:] = labels(mu[:, 1], by)
        target *= target_weight[:, None]
        return dict(target=target, target_weight=target_weight)


@register("transform", extra_name="topdown_generate_regression_target")
class TopDownGenerateRegressionTarget(TopDownTransform):
    """Normalized-coordinate targets for direct regression heads.

    Copy of the JAX package's (:515); pairs with models/heads/rle_head.py
    (arXiv:2107.11291). For each joint at input-image coords (x, y), the
    target is ``(x / W, y / H)`` — the shared convention of the rle loss
    and the regression decoder. Emits ``target`` [K, 2] and
    ``target_weight`` [K]; joints outside the crop (or invisible) get
    weight 0, mirroring the heatmap encoder's out-of-window rule.
    """

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        super().__init__(is_train=is_train, config=config)

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image_size = self._transform_cfg["image_size"]
        w, h = float(image_size[0]), float(image_size[1])
        keypoints = state["keypoints"]

        xy = keypoints[:, :2].astype(np.float32)
        vis = keypoints[:, 2] > 0
        inside = (
            (xy[:, 0] >= 0) & (xy[:, 0] < w)
            & (xy[:, 1] >= 0) & (xy[:, 1] < h)
        )
        target_weight = (vis & inside).astype(np.float32)
        target = xy / np.array([w, h], dtype=np.float32)
        target *= target_weight[:, None]
        return dict(target=target, target_weight=target_weight)


@register("transform", extra_name="topdown_photometric_distortion")
class TopDownPhotometricDistortion(TopDownTransform):
    """Random brightness / contrast / saturation / hue jitter (uint8 HWC).

    The SSD-style photometric pipeline, each op applied with probability
    0.5, contrast randomly ordered before or after saturation/hue. Pixels
    stay uint8; keypoints and geometry are untouched, so it composes
    anywhere before ``topdown_affine`` (host path) and with the device
    pipeline (the warp takes whatever pixels the host hands it).
    """

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        brightness_delta: float = 32.0,
        contrast_range: Tuple[float, float] = (0.5, 1.5),
        saturation_range: Tuple[float, float] = (0.5, 1.5),
        hue_delta: float = 18.0,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.brightness_delta = float(brightness_delta)
        self.contrast_range = tuple(contrast_range)
        self.saturation_range = tuple(saturation_range)
        self.hue_delta = float(hue_delta)

    @staticmethod
    def _clip_u8(image: np.ndarray) -> np.ndarray:
        return np.clip(image, 0, 255).astype(np.uint8)

    def _contrast(self, image: np.ndarray) -> np.ndarray:
        if np.random.rand() < 0.5:
            alpha = np.random.uniform(*self.contrast_range)
            image = self._clip_u8(image.astype(np.float32) * alpha)
        return image

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image = state["image"]

        if np.random.rand() < 0.5:
            delta = np.random.uniform(-self.brightness_delta,
                                      self.brightness_delta)
            image = self._clip_u8(image.astype(np.float32) + delta)

        contrast_first = np.random.rand() < 0.5
        if contrast_first:
            image = self._contrast(image)

        do_sat = np.random.rand() < 0.5
        do_hue = np.random.rand() < 0.5
        if do_sat or do_hue:
            cv2 = _cv2()
            hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV).astype(np.float32)
            if do_sat:
                hsv[..., 1] *= np.random.uniform(*self.saturation_range)
            if do_hue:
                # OpenCV uint8 hue wraps at 180
                hsv[..., 0] = (
                    hsv[..., 0] + np.random.uniform(-self.hue_delta,
                                                    self.hue_delta)
                ) % 180.0
            hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
            image = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)

        if not contrast_first:
            image = self._contrast(image)

        return dict(image=image)
