"""Bottom-up (whole-image, multi-person) transforms: copies of ``mindpose_tpu/data/transform/bottomup_transform.py``.

Evaluation and serving: the base ``BottomUpTransform`` (:38),
``bottomup_rescale`` (``BottomUpRescale``, :93: fit the image into
``max_image_size``, keeping its aspect ratio, with the center and scale that
map the heatmaps back), ``bottomup_resize`` (``BottomUpResize``, :130: the
short side to ``size`` and both sides up to multiples of ``base_length``,
warped with cv2's INTER_LINEAR, with a mask of ones; no recipe sets it, and
its inputs need not be square) and ``bottomup_pad`` (``BottomUpPad``, :436: pad to
``max_image_size``, with the validity mask). Training:
``bottomup_horizontal_random_flip`` (:56), ``bottomup_random_affine``
(:189: image warped to ``image_size`` with INTER_LINEAR, each level's mask
with INTER_NEAREST and its keypoints to that level's heatmap),
``bottomup_generate_target`` (:298: the multi-level Gaussian targets
``[S, Hmax, Wmax, K]`` by a vectorised scatter-max, and the AE tag indices
``[S, max_num, K, 2]``) and the device pipeline's
``bottomup_generate_tag_ind`` (:456: the tag indices alone, keypoints
padded to ``max_num``). Each draws from the global numpy stream in the JAX
order (``np.random.randint`` with float bounds included). cv2 is imported
when a transform first needs it, with the JAX module's 2 threads
(``topdown_transform._cv2``). tests/test_torch_host_copies.py and
tests/test_torch_bottomup_train_data.py hold each copy equal to its
original.
"""
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...register import register
from .topdown_transform import _cv2
from .transform import Transform
from .utils import (
    fliplr_joints,
    flip_index_from_pairs,
    get_affine_transform,
    pad_to_same,
    warp_affine_joints,
)

__all__ = [
    "BottomUpTransform",
    "BottomUpHorizontalRandomFlip",
    "BottomUpRandomAffine",
    "BottomUpGenerateTarget",
    "BottomUpGenerateTagInd",
    "BottomUpRescale",
    "BottomUpResize",
    "BottomUpPad",
]


class BottomUpTransform(Transform):
    def load_transform_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["image_size"] = np.array(self.config["image_size"])
        cfg["max_image_size"] = np.array(self.config["max_image_size"])
        cfg["heatmap_sizes"] = np.array(self.config["heatmap_sizes"])
        assert len(cfg["image_size"]) == 2
        for x in cfg["heatmap_sizes"]:
            assert len(x) == 2

        flip_pairs = np.array(self.config["flip_pairs"])
        cfg["flip_pairs"] = flip_pairs
        cfg["flip_index"] = flip_index_from_pairs(flip_pairs)
        cfg["pixel_std"] = float(self.config["pixel_std"])
        cfg["tag_per_joint"] = self.config["tag_per_joint"]
        return cfg


@register("transform", extra_name="bottomup_horizontal_random_flip")
class BottomUpHorizontalRandomFlip(BottomUpTransform):
    """Flip image + per-level masks/keypoints."""

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        flip_prob: float = 0.5,
    ) -> None:
        super().__init__(is_train, config)
        self.flip_prob = flip_prob

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image = state["image"]
        keypoints = state["keypoints"]
        mask = state["mask"]
        heatmap_sizes = self._transform_cfg["heatmap_sizes"]

        if np.random.rand() <= self.flip_prob:
            image = _cv2().flip(image, 1)
            flip_index = self._transform_cfg["flip_index"]
            if len(flip_index) != keypoints.shape[-2]:
                # trailing unpaired joints (cfg index inferred K = max+1)
                flip_index = flip_index_from_pairs(
                    self._transform_cfg["flip_pairs"], keypoints.shape[-2]
                )
            for i, heatmap_size in enumerate(heatmap_sizes):
                width, height = heatmap_size
                patch = mask[i, :height, :width]
                mask[i, :height, :width] = patch[:, ::-1]
                keypoints[i] = fliplr_joints(
                    keypoints[i], width, flip_index=flip_index
                )
        return dict(image=image, keypoints=keypoints, mask=mask)



@register("transform", extra_name="bottomup_rescale")
class BottomUpRescale(BottomUpTransform):
    """Rescale to fit max_image_size, keeping aspect ratio."""

    @staticmethod
    def _get_new_size(image_size, max_size) -> Tuple[int, int]:
        w, h = image_size
        max_w, max_h = max_size
        if w < h:
            max_w, max_h = max_h, max_w
        if w / h > max_w / max_h:
            target_w = max_w
            target_h = round(h * max_w / w)
        else:
            target_h = max_h
            target_w = round(w * max_h / h)
        return int(target_w), int(target_h)

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        cv2 = _cv2()
        image = state["image"]
        height, width = image.shape[:2]
        target_size = self._get_new_size(
            [width, height], self._transform_cfg["max_image_size"]
        )
        image = cv2.resize(image, target_size, interpolation=cv2.INTER_LINEAR)

        pixel_std = self._transform_cfg["pixel_std"]
        center = np.array([round(width / 2), round(height / 2)])
        scale = np.array([width / pixel_std, height / pixel_std])
        return dict(
            image=image,
            center=center,
            scale=scale,
            image_shape=np.array(target_size),
        )


@register("transform", extra_name="bottomup_resize")
class BottomUpResize(BottomUpTransform):
    """Short side to `size`, dims ceiled to base_length."""

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        size: int = 512,
        base_length: int = 64,
    ) -> None:
        super().__init__(is_train, config)
        self.size = size
        self.base_length = base_length

    @staticmethod
    def _ceil_to_base_length(x, base_length: int) -> int:
        return int(np.ceil(x / base_length)) * base_length

    def _get_new_size(self, image_size, size, base_length=64, pixel_std=200.0):
        w, h = image_size
        min_size = self._ceil_to_base_length(size, base_length)
        if w < h:
            target_w = min_size
            target_h = self._ceil_to_base_length(min_size / w * h, base_length)
            scale_w = w / pixel_std
            scale_h = target_h / target_w * w / pixel_std
        else:
            target_h = min_size
            target_w = self._ceil_to_base_length(min_size / h * w, base_length)
            scale_h = h / pixel_std
            scale_w = target_w / target_h * h / pixel_std
        center = np.array([round(w / 2), round(h / 2)])
        scale = np.array([scale_w, scale_h])
        return (target_w, target_h), center, scale

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        cv2 = _cv2()
        image = state["image"]
        height, width = image.shape[:2]
        target_size, center, scale = self._get_new_size(
            [width, height],
            self.size,
            base_length=self.base_length,
            pixel_std=self._transform_cfg["pixel_std"],
        )
        mat = get_affine_transform(center, scale, 0, target_size)
        image = cv2.warpAffine(
            image, np.asarray(mat), target_size, flags=cv2.INTER_LINEAR
        )
        mask = np.ones(image.shape[:2], dtype=np.uint8)
        return dict(
            image=image,
            mask=mask,
            center=center,
            scale=scale,
            image_shape=np.array(target_size),
        )


@register("transform", extra_name="bottomup_random_affine")
class BottomUpRandomAffine(BottomUpTransform):
    """Random scale/rotate/translate; warps image to image_size and
    masks/keypoints to each heatmap level."""

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        rot_factor: float = 30.0,
        scale_factor: Tuple[float, float] = (0.75, 1.5),
        scale_type: str = "short",
        trans_factor: float = 40.0,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.max_rotation = rot_factor
        self.min_scale = scale_factor[0]
        self.max_scale = scale_factor[1]
        self.scale_type = scale_type
        self.trans_factor = trans_factor

    def _get_scale(self, image_size, resized_size) -> np.ndarray:
        w, h = image_size
        w_resized, h_resized = resized_size
        if w / w_resized < h / h_resized:
            if self.scale_type == "long":
                w_pad = h / h_resized * w_resized
                h_pad = h
            elif self.scale_type == "short":
                w_pad = w
                h_pad = w / w_resized * h_resized
            else:
                raise ValueError(f"Unknown scale type: {self.scale_type}")
        else:
            if self.scale_type == "long":
                w_pad = w
                h_pad = w / w_resized * h_resized
            elif self.scale_type == "short":
                w_pad = h / h_resized * w_resized
                h_pad = h
            else:
                raise ValueError(f"Unknown scale type: {self.scale_type}")
        return np.array([w_pad, h_pad], dtype=np.float32)

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        cv2 = _cv2()
        image = state["image"]
        mask = state["mask"]
        keypoints = state["keypoints"]

        image_size = self._transform_cfg["image_size"]
        heatmap_sizes = self._transform_cfg["heatmap_sizes"]
        pixel_std = self._transform_cfg["pixel_std"]

        height, width = image.shape[:2]
        center = np.array((width / 2, height / 2))
        img_scale = np.array([width, height], dtype=np.float32)
        aug_scale = np.random.uniform(self.min_scale, self.max_scale)
        img_scale = img_scale * aug_scale
        aug_rot = np.random.uniform(-self.max_rotation, self.max_rotation)

        if self.trans_factor > 0:
            dx = np.random.randint(
                -self.trans_factor * img_scale[0] / pixel_std,
                self.trans_factor * img_scale[0] / pixel_std,
            )
            dy = np.random.randint(
                -self.trans_factor * img_scale[1] / pixel_std,
                self.trans_factor * img_scale[1] / pixel_std,
            )
            center[0] += dx
            center[1] += dy

        mask_list = []
        for i, heatmap_size in enumerate(heatmap_sizes):
            scale = self._get_scale(img_scale, heatmap_size)
            mat = get_affine_transform(
                center=center,
                scale=scale / pixel_std,
                rot=aug_rot,
                output_size=heatmap_size,
                pixel_std=pixel_std,
            )
            warped_mask = cv2.warpAffine(
                mask[i],
                np.asarray(mat),
                (int(heatmap_size[0]), int(heatmap_size[1])),
                flags=cv2.INTER_NEAREST,
            )
            mask_list.append(warped_mask)
            keypoints[i, :, :, 0:2] = warp_affine_joints(keypoints[i, :, :, 0:2], mat)

        scale = self._get_scale(img_scale, image_size)
        mat = get_affine_transform(
            center=center,
            scale=scale / pixel_std,
            rot=aug_rot,
            output_size=image_size,
            pixel_std=pixel_std,
        )
        image = cv2.warpAffine(
            image,
            np.asarray(mat),
            (int(image_size[0]), int(image_size[1])),
            flags=cv2.INTER_LINEAR,
        )
        mask = np.stack(pad_to_same(mask_list))
        return dict(image=image, mask=mask, keypoints=keypoints)



@register("transform", extra_name="bottomup_generate_target")
class BottomUpGenerateTarget(BottomUpTransform):
    """Multi-level Gaussian heatmaps (per-pixel max) + AE tag indices.

    Targets are [S, Hmax, Wmax, K]; tag_ind is [S, max_num, K, 2] with
    (flat index into that level's H*W, valid flag).
    """

    def __init__(
        self,
        is_train: bool = True,
        config: Optional[Dict[str, Any]] = None,
        sigma: float = 2.0,
        max_num: int = 30,
    ) -> None:
        super().__init__(is_train=is_train, config=config)
        self.sigma = sigma
        self.max_num = max_num

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        target_list, tag_ind_list = [], []
        for keypoint, heatmap_size in zip(
            state["keypoints"], self._transform_cfg["heatmap_sizes"]
        ):
            target, tag_ind = self._generate_heatmap_and_tag_ind(
                keypoint, heatmap_size
            )
            target_list.append(target)
            tag_ind_list.append(tag_ind)

        target_list = pad_to_same(target_list)
        # [S, H, W, K] and [S, max_num, K, 2]
        target = np.stack([t.transpose(1, 2, 0) for t in target_list])
        tag_ind = np.stack(tag_ind_list)
        return dict(target=np.ascontiguousarray(target), tag_ind=tag_ind)

    def _generate_heatmap_and_tag_ind(self, keypoints, heatmap_size):
        """Vectorized Gaussian rasterization over all (instance, joint) points.

        Every visible point contributes a size x size sub-pixel-centered
        Gaussian patch, scatter-maxed into a canvas padded by `size` on each
        side; cropping the canvas back to [h, w] reproduces the reference's
        per-patch boundary clipping bit-exactly while replacing its
        per-point Python loop.
        """
        w, h = heatmap_size
        m, k, _ = keypoints.shape
        if m > self.max_num:
            raise ValueError(
                f"Number of instances in one image `{m}` exceeds the maximum "
                f"num: `{self.max_num}`"
            )
        tag_per_joint = self._transform_cfg["tag_per_joint"]
        tag_shape = (self.max_num, k, 2) if tag_per_joint else (self.max_num, 2)
        tag_ind = np.zeros(tag_shape, dtype=np.int32)

        # window bookkeeping keeps the reference's float tmp_size semantics
        # (for fractional sigma*3, int() truncation makes ul/br asymmetric
        # around zero — replicated below)
        tmp_size = self.sigma * 3
        # float size semantics (matches the reference's np.arange(0, size)
        # kernel): the patch has ceil(size) samples and its peak index is the
        # float floor-half — one sample longer than int(size) for fractional
        # sigma
        size_f = 2 * tmp_size + 1
        size = int(np.ceil(size_f))
        x0 = size_f // 2
        target = np.zeros((k, h, w), dtype=np.float32)
        if m == 0:
            return target, tag_ind

        pts = keypoints.reshape(-1, 3)  # keep incoming dtype (ref arithmetic)
        inst_ids, joint_ids = np.divmod(np.arange(m * k), k)
        mu = np.rint(pts[:, :2]).astype(np.int64)  # (x, y) rounded half-to-even
        ul = np.trunc(mu - tmp_size).astype(np.int64)  # int() = trunc-toward-0
        br = np.trunc(mu + tmp_size + 1).astype(np.int64)
        # same rejection as the reference: keep patches overlapping the map
        sel = (
            (pts[:, 2] > 0)
            & (ul[:, 0] < w)
            & (ul[:, 1] < h)
            & (br[:, 0] >= 0)
            & (br[:, 1] >= 0)
        )
        if sel.any():
            mu_s = mu[sel]
            pt_s = pts[sel]
            joint_s = joint_ids[sel]
            ul_s = ul[sel]
            ext = br[sel] - ul_s  # patch extent; < size when trunc is asymmetric
            grid = np.arange(size, dtype=np.float32)
            # patch-local sub-pixel centers, in the keypoints' own dtype and
            # association order (the ref computes `(x0 + pt[0]) - mu_x`)
            fx = (x0 + pt_s[:, 0]) - mu_s[:, 0].astype(pts.dtype)
            fy = (x0 + pt_s[:, 1]) - mu_s[:, 1].astype(pts.dtype)
            dx2 = np.square(grid[None, :] - fx[:, None])  # [n, size]
            dy2 = np.square(grid[None, :] - fy[:, None])
            g = np.exp(
                -(dx2[:, None, :] + dy2[:, :, None]) / (2 * self.sigma**2)
            )  # [n, size, size]
            # zero out columns/rows past br-ul (a no-op under scatter-max)
            idx = np.arange(size)
            g = g * (idx[None, :] < ext[:, 0, None])[:, None, :]
            g = g * (idx[None, :] < ext[:, 1, None])[:, :, None]

            pad = size + 2
            hp, wp = h + 2 * pad, w + 2 * pad
            canvas = np.zeros((k, hp, wp), dtype=np.float32)
            yy = (ul_s[:, 1] + pad)[:, None] + idx
            xx = (ul_s[:, 0] + pad)[:, None] + idx
            flat = (
                (joint_s[:, None, None] * hp + yy[:, :, None]) * wp
                + xx[:, None, :]
            )
            np.maximum.at(canvas.reshape(-1), flat.ravel(), g.ravel())
            target = np.ascontiguousarray(
                canvas[:, pad : pad + h, pad : pad + w]
            )

        # AE tag indices for points whose rounded center lands inside the map
        tin = (
            (pts[:, 2] > 0)
            & (mu[:, 0] >= 0)
            & (mu[:, 0] < w)
            & (mu[:, 1] >= 0)
            & (mu[:, 1] < h)
        )
        flat_pos = (mu[tin, 1] * w + mu[tin, 0]).astype(np.int32)
        if tag_per_joint:
            tag_ind[inst_ids[tin], joint_ids[tin], 0] = flat_pos
            tag_ind[inst_ids[tin], joint_ids[tin], 1] = 1
        else:
            tag_ind[inst_ids[tin], 0] = flat_pos
            tag_ind[inst_ids[tin], 1] = 1

        return target, tag_ind



@register("transform", extra_name="bottomup_pad")
class BottomUpPad(BottomUpTransform):
    """Pad to max_image_size and emit a validity mask."""

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        image = state["image"]
        height, width = image.shape[:2]
        target_width, target_height = self._transform_cfg["max_image_size"]
        if width < height:
            target_height, target_width = target_width, target_height
        assert target_width >= width and target_height >= height

        image = np.pad(
            image, ((0, target_height - height), (0, target_width - width), (0, 0))
        )
        mask = np.zeros((target_height, target_width), dtype=np.uint8)
        mask[:height, :width] = 1
        return dict(image=image, mask=mask)


@register("transform", extra_name="bottomup_generate_tag_ind")
class BottomUpGenerateTagInd(BottomUpGenerateTarget):
    """Device-pipeline variant of BottomUpGenerateTarget: compute only the
    AE tag indices and pad keypoints to ``max_num``; the multi-level Gaussian
    targets render on device (ops/target.generate_bottomup_targets) from the
    shipped keypoints. Same tag semantics as the host encode (rint centers,
    in-map test, flat H*W index).
    """

    def transform(self, state: Dict[str, Any]) -> Dict[str, Any]:
        keypoints = np.asarray(state["keypoints"], dtype=np.float32)
        s, m, k, _ = keypoints.shape
        if m > self.max_num:
            raise ValueError(
                f"Number of instances in one image `{m}` exceeds the maximum "
                f"num: `{self.max_num}`"
            )
        tag_per_joint = self._transform_cfg["tag_per_joint"]
        tag_shape = (
            (s, self.max_num, k, 2) if tag_per_joint else (s, self.max_num, 2)
        )
        tag_ind = np.zeros(tag_shape, dtype=np.int32)
        padded = np.zeros((s, self.max_num, k, 3), dtype=np.float32)
        padded[:, :m] = keypoints

        for lvl, heatmap_size in enumerate(
            self._transform_cfg["heatmap_sizes"]
        ):
            w, h = int(heatmap_size[0]), int(heatmap_size[1])
            pts = keypoints[lvl].reshape(-1, 3)
            inst_ids, joint_ids = np.divmod(np.arange(m * k), k)
            mu = np.rint(pts[:, :2]).astype(np.int64)
            tin = (
                (pts[:, 2] > 0)
                & (mu[:, 0] >= 0) & (mu[:, 0] < w)
                & (mu[:, 1] >= 0) & (mu[:, 1] < h)
            )
            flat_pos = (mu[tin, 1] * w + mu[tin, 0]).astype(np.int32)
            if tag_per_joint:
                tag_ind[lvl, inst_ids[tin], joint_ids[tin], 0] = flat_pos
                tag_ind[lvl, inst_ids[tin], joint_ids[tin], 1] = 1
            else:
                tag_ind[lvl, inst_ids[tin], 0] = flat_pos
                tag_ind[lvl, inst_ids[tin], 1] = 1

        return dict(keypoints=padded, tag_ind=tag_ind)
