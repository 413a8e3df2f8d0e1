"""Bottom-up AE inferencer: the forward and the decode on the device, then the
tag grouping, the missing-joint refinement and the back-projection.

Counterpart of ``mindpose_tpu/engine/inferencer/bottomup_inferencer.py``
for NCHW outputs. Per batch: upload, NHWC -> NCHW once, the forward (with
hflip TTA the forward of the mirrored image too, mirrored back along W, its
joint channels swapped, its heatmaps averaged with the first and its tag
maps kept beside the first's, L = 2; with multi-scale TTA a forward per
scale at 64-px-aligned sizes, its heatmaps averaged at the scale-1
resolution, the tags from scale 1 only), the decoder. Then the grouping:
with ``device_grouping``, the fixed-capacity matcher (on a CUDA device the
kernel of ``ops/cuda/grouping.py``, one launch per batch; on the CPU its
plain version ``ops/grouping.py``), else the host Hungarian
(``utils/match.py``) per image. ``device_grouping`` defaults to on where the
net runs on CUDA and off on the CPU, as the JAX package's default follows
its backend; the config's key wins either way. ``refine_missing_joint``,
the scores and the back-projection run on the host in numpy, as in JAX.
The JAX inferencer's padding of a partial batch (for XLA's static shapes)
is dropped.
"""
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ...data.transform.utils import flip_index_from_pairs, transform_keypoints
from ...models.common import resize_bilinear
from ...ops import grouping as plain_grouping
from ...ops.cuda import grouping as cuda_grouping
from ...register import register
from ...utils.match import match_by_tag
from .inferencer import Inferencer


@register("inferencer", extra_name="bottomup_heatmap_ae")
class BottomUpHeatMapAEInferencer(Inferencer):
    def __init__(self, net, config=None, device=None, amp_level="O0"):
        super().__init__(net, config=config, device=device, amp_level=amp_level)
        self.decoder = net.decoder
        if not self._inference_cfg["has_heatmap_output"] and (
            self._inference_cfg["hflip_tta"] or len(self._inference_cfg["multiscale_tta"]) > 1
        ):
            raise ValueError("flip/multi-scale TTA needs heatmap output.")

    def load_inference_cfg(self) -> Dict[str, Any]:
        cfg = dict()
        cfg["has_heatmap_output"] = self.config["has_heatmap_output"]
        cfg["hflip_tta"] = self.config["hflip_tta"]
        cfg["joint_order"] = self.config["joint_order"]
        cfg["vis_thr"] = float(self.config["vis_thr"])
        cfg["ignore_too_much"] = self.config["ignore_too_much"]
        cfg["use_rounded_norm"] = self.config["use_rounded_norm"]
        cfg["tag_thr"] = float(self.config["tag_thr"])
        cfg["pixel_std"] = float(self.config["pixel_std"])
        cfg["downsample_scale"] = self.config["downsample_scale"]
        cfg["refine_missing_joint"] = self.config["refine_missing_joint"]
        cfg["device_grouping"] = self.config.get("device_grouping", self.device.type == "cuda")
        scales = tuple(
            dict.fromkeys(float(s) for s in self.config.get("multiscale_tta", (1.0,)))
        )
        if 1.0 not in scales:
            raise ValueError("multiscale_tta must include scale 1.0")
        cfg["multiscale_tta"] = scales
        cfg["flip_pairs"] = np.array(self.config["flip_pairs"])
        return cfg

    def _one_scale(self, net, image: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """One TTA run: the levels' heatmaps (merged with the mirrored image's
        under hflip) aggregated at this run's largest resolution, and the tag maps."""
        with self.precision():
            raw = net(image)
            raw_f = net(image.flip(3)) if self._inference_cfg["hflip_tta"] else None
        heatmaps, tags = self.decoder.decouple_output(raw)
        if raw_f is not None:
            f_heatmaps, f_tags = self.decoder.decouple_output(raw_f)
            # flip back: mirror width, swap left/right joints (NCHW: K is dim 1);
            # the permutation is built from the real joint count
            flip_index = torch.from_numpy(flip_index_from_pairs(
                self._inference_cfg["flip_pairs"], f_heatmaps[0].shape[1])).to(self.device)
            f_heatmaps = [h.flip(3).index_select(1, flip_index) for h in f_heatmaps]
            f_tags = [t.flip(3).index_select(1, flip_index) for t in f_tags]
            heatmaps = [(h + f) * 0.5 for h, f in zip(heatmaps, f_heatmaps)]
            tags = list(tags) + list(f_tags)  # both tag sets (L=2)
        base = heatmaps[-1]
        hb, wb = base.shape[2:]
        acc = base
        for hm in heatmaps[:-1]:
            acc = acc + resize_bilinear(hm, hb, wb)
        return acc / len(heatmaps), list(tags)

    @torch.inference_mode()
    def infer_batch(self, batch: Dict[str, Any]):
        """One loader batch (NHWC images) -> ``forward_decode``'s outputs."""
        image = self._upload(batch["image"]).permute(0, 3, 1, 2).contiguous()  # NHWC -> NCHW
        return self.forward_decode(image, self._upload(batch["mask"]))

    @torch.inference_mode()
    def forward_decode(self, image: torch.Tensor, mask: torch.Tensor):
        """Normalized NCHW images [N, 3, H, W] and their masks [N, H, W], on the
        device -> the decoder's (val_k, tag_k, ind_k, heatmap, tagging_heatmap).
        The net runs in eval mode, as the JAX package applies it with
        ``train=False``, whatever mode a train step left it in."""
        net = self.net.net.eval()
        scales = self._inference_cfg["multiscale_tta"]
        if not self._inference_cfg["hflip_tta"] and len(scales) == 1:
            with self.precision():
                raw = net(image)
            return self.decoder(raw, mask)
        height, width = image.shape[2:]
        heatmap_1, tags_1 = self._one_scale(net, image)
        h1, w1 = heatmap_1.shape[2:]
        acc = heatmap_1
        for s in scales:
            if s == 1.0:
                continue
            # keep the model's 64-px alignment when rescaling
            hs = max(64, int(round(height * s / 64)) * 64)
            ws = max(64, int(round(width * s / 64)) * 64)
            heatmap_s, _ = self._one_scale(net, resize_bilinear(image, hs, ws))
            acc = acc + resize_bilinear(heatmap_s, h1, w1)
        # a single pre-aggregated level: decode applies mask, NMS and top-K
        return self.decoder.decode([acc / len(scales)], tags_1, mask)

    def group(self, val_k: torch.Tensor, tag_k: torch.Tensor,
              ind_k: torch.Tensor) -> List[np.ndarray]:
        """Each image's persons [P, K, 3 + L] (x, y, score, tags), in the heatmap frame."""
        cfg = self._inference_cfg
        kwargs = dict(joint_order=list(cfg["joint_order"]), vis_thr=cfg["vis_thr"],
                      tag_thr=cfg["tag_thr"], ignore_too_much=cfg["ignore_too_much"],
                      use_rounded_norm=cfg["use_rounded_norm"])
        if cfg["device_grouping"]:
            if val_k.device.type == "cuda":
                groups, valid = cuda_grouping.match_by_tag_batch(val_k, tag_k, ind_k, **kwargs)
                groups, valid = groups.cpu().numpy(), valid.cpu().numpy()
            else:
                groups, valid = plain_grouping.match_by_tag_batch(
                    val_k.numpy(), tag_k.numpy(), ind_k.numpy(), **kwargs)
            return [g[v] for g, v in zip(groups, valid)]
        return [match_by_tag(v, t, i, **kwargs) for v, t, i in
                zip(val_k.cpu().numpy(), tag_k.cpu().numpy(), ind_k.cpu().numpy())]

    def infer(self, dataset) -> List[Dict[str, Any]]:
        outputs: List[Dict[str, Any]] = []
        for batch in dataset:
            preds, scores = self.persons(self.infer_batch(batch), batch)
            for pred, score, image_path in zip(preds, scores, batch["image_file"]):
                outputs.append(dict(pred=pred, score=score, image_path=str(image_path)))
        return outputs

    def persons(self, decoded, batch: Dict[str, Any]) -> Tuple[List[np.ndarray], list]:
        """``forward_decode``'s outputs -> each image's persons [P, K, 3 + L]
        in the original frame and their scores, from the batch's center,
        scale and image_shape."""
        preds, scores = self._parse(*decoded)
        preds = transform_keypoints(
            preds,
            np.asarray(batch["center"], np.float32),
            np.asarray(batch["scale"], np.float32),
            np.asarray(batch["image_shape"], np.float32) / self._inference_cfg["downsample_scale"],
            pixel_std=self._inference_cfg["pixel_std"],
        )
        return preds, scores

    def _parse(self, val_k, tag_k, ind_k, heatmap, tagging_heatmap):
        """Post-processing: group by tag, score, optionally refine."""
        keypoints = self.group(val_k, tag_k, ind_k)
        scores = [[y[:, 2].mean() for y in x] for x in keypoints]
        if self._inference_cfg["refine_missing_joint"]:
            heatmap, tagging_heatmap = (
                t.cpu().numpy() for t in self.decoder.maps_to_nhwc(heatmap, tagging_heatmap))
            for i in range(len(keypoints)):
                for j in range(len(keypoints[i])):
                    keypoints[i][j] = self._refine_missing(
                        heatmap[i], tagging_heatmap[i], keypoints[i][j]
                    )
        return keypoints, scores

    def _refine_missing(
        self, heatmap: np.ndarray, tagging_heatmap: np.ndarray, keypoints: np.ndarray
    ) -> np.ndarray:
        """Fill undetected joints by tag-distance-penalized argmax (a copy of
        the JAX inferencer's, NHWC: heatmap [H, W, K], tagging_heatmap
        [H, W, K, L], keypoints [K, 3+L])."""
        h, w, k = heatmap.shape

        tags = []
        location = keypoints[:, :2].astype(np.int32)
        for i in range(k):
            if keypoints[i, 2] > 0:
                x, y = location[i]
                tags.append(tagging_heatmap[y, x, i])
        if not tags:
            return keypoints
        mean_tag = np.mean(tags, axis=0)

        dist = np.linalg.norm(tagging_heatmap - mean_tag[None, None, None, :], axis=3)
        dist = np.round(dist)  # [H, W, K]

        score = heatmap - dist
        flat = score.transpose(2, 0, 1).reshape(k, -1)
        max_loc = np.argmax(flat, axis=1)
        ys, xs = np.unravel_index(max_loc, (h, w))
        ys_int, xs_int = ys.copy(), xs.copy()
        xs = xs.astype(np.float32) + 0.5
        ys = ys.astype(np.float32) + 0.5

        for i in range(k):
            xx, yy = xs_int[i], ys_int[i]
            if heatmap[yy, min(xx + 1, w - 1), i] > heatmap[yy, max(xx - 1, 0), i]:
                xs[i] += 0.25
            else:
                xs[i] -= 0.25
            if heatmap[min(yy + 1, h - 1), xx, i] > heatmap[max(0, yy - 1), xx, i]:
                ys[i] += 0.25
            else:
                ys[i] -= 0.25

        vals = heatmap[ys_int, xs_int, np.arange(k)]
        full = np.stack((xs, ys, vals), axis=1)
        for i in range(k):
            if full[i, 2] > 0 and keypoints[i, 2] == 0:
                keypoints[i, :3] = full[i]
        return keypoints
