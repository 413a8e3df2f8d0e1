"""Bottom-up heatmap + associative-embedding decoder.

Counterpart of mindpose_tpu/models/decoders/bottom_up_decoder.py for NCHW
outputs, in plain PyTorch on the outputs' device: multi-resolution
aggregation, tag resize and stack, the validity mask, max-pool NMS, per-joint
top-K with the tags gathered there, and the optional quarter-pixel shift.
"""
import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ...register import register
from ..common import resize_bilinear, resize_nearest
from .decoder import Decoder


@register("decoder", extra_name="bottomup_heatmap_ae")
@dataclasses.dataclass(frozen=True)
class BottomUpHeatMapAEDecoder(Decoder):
    """Decode multi-level NCHW outputs into top-K candidates per joint.

    Inputs: model_output, a list of [N, K(+K tags), H_s, W_s] tensors (one
    per stage); mask [N, H_img, W_img], the padded image's validity mask.

    Outputs, float32 on the inputs' device. The candidates keep the JAX
    decoder's shapes, which the tag grouping reads: val_k [N, K, M],
    tag_k [N, K, M, L], ind_k [N, K, M, 2 (x, y)]. The maps are NCHW where
    JAX's are NHWC: heatmap [N, K, H, W] (before NMS) and tagging_heatmap
    [N, K_tag, L, H, W].

    Top-K ties go to the lower flat index, as ``jax.lax.top_k`` gives them
    (a stable descending sort): after NMS most of a heatmap is exactly 0.
    The candidates are contiguous, as the grouping kernel takes them.
    """

    num_joints: int = 17
    num_stages: int = 2
    with_ae_loss: Sequence[bool] = (True, False)
    use_nms: bool = False
    nms_kernel: int = 5
    max_num: int = 30
    tag_per_joint: bool = True
    shift_coordinate: bool = False

    def __call__(self, model_output: List[torch.Tensor], mask: torch.Tensor):
        heatmaps, tagging_heatmaps = self.decouple_output(model_output)
        return self.decode(heatmaps, tagging_heatmaps, mask)

    def decouple_output(self, output: List[torch.Tensor]):
        """Split each stage's channels into heatmaps and tag maps, in float32."""
        heatmaps, tagging_heatmaps = [], []
        for i in range(self.num_stages):
            heatmaps.append(output[i][:, : self.num_joints].float())
            if self.with_ae_loss[i]:
                tagging_heatmaps.append(output[i][:, self.num_joints:].float())
        return heatmaps, tagging_heatmaps

    def decode(
        self,
        heatmaps: List[torch.Tensor],
        tagging_heatmaps: List[torch.Tensor],
        mask: torch.Tensor,
    ):
        heatmap, tagging_heatmap = self._parse_heatmaps(heatmaps, tagging_heatmaps, mask)
        heatmap_raw = heatmap
        if self.use_nms:
            heatmap = self._nms(heatmap)
        val_k, tag_k, ind_k, idx = self._get_max_preds(heatmap, tagging_heatmap)
        if self.shift_coordinate:
            ind_k = self._shift(ind_k, heatmap_raw, idx)
        return val_k, tag_k, ind_k, heatmap_raw, tagging_heatmap

    def _parse_heatmaps(self, heatmaps, tagging_heatmaps, mask):
        # mean-aggregate the levels at the largest resolution
        base = heatmaps[-1]
        h, w = base.shape[2:]
        if len(heatmaps) > 1:
            acc = base
            for hm in heatmaps[:-1]:
                acc = acc + resize_bilinear(hm, h, w)
            heatmap = acc / len(heatmaps)
        else:
            heatmap = base
        tags = [resize_bilinear(t, h, w) for t in tagging_heatmaps]
        tagging_heatmap = torch.stack(tags, dim=2)  # [N, K_tag, L, H, W]
        mask = resize_nearest(mask[:, None].float(), h, w)
        return heatmap * mask, tagging_heatmap

    def _nms(self, heatmap: torch.Tensor) -> torch.Tensor:
        """Keep only the maxima of their k x k window, padded with -inf as
        ``reduce_window``'s "SAME" pads (the extra row and column after,
        where k is even)."""
        k = self.nms_kernel
        lo = (k - 1) // 2
        hi = k - 1 - lo
        pooled = F.max_pool2d(F.pad(heatmap, (lo, hi, lo, hi), value=float("-inf")), k, stride=1)
        return torch.where(pooled == heatmap, heatmap, 0.0)

    def _get_max_preds(self, heatmap, tagging_heatmap):
        n, k, h, w = heatmap.shape
        flat = heatmap.reshape(n, k, h * w)
        val_k, idx = torch.sort(flat, dim=2, descending=True, stable=True)
        val_k = val_k[..., : self.max_num].contiguous()  # [N, K, M]
        idx = idx[..., : self.max_num].contiguous()

        kt, l = tagging_heatmap.shape[1:3]
        tag_flat = tagging_heatmap.reshape(n, kt, l, h * w)
        if not self.tag_per_joint:
            tag_flat = tag_flat.expand(n, k, l, h * w)
        tag_k = torch.gather(tag_flat, 3, idx[:, :, None, :].expand(n, k, l, idx.shape[2]))
        tag_k = tag_k.permute(0, 1, 3, 2).contiguous()  # [N, K, M, L]

        ind_k = torch.stack([(idx % w).float(), torch.div(idx, w, rounding_mode="floor").float()],
                            dim=-1)
        return val_k, tag_k, ind_k, idx

    def _shift(self, ind_k, heatmap, idx):
        """Quarter-pixel shift of each candidate toward its larger neighbour."""
        n, k, h, w = heatmap.shape
        flat = heatmap.reshape(n, k, h * w)

        def nb(offset: int) -> torch.Tensor:
            return torch.gather(flat, 2, torch.clamp(idx + offset, 0, h * w - 1))

        x, y = ind_k[..., 0], ind_k[..., 1]
        dx = torch.where((x >= 1) & (x <= w - 2), nb(1) - nb(-1), 0.0)
        dy = torch.where((y >= 1) & (y <= h - 2), nb(w) - nb(-w), 0.0)
        return ind_k + torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25

    @staticmethod
    def maps_to_nhwc(heatmap: torch.Tensor,
                     tagging_heatmap: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoder's maps in the JAX decoder's layouts: [N, H, W, K] and [N, H, W, K, L]."""
        return heatmap.permute(0, 2, 3, 1), tagging_heatmap.permute(0, 3, 4, 1, 2)
