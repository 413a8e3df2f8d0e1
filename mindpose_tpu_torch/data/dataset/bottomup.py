"""Bottom-up dataset base: per-image records. Counterpart of ``mindpose_tpu/data/dataset/bottomup.py``.

Masks are kept packed as bits in the record store and unpacked in
``__getitem__``, as the JAX dataset keeps them.
"""
from typing import Any, Dict

import numpy as np

from .base import RecordDataset


class BottomUpDataset(RecordDataset):
    """Indexable dataset of per-image records.

    Train record keys: image_file, boxes [M, 2, 2] (xyxy), keypoints
    [levels, M, K, 3], mask [levels, H, W] (unpacked). Val record keys:
    image_file only (the transforms add the rest).
    """

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        record = self._dataset[idx]
        state: Dict[str, Any] = {"image_file": record["image_file"]}
        if self.is_train:
            mask_info = record["mask_info"]
            mask = np.unpackbits(
                mask_info["encoded_mask"], count=mask_info["count"]
            ).reshape(mask_info["shape"])
            state["boxes"] = np.asarray(record["boxes"], dtype=np.float32)
            state["keypoints"] = np.asarray(record["keypoints"], dtype=np.float32)
            state["mask"] = np.asarray(mask, dtype=np.uint8)
        return state
