"""Bottom-up dataset base: per-image records. Counterpart of ``mindpose_tpu/data/dataset/bottomup.py``.

At evaluation a record is its ``image_file`` alone; the transforms add the
rest. The training records (keypoints per heatmap level, boxes and the
bit-packed validity mask) come with bottom-up training.
"""
from typing import Any, Dict

from .base import RecordDataset


class BottomUpDataset(RecordDataset):
    """Indexable dataset of per-image records (val record keys: image_file)."""

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return {"image_file": self._dataset[idx]["image_file"]}
