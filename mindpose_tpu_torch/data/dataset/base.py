"""Shared record-dataset skeleton: a copy of ``mindpose_tpu/data/dataset/base.py``.

Datasets are indexable lists of per-sample record dicts built once at
construction. tests/test_torch_eval_copies.py holds the datasets built on it
equal to their originals.
"""
import logging
from typing import Any, Dict, List, Optional


class RecordDataset:
    """Builds ``self._dataset`` via the subclass's ``load_dataset`` hook."""

    def __init__(
        self,
        image_root: str,
        annotation_file: Optional[str] = None,
        is_train: bool = False,
        num_joints: int = 17,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.image_root, self.annotation_file = image_root, annotation_file
        self.is_train, self.num_joints = is_train, num_joints
        self.config = dict(config) if config else {}
        self._dataset_cfg = self.load_dataset_cfg()
        self._dataset = self.load_dataset()
        logging.info("Number of records in dataset: %d", len(self._dataset))

    def load_dataset_cfg(self) -> Dict[str, Any]:
        raise NotImplementedError  # subclass contract

    def load_dataset(self) -> List[Dict[str, Any]]:
        raise NotImplementedError  # subclass contract

    def __len__(self) -> int:
        return len(self._dataset)
