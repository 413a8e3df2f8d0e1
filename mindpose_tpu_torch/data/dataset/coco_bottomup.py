"""COCO bottom-up dataset, the evaluation records: one per image.

Counterpart of ``mindpose_tpu/data/dataset/coco_bottomup.py`` (:20) at
``is_train=False``. The val columns (``data/column_names.py``) read no
``mask_info``, so the port builds each image's record without the validity
mask (:75, ``_validity_mask``) and without the keypoints and boxes only
training reads. Training records, with the RLE and polygon rasterization
they need (``mindpose_tpu/utils/coco.py:37-218``), come with bottom-up
training and raise until then. tests/test_torch_eval_copies.py holds the
records equal to the JAX dataset's.
"""
import os
from typing import Any, Dict, List

from ...register import register
from ...utils.coco import COCO, image_id_name_maps
from ..transform.bottomup_transform import TRAINING_ITEM
from .bottomup import BottomUpDataset


@register("dataset", extra_name="coco_bottomup")
class COCOBottomUpDataset(BottomUpDataset):
    def load_dataset_cfg(self) -> Dict[str, Any]:
        if self.is_train:
            raise NotImplementedError(
                f"coco_bottomup training records are not ported yet ({TRAINING_ITEM})")
        return {}

    def load_dataset(self) -> List[Dict[str, Any]]:
        self.coco = COCO(self.annotation_file)
        self.id2name, self.name2id = image_id_name_maps(self.coco.imgs)
        self.img_ids = self.coco.getImgIds()
        return [{"image_file": os.path.join(self.image_root, self.id2name[img_id])}
                for img_id in self.img_ids]
