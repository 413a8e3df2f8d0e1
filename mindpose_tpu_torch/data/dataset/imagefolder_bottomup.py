"""Demo dataset: glob an image folder for bottom-up inference.

Counterpart of ``mindpose_tpu/data/dataset/imagefolder_bottomup.py``, with
the same registry name, records and file filter: one record per image
file, sorted by path, evaluation only.
"""
import glob
import os
from typing import Any, Dict, List, Optional

from ...register import register
from .bottomup import BottomUpDataset

_IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


@register("dataset", extra_name="imagefolder_bottomup")
class ImageFolderBottomUpDataset(BottomUpDataset):
    def __init__(
        self,
        image_root: str,
        annotation_file: Optional[str] = None,
        is_train: bool = False,
        num_joints: int = 17,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        if is_train:
            raise ValueError("ImageFolderBottomUpDataset supports evaluation only.")
        super().__init__(
            image_root,
            annotation_file=annotation_file,
            is_train=is_train,
            num_joints=num_joints,
            config=config,
        )

    def load_dataset_cfg(self) -> Dict[str, Any]:
        return dict()

    def load_dataset(self) -> List[Dict[str, Any]]:
        return [{"image_file": p} for p in self._search_images(self.image_root)]

    @staticmethod
    def _search_images(image_root: str) -> List[str]:
        files = sorted(glob.glob(os.path.join(image_root, "*")))
        return [
            f for f in files if os.path.splitext(f)[1].lower() in _IMG_EXTENSIONS
        ]
