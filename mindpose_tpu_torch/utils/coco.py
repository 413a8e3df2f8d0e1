"""COCO annotation container, in numpy: a copy of the JAX package's.

Copies of ``mindpose_tpu/utils/coco.py``: ``image_id_name_maps`` and the
``COCO`` index with its pycocotools-named query API and ``loadRes``. The
segmentation codecs (RLE, polygons) are left out: the keypoint metric and
the top-down datasets do not read masks. tests/test_torch_eval_copies.py
holds the copy equal to its original.
"""
import copy
import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Union

import numpy as np

__all__ = ["COCO", "image_id_name_maps"]


def image_id_name_maps(imgs: Dict[int, Dict]) -> tuple:
    """Build (id -> file_name, file_name -> id) maps from COCO image records."""
    id2name = {image_id: meta["file_name"] for image_id, meta in imgs.items()}
    name2id = {name: image_id for image_id, name in id2name.items()}
    return id2name, name2id


class COCO:
    """Indexed view over a COCO-format annotation file (or dict)."""

    def __init__(self, annotation_file: Optional[Union[str, Dict]] = None) -> None:
        self.dataset: Dict[str, Any] = {}
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.imgToAnns: Dict[int, List[Dict]] = defaultdict(list)
        self.catToImgs: Dict[int, List[int]] = defaultdict(list)

        if annotation_file is not None:
            if isinstance(annotation_file, str):
                with open(annotation_file, "r") as f:
                    dataset = json.load(f)
            else:
                dataset = annotation_file
            if not isinstance(dataset, dict):
                raise ValueError("annotation file format not supported")
            self.dataset = dataset
            self.createIndex()

    def createIndex(self) -> None:
        anns, cats, imgs = {}, {}, {}
        img_to_anns = defaultdict(list)
        cat_to_imgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            img_to_anns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            if "category_id" in ann:
                cat_to_imgs[ann["category_id"]].append(ann["image_id"])
        self.anns = anns
        self.imgs = imgs
        self.cats = cats
        self.imgToAnns = img_to_anns
        self.catToImgs = cat_to_imgs

    # ---- query API (pycocotools-compatible surface) ----

    def getImgIds(self, imgIds=None, catIds=None) -> List[int]:
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if not imgIds and not catIds:
            return list(self.imgs.keys())
        ids = set(imgIds) if imgIds else None
        for cat_id in catIds:
            cat_imgs = set(self.catToImgs[cat_id])
            ids = cat_imgs if ids is None else ids & cat_imgs
        return list(ids or [])

    def getAnnIds(self, imgIds=None, catIds=None, areaRng=None, iscrowd=None):
        imgIds = _as_list(imgIds)
        catIds = _as_list(catIds)
        if imgIds:
            anns = [a for img_id in imgIds for a in self.imgToAnns[img_id]]
        else:
            anns = list(self.anns.values())
        if catIds:
            cat_set = set(catIds)
            anns = [a for a in anns if a["category_id"] in cat_set]
        if areaRng:
            anns = [a for a in anns if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == int(iscrowd)]
        return [a["id"] for a in anns]

    def getCatIds(self, catNms=None, supNms=None, catIds=None) -> List[int]:
        catNms, supNms, catIds = _as_list(catNms), _as_list(supNms), _as_list(catIds)
        cats = list(self.cats.values())
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def loadAnns(self, ids=None) -> List[Dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadImgs(self, ids=None) -> List[Dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    def loadCats(self, ids=None) -> List[Dict]:
        return [self.cats[i] for i in _as_list(ids)]

    def loadRes(self, resFile: Union[str, List[Dict]]) -> "COCO":
        """Build a result COCO from a keypoint-result json (list of dicts).

        Mirrors pycocotools.COCO.loadRes for the keypoints task: bbox/area are
        derived from the keypoint extent.
        """
        res = COCO()
        res.dataset["images"] = [img for img in self.dataset.get("images", [])]
        if isinstance(resFile, str):
            with open(resFile, "r") as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        if not isinstance(anns, list):
            raise ValueError("results must be a list")
        if anns:
            anns_img_ids = set(a["image_id"] for a in anns)
            if not anns_img_ids <= set(self.getImgIds()):
                raise ValueError("Results reference unknown image ids")
        for ann_id, ann in enumerate(anns):
            if "keypoints" in ann:
                s = ann["keypoints"]
                x = s[0::3]
                y = s[1::3]
                x0, x1 = min(x), max(x)
                y0, y1 = min(y), max(y)
                ann["area"] = (x1 - x0) * (y1 - y0)
                ann.setdefault("bbox", [x0, y0, x1 - x0, y1 - y0])
            ann["id"] = ann_id + 1
            ann.setdefault("iscrowd", 0)
        res.dataset["categories"] = copy.deepcopy(self.dataset.get("categories", []))
        res.dataset["annotations"] = anns
        res.createIndex()
        return res


def _as_list(x) -> List:
    if x is None:
        return []
    if isinstance(x, (list, tuple, np.ndarray)):
        return list(x)
    return [x]
