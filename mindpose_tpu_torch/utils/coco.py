"""COCO annotation container, in numpy: a copy of the JAX package's.

Copies of ``mindpose_tpu/utils/coco.py``: ``image_id_name_maps``, the
``COCO`` index with its pycocotools-named query API and ``loadRes``, and
the segmentation codecs that the bottom-up training masks read (:37-218):
RLE (uncompressed and compressed counts; the numpy path of ``decode_rle``,
not the JAX package's native one, which gives the same bytes) and polygons
(``rle_counts_from_poly``, pycocotools' rasterization). tests/
test_torch_eval_copies.py holds the index equal to its original,
tests/test_torch_bottomup_train_data.py the codecs.
"""
import copy
import json
from collections import defaultdict
from typing import Any, Dict, List, Optional, Union

import numpy as np

__all__ = [
    "COCO",
    "decode_rle",
    "poly_to_mask",
    "rle_counts_from_poly",
    "annotation_to_mask",
    "image_id_name_maps",
]


def image_id_name_maps(imgs: Dict[int, Dict]) -> tuple:
    """Build (id -> file_name, file_name -> id) maps from COCO image records."""
    id2name = {image_id: meta["file_name"] for image_id, meta in imgs.items()}
    name2id = {name: image_id for image_id, name in id2name.items()}
    return id2name, name2id


def decode_rle(rle: Dict[str, Any]) -> np.ndarray:
    """Decode an RLE dict {'counts': ..., 'size': [h, w]} into an HxW uint8 mask.

    Supports uncompressed counts (list of run lengths, column-major starting
    with background) and the compressed LEB128-style string format used by the
    COCO API.
    """
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_compressed_counts(
            counts.encode("ascii") if isinstance(counts, str) else counts
        )
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE counts sum {total} != h*w {h * w}")

    # runs alternate 0-run, 1-run, ... in column-major (Fortran) order
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1
    mask = np.repeat(vals, counts)
    return mask.reshape((w, h)).T  # column-major -> HxW


def _decode_compressed_counts(s: bytes) -> List[int]:
    """COCO API compressed RLE: 6-bit varint with delta coding for runs > 2."""
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: List[int]) -> bytes:
    """Inverse of _decode_compressed_counts (for writing result files)."""
    out = bytearray()
    for j, x in enumerate(counts):
        if j > 2:
            x -= counts[j - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def rle_counts_from_poly(xy, height: int, width: int) -> List[int]:
    """COCO polygon -> uncompressed RLE counts, exact pycocotools semantics.

    Numpy port of rleFrPoly (cocoapi maskApi.c, BSD-2-Clause, (c) Piotr
    Dollar & Tsung-Yi Lin): 5x-upsample the boundary, walk every edge with
    the same trunc(v + 0.5) rounding as the C code, keep the column-change
    boundary points whose downsampled x is integral, and diff/merge the
    sorted column-major positions into alternating (0s, 1s, ...) run
    lengths (cv2.fillPoly's boundary-pixel convention differs from
    pycocotools on polygon edges). The bottom-up training masks
    (data/dataset/coco_bottomup.py) feed through here. Float ops are IEEE
    double exactly as in C, so the output is bit-identical to pycocotools
    frPyObjects.
    """
    h, w = height, width
    xy = np.asarray(xy, np.float64).ravel()
    k = len(xy) // 2
    scale = 5.0
    # C: x[j] = (int)(scale*xy[2j] + .5) — trunc toward zero
    x = np.trunc(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])
    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0  # dx==dy==0: repeated vertex
            d = np.arange(dx + 1, dtype=np.int64)
            t = (dx - d) if flip else d
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy
            d = np.arange(dy + 1, dtype=np.int64)
            t = (dy - d) if flip else d
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)
    # boundary points: consecutive column changes along the dense walk
    chg = u[1:] != u[:-1]
    uj, uprev = u[1:][chg], u[:-1][chg]
    vj, vprev = v[1:][chg], v[:-1][chg]
    xd = np.where(uj < uprev, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    xd = xd[keep]
    yd = np.minimum(vj, vprev)[keep].astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0, h))
    a = (xd.astype(np.int64) * h + yd.astype(np.int64)).astype(np.uint32)
    a = np.sort(np.append(a, np.uint32(h * w)))
    a = np.diff(np.concatenate([[np.uint32(0)], a])).astype(np.int64)
    # merge runs: a zero diff toggles parity back, so fold the next value
    # into the previous run
    b = [int(a[0])]
    j, n = 1, len(a)
    while j < n:
        if a[j] > 0:
            b.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < n:
                b[-1] += int(a[j])
                j += 1
    return b


def _mask_from_counts(counts: List[int], height: int, width: int) -> np.ndarray:
    """Alternating (0s, 1s, ...) column-major run lengths -> HxW mask."""
    flat = np.zeros(height * width, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((width, height)).T


def poly_to_mask(polys: List[List[float]], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation(s) into an HxW uint8 mask.

    Union over polygons, each rasterized with the exact pycocotools
    scanline (rle_counts_from_poly) — matches frPyObjects + merge +
    decode bit-for-bit.
    """
    mask = np.zeros((height, width), dtype=np.uint8)
    for p in polys:
        if len(p) >= 6:
            counts = rle_counts_from_poly(p, height, width)
            mask |= _mask_from_counts(counts, height, width)
    return mask


def annotation_to_mask(
    segmentation: Union[List, Dict[str, Any]], height: int, width: int
) -> np.ndarray:
    """Segmentation (polygon list or RLE dict) -> HxW uint8 mask."""
    if isinstance(segmentation, dict):
        return decode_rle(segmentation)
    return poly_to_mask(segmentation, height, width)


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
