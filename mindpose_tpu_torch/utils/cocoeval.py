"""COCO keypoint (OKS) evaluation in numpy: a copy of the JAX package's.

Copy of ``mindpose_tpu/utils/cocoeval.py`` (``COCOeval``, ``Params``), the
pycocotools-free COCO keypoint protocol: OKS matching at IoU thresholds
0.50:0.05:0.95, areas {all, medium, large}, maxDets=20, 101-point
interpolated AP. ``computeOks`` takes each gt's OKS row from the C++
library (``csrc/coco_native.cpp`` through ``utils/native.py``), as the
original does; its numpy loop runs only where the caller turned the library
off (``MINDPOSE_NATIVE=0``), and gives the same numbers within 1e-9. Method and variable names mirror pycocotools' cocoeval.py
((c) Piotr Dollar & Tsung-Yi Lin, BSD-2-Clause). tests/test_torch_eval_copies.py
holds the copy equal to its original.
"""
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

__all__ = ["COCOeval", "COCO_SIGMAS"]

COCO_SIGMAS = (
    np.array(
        [
            0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72,
            0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89,
        ]
    )
    / 10.0
)


class Params:
    def __init__(self, kpt_sigmas: Optional[np.ndarray] = None) -> None:
        self.imgIds: List[int] = []
        self.catIds: List[int] = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.0, 101)
        self.maxDets = [20]
        self.areaRng = [
            [0**2, 1e5**2],
            [32**2, 96**2],
            [96**2, 1e5**2],
        ]
        self.areaRngLbl = ["all", "medium", "large"]
        self.useCats = 1
        self.kpt_oks_sigmas = (
            np.asarray(kpt_sigmas) if kpt_sigmas is not None else COCO_SIGMAS
        )
        self.useSegm = None


class COCOeval:
    """OKS keypoint evaluation over (gt COCO, dt COCO)."""

    def __init__(self, cocoGt, cocoDt, iouType: str = "keypoints") -> None:
        if iouType != "keypoints":
            raise ValueError("only the keypoints task is implemented")
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params()
        self.params.imgIds = sorted(cocoGt.getImgIds())
        self.params.catIds = sorted(cocoGt.getCatIds())
        self.evalImgs: Dict = {}
        self.eval: Dict = {}
        self.stats = np.zeros(10)
        self.ious: Dict = {}

    # ------------------------------------------------------------------ #

    def _prepare(self) -> None:
        p = self.params
        gts = self.cocoGt.loadAnns(
            self.cocoGt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
        )
        dts = self.cocoDt.loadAnns(
            self.cocoDt.getAnnIds(imgIds=p.imgIds, catIds=p.catIds)
        )
        for gt in gts:
            gt["ignore"] = gt.get("ignore", 0) or gt.get("iscrowd", 0)
            # keypoint task: gts with no labelled keypoints are ignore-only
            gt["ignore"] = gt["ignore"] or gt.get("num_keypoints", 0) == 0
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for gt in gts:
            self._gts[gt["image_id"], gt["category_id"]].append(gt)
        for dt in dts:
            self._dts[dt["image_id"], dt["category_id"]].append(dt)

    def computeOks(self, imgId: int, catId: int) -> np.ndarray:
        p = self.params
        gts = self._gts[imgId, catId]
        dts = sorted(
            self._dts[imgId, catId], key=lambda d: -d["score"]
        )[: p.maxDets[-1]]
        if len(gts) == 0 or len(dts) == 0:
            return np.zeros((len(dts), len(gts)))

        sigmas = p.kpt_oks_sigmas
        variances = (sigmas * 2) ** 2
        k = len(sigmas)

        from .native import compute_oks_row

        dt_arr = np.ascontiguousarray(
            [np.asarray(d["keypoints"], np.float64) for d in dts]
        )

        ious = np.zeros((len(dts), len(gts)))
        for j, gt in enumerate(gts):
            g = np.array(gt["keypoints"])
            native_row = compute_oks_row(
                g, dt_arr, gt["area"], np.asarray(gt["bbox"], np.float64),
                variances,
            )
            if native_row is not None:
                ious[:, j] = native_row
                continue
            xg, yg, vg = g[0::3], g[1::3], g[2::3]
            k1 = np.count_nonzero(vg > 0)
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            for i, dt in enumerate(dts):
                d = np.array(dt["keypoints"])
                xd, yd = d[0::3], d[1::3]
                if k1 > 0:
                    dx = xd - xg
                    dy = yd - yg
                else:
                    # distance to the doubled gt box for unlabelled gts
                    z = np.zeros(k)
                    dx = np.max((z, x0 - xd), axis=0) + np.max((z, xd - x1), axis=0)
                    dy = np.max((z, y0 - yd), axis=0) + np.max((z, yd - y1), axis=0)
                e = (dx**2 + dy**2) / variances / (gt["area"] + np.spacing(1)) / 2
                if k1 > 0:
                    e = e[vg > 0]
                ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
        return ious

    def evaluateImg(self, imgId, catId, aRng, maxDet):
        p = self.params
        gts = self._gts[imgId, catId]
        dts = self._dts[imgId, catId]
        if len(gts) == 0 and len(dts) == 0:
            return None

        for gt in gts:
            gt["_ignore"] = int(
                gt["ignore"] or (gt["area"] < aRng[0] or gt["area"] > aRng[1])
            )
        gtind = np.argsort([g["_ignore"] for g in gts], kind="mergesort")
        gts = [gts[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dts], kind="mergesort")
        dts = [dts[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]

        ious = (
            self.ious[imgId, catId][:, gtind]
            if len(self.ious[imgId, catId]) > 0
            else self.ious[imgId, catId]
        )

        T = len(p.iouThrs)
        G = len(gts)
        D = len(dts)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gts])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dts):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gts):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        # gts are ignore-last; stop if we'd move from a
                        # matched non-ignore to an ignore gt
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gts[m]["id"]
                    gtm[tind, m] = d["id"]
        # unmatched dts outside the area range are ignored
        a = np.array(
            [d["area"] < aRng[0] or d["area"] > aRng[1] for d in dts]
        ).reshape((1, len(dts)))
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0, np.repeat(a, T, 0)))
        return {
            "image_id": imgId,
            "category_id": catId,
            "aRng": aRng,
            "maxDet": maxDet,
            "dtIds": [d["id"] for d in dts],
            "gtIds": [g["id"] for g in gts],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dts],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    def evaluate(self) -> None:
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        p.catIds = list(np.unique(p.catIds)) if p.useCats else [-1]
        self._prepare()
        self.ious = {
            (imgId, catId): self.computeOks(imgId, catId)
            for imgId in p.imgIds
            for catId in p.catIds
        }
        maxDet = p.maxDets[-1]
        self.evalImgs = [
            self.evaluateImg(imgId, catId, areaRng, maxDet)
            for catId in p.catIds
            for areaRng in p.areaRng
            for imgId in p.imgIds
        ]
        self._paramsEval = _copy_params(p)

    def accumulate(self) -> None:
        p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds) if p.useCats else 1
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        num_imgs = len(p.imgIds)
        for k in range(K):
            nk = k * A * num_imgs
            for a in range(A):
                na = a * num_imgs
                for m, maxDet in enumerate(p.maxDets):
                    e = [self.evalImgs[nk + na + i] for i in range(num_imgs)]
                    e = [x for x in e if x is not None]
                    if len(e) == 0:
                        continue
                    dt_scores = np.concatenate(
                        [x["dtScores"][0:maxDet] for x in e]
                    )
                    inds = np.argsort(-dt_scores, kind="mergesort")
                    dt_scores_sorted = dt_scores[inds]

                    dtm = np.concatenate(
                        [x["dtMatches"][:, 0:maxDet] for x in e], axis=1
                    )[:, inds]
                    dtIg = np.concatenate(
                        [x["dtIgnore"][:, 0:maxDet] for x in e], axis=1
                    )[:, inds]
                    gtIg = np.concatenate([x["gtIgnore"] for x in e])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(
                        np.logical_not(dtm), np.logical_not(dtIg)
                    )
                    tp_sum = np.cumsum(tps, axis=1).astype(dtype=np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(dtype=np.float64)
                    for t, (tp, fp) in enumerate(zip(tp_sum, fp_sum)):
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros(R)
                        ss = np.zeros(R)
                        recall[t, k, a, m] = rc[-1] if nd else 0

                        pr = pr.tolist()
                        q = q.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        try:
                            for ri, pi in enumerate(inds_r):
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores_sorted[pi]
                        except IndexError:
                            pass
                        precision[t, :, k, a, m] = np.array(q)
                        scores[t, :, k, a, m] = np.array(ss)
        self.eval = {
            "params": p,
            "counts": [T, R, K, A, M],
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }

    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=20) -> float:
        p = self.params
        aind = [i for i, lbl in enumerate(p.areaRngLbl) if lbl == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        if len(s[s > -1]) == 0:
            return -1.0
        return float(np.mean(s[s > -1]))

    def summarize(self) -> None:
        md = self.params.maxDets[0]
        self.stats = np.array(
            [
                self._summarize(1, maxDets=md),
                self._summarize(1, iouThr=0.5, maxDets=md),
                self._summarize(1, iouThr=0.75, maxDets=md),
                self._summarize(1, areaRng="medium", maxDets=md),
                self._summarize(1, areaRng="large", maxDets=md),
                self._summarize(0, maxDets=md),
                self._summarize(0, iouThr=0.5, maxDets=md),
                self._summarize(0, iouThr=0.75, maxDets=md),
                self._summarize(0, areaRng="medium", maxDets=md),
                self._summarize(0, areaRng="large", maxDets=md),
            ]
        )


def _copy_params(p: Params) -> Params:
    q = Params()
    q.__dict__.update({k: v for k, v in p.__dict__.items()})
    return q
