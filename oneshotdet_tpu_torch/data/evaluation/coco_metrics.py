"""Pure-numpy COCO box metrics (counterpart of
``oneshotdet_tpu/data/evaluation/coco_metrics.py``, box protocol only).

The standard COCOeval bbox protocol: greedy score-ordered matching per
(image, category) at IoU thresholds .5:.05:.95, 101-point interpolated
precision, area ranges and maxDets.

Inputs are plain dicts:
  gt:  {(image_id, cat_id): [{"bbox": [x, y, w, h], "area": a,
                              "iscrowd": 0/1, "ignore": 0/1}, ...]}
  dt:  {(image_id, cat_id): [{"bbox": [x, y, w, h], "score": s}, ...]}
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)

def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools maskUtils.iou semantics for boxes: (D, G) matrix; crowd
    gt uses intersection / dt area."""
    d, g = len(dt), len(gt)
    out = np.zeros((d, g), np.float64)
    for j in range(g):
        gx, gy, gw, gh = gt[j]
        garea = gw * gh
        for i in range(d):
            dx, dy, dw, dh = dt[i]
            iw = min(dx + dw, gx + gw) - max(dx, gx)
            if iw <= 0:
                continue
            ih = min(dy + dh, gy + gh) - max(dy, gy)
            if ih <= 0:
                continue
            inter = iw * ih
            darea = dw * dh
            union = darea if iscrowd[j] else darea + garea - inter
            if union > 0:
                out[i, j] = inter / union
    return out


def _evaluate_img(gts: List[dict], dts: List[dict], area_rng, max_det: int):
    """COCOeval.evaluateImg for one (image, category, area, maxDet)."""
    if not gts and not dts:
        return None
    for g in gts:
        g["_ignore"] = g.get("ignore", 0) or g.get("iscrowd", 0) or not (
            area_rng[0] <= g["area"] < area_rng[1]
        )
    # sort gt: non-ignored first
    gt_order = sorted(range(len(gts)), key=lambda i: gts[i]["_ignore"])
    gts_sorted = [gts[i] for i in gt_order]
    dts_sorted = sorted(dts, key=lambda d: -d["score"])[:max_det]

    if gts_sorted and dts_sorted:
        crowd = np.array([g.get("iscrowd", 0) for g in gts_sorted])
        iou = bbox_iou_xywh(
            np.array([d["bbox"] for d in dts_sorted], np.float64),
            np.array([g["bbox"] for g in gts_sorted], np.float64),
            crowd,
        )
    else:
        iou = np.zeros((len(dts_sorted), len(gts_sorted)))

    t_n = len(IOU_THRS)
    d_n, g_n = len(dts_sorted), len(gts_sorted)
    gt_matched = np.zeros((t_n, g_n), np.int64)
    dt_matched = np.zeros((t_n, d_n), np.int64)
    gt_ignore = np.array([g["_ignore"] for g in gts_sorted])
    dt_ignore = np.zeros((t_n, d_n), bool)

    for ti, thr in enumerate(IOU_THRS):
        for di in range(d_n):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(g_n):
                if gt_matched[ti, gi] and not gts_sorted[gi].get("iscrowd", 0):
                    continue
                # stop at ignored gt if a real match was already found
                if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                    break
                if iou[di, gi] < best:
                    continue
                best = iou[di, gi]
                m = gi
            if m == -1:
                continue
            dt_ignore[ti, di] = bool(gt_ignore[m])
            dt_matched[ti, di] = 1
            gt_matched[ti, m] = 1
    # unmatched dt outside the area range are ignored
    # bool even when empty: an episode with ground truth and no detection
    # counts its ground truth as missed
    dt_out_of_rng = np.array(
        [
            not (area_rng[0] <= d["bbox"][2] * d["bbox"][3] < area_rng[1])
            for d in dts_sorted
        ],
        dtype=bool,
    )
    dt_ignore |= (dt_matched == 0) & dt_out_of_rng[None, :]
    return {
        "dt_scores": np.array([d["score"] for d in dts_sorted]),
        "dt_matched": dt_matched,
        "dt_ignore": dt_ignore,
        "num_gt": int((~gt_ignore.astype(bool)).sum()),
    }


class COCOEvalNumpy:
    """Accumulate + summarize over a gt/dt dict pair."""

    def __init__(self, gt: Dict, dt: Dict, cat_ids: List[int], img_ids: List[int]):
        self.gt = gt
        self.dt = dt
        self.cat_ids = cat_ids
        self.img_ids = img_ids
        self.area_rngs, self.max_dets = AREA_RNGS, MAX_DETS
        self.eval = None

    def evaluate_and_accumulate(self):
        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        k_n, a_n, m_n = len(self.cat_ids), len(self.area_rngs), len(self.max_dets)
        precision = -np.ones((t_n, r_n, k_n, a_n, m_n))
        recall = -np.ones((t_n, k_n, a_n, m_n))

        for ki, cat in enumerate(self.cat_ids):
            for ai, (aname, arng) in enumerate(self.area_rngs.items()):
                for mi, max_det in enumerate(self.max_dets):
                    results = []
                    for img in self.img_ids:
                        gts = [dict(g) for g in self.gt.get((img, cat), [])]
                        dts = self.dt.get((img, cat), [])
                        r = _evaluate_img(gts, dts, arng, max_det)
                        if r is not None:
                            results.append(r)
                    if not results:
                        continue
                    scores = np.concatenate([r["dt_scores"] for r in results])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate([r["dt_matched"] for r in results], axis=1)[:, order]
                    ignored = np.concatenate([r["dt_ignore"] for r in results], axis=1)[:, order]
                    num_gt = sum(r["num_gt"] for r in results)
                    if num_gt == 0:
                        continue
                    tps = matched & ~ignored
                    fps = (~matched.astype(bool)) & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for ti in range(t_n):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        # make precision monotone decreasing
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(r_n)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = {"precision": precision, "recall": recall}
        return self

    def _summarize(self, ap=True, iou_thr=None, area="all", max_det=100):
        ai = list(self.area_rngs.keys()).index(area)
        mi = self.max_dets.index(max_det)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, :, ai, mi]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        return {
            "AP": self._summarize(True),
            "AP50": self._summarize(True, 0.5),
            "AP75": self._summarize(True, 0.75),
            "APs": self._summarize(True, area="small"),
            "APm": self._summarize(True, area="medium"),
            "APl": self._summarize(True, area="large"),
            "AR@1": self._summarize(False, max_det=1),
            "AR@10": self._summarize(False, max_det=10),
            "AR@100": self._summarize(False, max_det=100),
        }
