"""Detection drift of the eval levers against float (counterpart of the root
``tools/quant_drift.py``).

    python -m oneshotdet_tpu_torch.tools.quant_drift [--variant-quant int8]
        [--roi-topk 512] [--batch 8] [--query-hw 832 1216] [--supp-hw 416 416]
        [--dtype bfloat16] [--device cuda] [--seed 20260818]

Runs the flagship Siamese FCOS R-50-FPN eval forward twice on the same
seeded weights and inputs: once at the compute dtype with the full workload
(PRE_NMS 6000 / POST 2000 / 2000 detections), once with the variant's
levers (TPU.QUANT, TPU.EVAL_ROI_TOPK; both together are the fast-eval
preset), and prints one JSON line: the per-image valid-detection count
delta, the greedy score-order IoU matching rate at 0.5 / 0.75 / 0.9 and,
over the pairs matched at 0.5, the score MAE and the box coordinate MAE in
pixels. ``drift_report`` computes the report from two sets of padded
detections. The configuration's stated bound
(``configs/oneshot_fcos_r50_fast_eval.yaml``) is match_rate@0.9 = 1.0 and a
score MAE of about 1.5e-3 for 'int8'.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

THRESHOLDS = (0.5, 0.75, 0.9)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy IoU with +1 extents."""
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def greedy_match(boxes_a: np.ndarray, boxes_b: np.ndarray,
                 thresh: float) -> List[Tuple[int, int]]:
    """One-to-one pairs (i, j): each box of ``boxes_a`` in order takes the
    unused box of ``boxes_b`` it overlaps most, if their IoU >= ``thresh``."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return []
    iou = iou_matrix(boxes_a, boxes_b)
    pairs, used = [], np.zeros(len(boxes_b), bool)
    for i in range(len(boxes_a)):
        j = int(np.argmax(np.where(used, -1.0, iou[i])))
        if iou[i, j] >= thresh and not used[j]:
            pairs.append((i, j))
            used[j] = True
    return pairs


def drift_report(base: Sequence[np.ndarray], variant: Sequence[np.ndarray]) -> Dict:
    """Drift of ``variant`` against ``base``, each (xyxy (B, K, 4), scores
    (B, K), valid (B, K)) numpy arrays of padded detections in descending
    score order."""
    (bx_f, sc_f, va_f), (bx_q, sc_q, va_q) = base, variant
    count_deltas, score_maes, box_maes = [], [], []
    rates = {th: [] for th in THRESHOLDS}
    for i in range(bx_f.shape[0]):
        f_idx, q_idx = np.nonzero(va_f[i])[0], np.nonzero(va_q[i])[0]
        count_deltas.append(int(len(q_idx)) - int(len(f_idx)))
        a, b = bx_f[i][f_idx], bx_q[i][q_idx]
        for th in THRESHOLDS:
            pairs = greedy_match(a, b, th)
            rates[th].append(len(pairs) / max(len(f_idx), len(q_idx), 1))
            if th == 0.5 and pairs:
                ia, ib = [p[0] for p in pairs], [p[1] for p in pairs]
                score_maes.append(float(np.abs(sc_f[i][f_idx][ia] - sc_q[i][q_idx][ib]).mean()))
                box_maes.append(float(np.abs(a[ia] - b[ib]).mean()))
    report = {
        "images": int(bx_f.shape[0]),
        "mean_valid_float": float(np.mean(va_f.sum(axis=1))),
        "mean_valid_variant": float(np.mean(va_q.sum(axis=1))),
        "count_delta_mean": float(np.mean(count_deltas)),
    }
    report.update({f"match_rate@{th}": float(np.mean(rates[th])) for th in THRESHOLDS})
    report["matched_score_mae"] = float(np.mean(score_maes)) if score_maes else None
    report["matched_box_mae_px"] = float(np.mean(box_maes)) if box_maes else None
    return report


def make_cfg(quant: str = "none", roi_topk: int = 0, dtype: str = "bfloat16",
             pre_nms: int = 6000, post_nms: int = 2000, dets: int = 2000):
    """The flagship at production capacities with the given levers."""
    from ..config import cfg

    c = cfg.clone()
    c.MODEL.BACKBONE.CONV_BODY = "R-50-FPN-RETINANET"
    c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 256
    c.MODEL.RETINANET.USE_C5 = False
    c.MODEL.FCOS.CENTER_SAMPLE = True
    c.MODEL.FCOS.LOC_LOSS_TYPE = "giou"
    c.MODEL.FCOS.PRE_NMS_TOP_N = pre_nms
    c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = post_nms
    c.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = dets
    c.FEW_SHOT.SIAMESE_BACKBONE = True
    c.FEW_SHOT.SECOND_STAGE_METHOD = "concat"
    c.FEW_SHOT.SUPP_ROIALIGN = True
    c.TPU.COMPUTE_DTYPE = dtype
    c.TPU.QUANT = quant
    c.TPU.EVAL_ROI_TOPK = roi_topk
    return c


def seeded_inputs(batch: int, query_hw, supp_hw, seed: int, device):
    """Normal pixels and sizes (the query's true size 25/26 x 75/76 of its
    bucket, the support's 16 pixels short) from ``seed``."""
    import torch

    from ..structures import ImageBatch

    (qh, qw), (sh, sw) = query_hw, supp_hw
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(batch, qh, qw, 3).astype(np.float32)).to(device)
    s = torch.from_numpy(rng.randn(batch, sh, sw, 3).astype(np.float32)).to(device)
    qs = torch.tensor([[qh * 25 / 26.0, qw * 75 / 76.0]] * batch, device=device)
    ss = torch.tensor([[sh - 16.0, sw - 16.0]] * batch, device=device)
    return ImageBatch(q, qs), ImageBatch(s, ss)


def detections(model, images, supports) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyxy, scores, valid) numpy arrays of one eval forward."""
    import torch

    dets = model(images, supports,
                 target_ids=torch.ones((images.batch_size,), dtype=torch.int32))
    return tuple(x.float().cpu().numpy() if x.dtype != torch.bool else x.cpu().numpy()
                 for x in (dets.xyxy, dets.get_field("scores"), dets.valid))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="eval-lever detection drift against float")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--query-hw", type=int, nargs=2, default=(832, 1216))
    p.add_argument("--supp-hw", type=int, nargs=2, default=(416, 416))
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda")
    p.add_argument("--pre-nms", type=int, default=6000)
    p.add_argument("--post-nms", type=int, default=2000)
    p.add_argument("--dets", type=int, default=2000)
    p.add_argument("--variant-quant", default="int8", choices=["none", "int8", "int8_weight"])
    p.add_argument("--roi-topk", type=int, default=0)
    p.add_argument("--seed", type=int, default=20260818, help="the inputs' numpy seed")
    args = p.parse_args(argv)

    import torch

    from ..models import build_detection_model

    dev = torch.device(args.device)
    caps = dict(dtype=args.dtype, pre_nms=args.pre_nms, post_nms=args.post_nms, dets=args.dets)
    models = [build_detection_model(make_cfg(q, k, **caps), device=dev,
                                    generator=torch.Generator().manual_seed(0))
              for q, k in (("none", 0), (args.variant_quant, args.roi_topk))]
    images, supports = seeded_inputs(args.batch, args.query_hw, args.supp_hw, args.seed, dev)
    base, variant = (detections(m, images, supports) for m in models)
    levers = [] if args.variant_quant == "none" else [args.variant_quant]
    if args.roi_topk:
        levers.append(f"topk{args.roi_topk}")
    report = {"metric": f"drift_{'+'.join(levers) or 'none'}_vs_{args.dtype}",
              "capacities": [args.pre_nms, args.post_nms, args.dets]}
    report.update(drift_report(base, variant))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
