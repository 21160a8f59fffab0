"""Non-maximum suppression under static shapes (counterpart of ``ops/nms.py``).

Greedy NMS with the reference CUDA kernel's conventions: boxes sorted by
score, a kept box suppresses later boxes with ``iou > threshold``, IoU with
+1 extents. Padded slots (``valid=False``) neither survive nor suppress. The keep mask
is a custom op (``ops.library``), so that its data-dependent loop stays out
of an exported graph.
"""

from __future__ import annotations

import torch

TO_REMOVE = 1.0


def _pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) -> (..., K, K) IoU with +1 extents."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + TO_REMOVE) * (y2 - y1 + TO_REMOVE)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + TO_REMOVE, min=0.0)
    h = torch.clamp(yy2 - yy1 + TO_REMOVE, min=0.0)
    inter = w * h
    return inter / (area[..., :, None] + area[..., None, :] - inter)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest along the last axis, in
    descending order with ties in index order, as ``jax.lax.top_k`` orders
    them (``torch.topk`` leaves the order of ties open). The padded slots of
    the detectors' outputs take whichever tied candidates come first, so
    they hold the JAX package's boxes too."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask in the original index order: the op
    ``oneshotdet::nms_keep_mask`` (``ops.library``), whose body is
    ``nms_keep_mask_plain`` on every device."""
    from .library import nms_keep_mask as op

    return op(boxes, scores, valid, float(iou_threshold))


def nms_keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                        valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask in the original index order.

    ``boxes`` (..., K, 4), ``scores`` and ``valid`` (..., K); leading dims are
    independent images. The suppression matrix M[i, j] = iou(i, j) > t for i
    ranked before j is solved as the triangular recurrence
    keep[j] = valid[j] and not any_i(M[i, j] and keep[i]) by fixed-point
    iteration, stopping when the mask no longer changes; the fixed point is
    unique, so it is exactly the greedy sweep's keep set.
    """
    k = boxes.shape[-2]
    sort_scores = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-sort_scores, dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    v = torch.gather(valid, -1, order)

    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    m = (_pairwise_iou(b) > iou_threshold) & upper & v[..., :, None] & v[..., None, :]

    keep = v
    for _ in range(k):
        new = v & ~(m & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return torch.zeros_like(v).scatter(-1, order, keep)


def nms(boxes, scores, valid, iou_threshold: float, max_out: int):
    """(indices, keep_valid) of up to ``max_out`` survivors in descending
    score order, padded with index 0 and keep_valid=False."""
    k = boxes.shape[-2]
    keep = nms_keep_mask(boxes, scores, valid, iou_threshold)
    ranked = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    kk = min(max_out, k)
    top_scores, top_idx = top_k(ranked, kk)
    if kk < max_out:
        pad = max_out - kk
        top_idx = torch.cat([top_idx, top_idx.new_zeros(top_idx.shape[:-1] + (pad,))], -1)
        top_scores = torch.cat(
            [top_scores, top_scores.new_full(top_scores.shape[:-1] + (pad,), -torch.inf)], -1)
    return top_idx, top_scores > -torch.inf
