"""Stage-2 relation head, 'concat' and 'rn' methods (counterpart of
``models/roi_head.py``; 'rn' is the concat head with its own predictor widths).

  - compress_dim_conv: [1x1 conv 2C->2C + GN32 + LeakyReLU(0.2),
    1x1 conv 2C->C + GN32 + LeakyReLU(0.2)] over the channel concat of the
    7x7 query ROI features and the 7x7 whole-support features; with linear
    fusion there is none, and the 3x3 conv takes the concat (2C channels);
  - feature_aggreg: 3x3 conv C->C/2 + GN32 + LeakyReLU(0.2);
  - fc6 (C/2*49 -> 1024) and fc7 (1024 -> 1024), ReLU after each, over the
    channel-major flatten;
  - predictor: cls_score and bbox_pred (logits and deltas in float32);
  - eval postprocess: class-1 softmax (or sigmoid) score, BoxCoder decode of
    the class-1 slot, clip, per-image NMS, top-k, the episode's label;
  - training: IoU-binned artificial proposals around the GT boxes
    (``make_artificial_proposals``), IoU matching of the proposals to the
    GT, labels, soft labels, BoxCoder targets and balanced sampling
    (``prepare_roi_targets``), and the class loss (CE, focal, mse, l1 or
    cxe) with smooth-L1 over the positives' regression slots, the
    reverse-order consistency term and the negative-support margin
    (``roi_head_loss``).

ROI features are NHWC (N, 7, 7, C); the 1x1 convs run as matmuls over the
last axis, the 3x3 conv on the channels_last NCHW view of the same memory.
With ``use_fused`` (the eval opt-in) the whole head runs as one fused op,
``ops.roi_head_fused`` (the CUDA kernel on the card), wherever the JAX
package would take its fused kernel (never with linear fusion, nor with
compress_0's query half hoisted before the pool, ``prepooled_query``);
otherwise it runs through the layers.

TPU.QUANT (``quant``) makes compress_1, the 3x3 conv, fc6 and fc7 int8
(``ops.quant``) and quantizes compress_0's query and support halves apart:
'int8' with one activation scale each (``int8_dot``), 'int8_weight' with
per-half weight scales (compress_0 keeps a float weight). The predictor
stays in the compute dtype. The fused head reads float weights only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.box_coder import BoxCoder
from ..ops.losses import cross_entropy, sigmoid_focal_loss, smooth_l1_loss
from ..ops.nms import nms_keep_mask, top_k
from ..ops.quant import fake_quant_weight, int8_dot, make_conv, make_dense
from ..ops.roi_head_fused import (check_kernel_widths, fused_head_applies, fused_roi_head,
                                  kernel_operands, pack_roi_head_params)
from ..structures.boxes import Boxes, clip_to_image, masked_box_iou
from .layers import Conv2d, GroupNorm, Linear
from .matcher import BELOW_LOW_THRESHOLD, BETWEEN_THRESHOLDS, balanced_sample, match_boxes


def predictor_num_classes(method: str, cls_loss: str, neg_supp: bool) -> Tuple[int, int]:
    """(num_classes, num_bbox_reg_classes) decision table."""
    if method == "rn":
        num_classes = 1 if cls_loss == "focal_loss" else 2
    elif method == "concat":
        if cls_loss == "focal_loss":
            num_classes = 2 if neg_supp else 1
        elif cls_loss in ("ce_loss", "cxe_loss"):
            num_classes = 2
        elif cls_loss in ("mse_loss", "l1_loss"):
            num_classes = 1
        else:
            raise ValueError(f"unsupported SECOND_STAGE_CLS_LOSS {cls_loss}")
    else:
        raise ValueError(f"unsupported SECOND_STAGE_METHOD {method}")
    if cls_loss in ("focal_loss", "mse_loss", "l1_loss"):
        return num_classes, num_classes + 1
    return num_classes, num_classes


def _nhwc_apply(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module (GN, 3x3 conv) to an NHWC tensor, NHWC out."""
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FPNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int, num_bbox_reg: int):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.bbox_pred = Linear(in_features, 4 * num_bbox_reg)


class ROIBoxHead(nn.Module):
    def __init__(self, in_channels: int = 256, resolution: int = 7,
                 representation_size: int = 1024, num_classes: int = 2,
                 num_bbox_reg: int = 2, linear_fusion: bool = False, quant: str = "none"):
        super().__init__()
        c = in_channels
        self.in_channels = c
        self.resolution = resolution
        self.linear_fusion = linear_fusion
        self.quant = quant
        self._fused_cache = {}         # dtype -> (parameter key, operands)
        # set by ``export`` while it traces: the operands the exported
        # program holds as its own buffers
        self.operands_override = None
        if not linear_fusion:
            self.compress_dim_conv = nn.Sequential(
                Conv2d(2 * c, 2 * c, 1), GroupNorm(32, 2 * c, eps=1e-5), nn.LeakyReLU(0.2),
                make_conv(quant, 2 * c, c, 1), GroupNorm(32, c, eps=1e-5), nn.LeakyReLU(0.2),
            )
        aggreg_in = 2 * c if linear_fusion else c
        self.feature_aggreg = nn.Sequential(
            make_conv(quant, aggreg_in, c // 2, 3, padding=1), GroupNorm(32, c // 2, eps=1e-5),
            nn.LeakyReLU(0.2),
        )
        self.fc6 = make_dense(quant, c // 2 * resolution * resolution, representation_size)
        self.fc7 = make_dense(quant, representation_size, representation_size)
        self.predictor = FPNPredictor(representation_size, num_classes, num_bbox_reg)

    def _fused_operands(self, dtype: torch.dtype):
        """Kernel operands of the current parameters for ``dtype``, packed
        once per dtype and packed again after any parameter changes
        (load_state_dict, in-place edits); ``operands_override`` where set."""
        if self.operands_override is not None:
            return self.operands_override
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self._fused_cache.get(dtype)
        if cached is None or cached[0] != key:
            cached = (key, kernel_operands(pack_roi_head_params(self), dtype))
            self._fused_cache[dtype] = cached
        return cached[1]

    def forward(self, roi_feats: Optional[torch.Tensor], supp_feats: torch.Tensor,
                use_fused: bool = False, prepooled_query: Optional[torch.Tensor] = None):
        """roi_feats (N, 7, 7, C); supp_feats (N, 7, 7, C), or (B, 7, 7, C)
        with B dividing N (one support per image, image-major ROIs).
        Returns float32 logits (N, ncls) and deltas (N, 4 * nreg).

        ``prepooled_query`` (N, 7, 7, 2C), compress_0's query half pooled
        from the hoisted maps (ONESHOT_PREPOOL_COMPRESS=1), takes the place
        of roi_feats (None then): the head adds the support half and its
        bias, per image, and goes on from compress_gn0; the fused head does
        not run, as the JAX package's gate.

        ``use_fused`` (the eval path with the fused head switched on) runs
        the fused head where the JAX package's gate takes its kernel: no
        linear fusion, resolution 7, one support per image (B != N, B
        divides N) and a per-image ROI count that is a positive multiple of
        8. Off the CPU it raises NotImplementedError first where the kernel
        does not take the head's widths (``check_kernel_widths``).

        With linear fusion the supports are broadcast to the ROIs and
        concatenated with them on channels, straight into the 3x3 conv."""
        if prepooled_query is not None:
            if self.linear_fusion:
                raise ValueError("a linear-fusion head has no compress_0 to hoist")
            use_fused = False
        n = (roi_feats if prepooled_query is None else prepooled_query).shape[0]
        b = supp_feats.shape[0]
        if (use_fused and self.resolution == 7 and b != n and n % b == 0
                and fused_head_applies(n // b, self.linear_fusion)):
            if roi_feats.device.type != "cpu":
                check_kernel_widths(self.in_channels, self.in_channels // 2,
                                    self.fc7.out_features)
            return fused_roi_head(roi_feats, supp_feats,
                                  self._fused_operands(roi_feats.dtype), n // b)
        if self.linear_fusion:
            supp = supp_feats[:, None].expand(b, n // b, *supp_feats.shape[1:])
            x = torch.cat([roi_feats, supp.reshape(roi_feats.shape)], dim=-1)
        else:
            x = self._compress(roi_feats, supp_feats, prepooled_query)
        x = self.feature_aggreg(x.permute(0, 3, 1, 2))          # (N, C/2, 7, 7)
        x = F.relu(self.fc6(x.flatten(1)))                       # channel-major
        x = F.relu(self.fc7(x))
        logits = self.predictor.cls_score(x).float()
        deltas = self.predictor.bbox_pred(x).float()
        return logits, deltas

    def _compress(self, roi_feats: Optional[torch.Tensor], supp_feats: torch.Tensor,
                  prepooled_query: Optional[torch.Tensor] = None) -> torch.Tensor:
        """compress_dim_conv over the concat of the ROIs and their image's
        support (or over ``prepooled_query``, the query half already
        applied), NHWC (N, 7, 7, C) out."""
        c = self.in_channels
        dtype = supp_feats.dtype
        conv0, gn0, act0, conv1, gn1, act1 = self.compress_dim_conv
        # conv(cat(q, s)) = q @ Wq + (s @ Ws + bias): the concat is never built
        # and the support half is computed once per image
        w0 = conv0.weight[:, :, 0, 0]                             # (2C out, 2C in)
        wq, ws = w0[:, :c], w0[:, c:]
        if self.quant == "int8":
            ya = None if roi_feats is None else int8_dot(roi_feats, wq).to(dtype)
            yb = int8_dot(supp_feats, ws).to(dtype)
        else:
            if self.quant == "int8_weight":
                wq, ws = ((q.to(dtype) * s.to(dtype)[:, None])
                          for q, s in (fake_quant_weight(wq), fake_quant_weight(ws)))
            ya = None if roi_feats is None else roi_feats @ wq.to(dtype).t()
            yb = supp_feats @ ws.to(dtype).t()
        if ya is None:
            ya = prepooled_query.to(dtype)
        yb = yb + conv0.bias.to(dtype)
        n, b = ya.shape[0], yb.shape[0]
        x = (ya.view(b, n // b, *ya.shape[1:]) + yb[:, None]).view(ya.shape)
        x = act0(_nhwc_apply(gn0, x))
        if self.quant == "none":
            x = F.linear(x, conv1.weight.to(x.dtype)[:, :, 0, 0], conv1.bias.to(x.dtype))
        else:
            x = _nhwc_apply(conv1, x)
        return act1(_nhwc_apply(gn1, x))


class ROIHeads(nn.Module):
    """Holds the box head under the reference's ``roi_heads.box`` name."""

    def __init__(self, **box_kwargs):
        super().__init__()
        self.box = ROIBoxHead(**box_kwargs)


def soft_labeling_function(t: torch.Tensor, func: str = "linear") -> torch.Tensor:
    """Matched IoU -> soft class target: 'discrete' (IoU >= 0.5), 'linear'
    (the IoU), 'transLinear' (0.2 t + 0.8 from 0.5, 2.25 t - 0.225 on
    [0.1, 0.5), else 0) or 'trans4thLinear' (0.2 t + 0.8 from 0.5, 0.9 (2t)^4
    below). Raises ValueError for another name."""
    if func == "discrete":
        return (t >= 0.5).to(torch.float32)
    if func == "linear":
        return t
    if func == "transLinear":
        upper = (0.2 * t + 0.8) * (t >= 0.5)
        middle = (2.25 * t - 0.225) * (t >= 0.1) * (t < 0.5)
        return upper + middle
    if func == "trans4thLinear":
        upper = (0.2 * t + 0.8) * (t >= 0.5)
        lower = 0.9 * ((2 * t) ** 4) * (t < 0.5)
        return upper + lower
    raise ValueError(func)


def prepare_roi_targets(
    u: torch.Tensor,           # (B, N) uniform sampling priorities
    proposals: Boxes,          # batched (B, N)
    gt: Boxes,                 # batched (B, G), field 'labels'
    box_coder: BoxCoder,
    batch_size_per_image: int = 128,
    positive_fraction: float = 0.25,
    fg_iou_threshold: float = 0.5,
    bg_iou_threshold: float = 0.5,
    soft_labeling: bool = False,
    soft_labeling_func: str = "linear",
):
    """Match, label, encode and sample S = ``batch_size_per_image``
    proposals per image. Labels: the matched GT's label, 0 below the low
    threshold, -1 between the thresholds and on padding. Returns
    (sampled_idx (B, S), sampled_valid (B, S), labels (B, S), reg_targets
    (B, S, 4), matched_gt_idx (B, S), the clamped index of each sampled
    proposal's GT) and, with ``soft_labeling``, the sampled proposals'
    matched IoU (0 where unmatched) through ``soft_labeling_function``."""
    iou = masked_box_iou(gt.xyxy, gt.valid, proposals.xyxy, proposals.valid)   # (B, G, N)
    matched = match_boxes(iou, gt.valid, fg_iou_threshold, bg_iou_threshold)
    clamped = torch.clamp(matched, min=0).long()
    labels = torch.gather(gt.get_field("labels"), 1, clamped).to(torch.int32)
    labels = torch.where(matched == BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where(matched == BETWEEN_THRESHOLDS, -1, labels)
    labels = torch.where(proposals.valid, labels, -1).to(torch.int32)
    matched_gt = torch.gather(gt.xyxy, 1, clamped[..., None].expand(-1, -1, 4))
    reg_targets = box_coder.encode(matched_gt, proposals.xyxy)
    idx, s_valid = balanced_sample(u, labels, proposals.valid, batch_size_per_image,
                                   positive_fraction)
    out = (idx, s_valid, torch.gather(labels, 1, idx),
           torch.gather(reg_targets, 1, idx[..., None].expand(-1, -1, 4)),
           torch.gather(clamped, 1, idx))
    if not soft_labeling:
        return out
    match_iou = torch.gather(iou, 1, clamped[:, None])[:, 0]
    match_iou = torch.where(matched >= 0, match_iou, 0.0)
    return out + (soft_labeling_function(torch.gather(match_iou, 1, idx), soft_labeling_func),)


ART_POOL = 64   # candidate jitters per GT box


def art_offset_bounds(iou_lower_bound: float = 0.5999) -> Tuple[float, float]:
    """The range [thres - 1, 1 - thres) of the artificial proposals' jitter,
    thres = iou_lower_bound + 0.25."""
    thres = iou_lower_bound + 0.25
    return thres - 1.0, 1.0 - thres


def draw_art_offsets(shape, generator: Optional[torch.Generator], device,
                     iou_lower_bound: float = 0.5999) -> torch.Tensor:
    """(B, G, ART_POOL, 4) uniform jitters in ``art_offset_bounds`` from
    ``generator`` (a generator of ``device``)."""
    lo, hi = art_offset_bounds(iou_lower_bound)
    u = torch.rand(tuple(shape) + (ART_POOL, 4), generator=generator, device=device)
    return u * (hi - lo) + lo


def make_artificial_proposals(
    offsets: torch.Tensor,        # (B, G, pool, 4) in art_offset_bounds
    gt: Boxes,                    # batched (B, G)
    iou_lower_bound: float = 0.5999,
    required_num: int = 3,
    granularity: float = 0.1,
) -> Boxes:
    """IoU-binned jittered GT boxes: each GT's ``pool`` candidates are the
    box plus ``offsets`` times (w, h, w, h) (w = x2 - x1, no +1); a candidate
    counts where it lies strictly inside the image and its IoU with the GT
    (raw areas, no +1) is at least ``iou_lower_bound``; each IoU bin
    [lb + k granularity, ...) of the nbins = int((1 - lb) / granularity)
    takes its first ``required_num`` candidates in candidate order, and
    slots left unfilled are invalid. Returns Boxes (B, G * nbins *
    required_num), GT-major, with fields scores / objectness = 1 on valid
    slots."""
    nbins = int((1.0 - iou_lower_bound) / granularity)
    pool = offsets.shape[2]
    box = gt.xyxy.to(torch.float32)[:, :, None, :]                 # (B, G, 1, 4)
    w = box[..., 2] - box[..., 0]
    h = box[..., 3] - box[..., 1]
    cand = box + offsets * torch.stack([w, h, w, h], dim=-1)       # (B, G, pool, 4)
    size = gt.size[:, None, None, :]
    inside = ((cand[..., 0] > 0) & (cand[..., 1] > 0)
              & (cand[..., 2] < size[..., 0]) & (cand[..., 3] < size[..., 1]))
    il = torch.maximum(box[..., 0], cand[..., 0])
    it = torch.maximum(box[..., 1], cand[..., 1])
    ir = torch.minimum(box[..., 2], cand[..., 2])
    ib = torch.minimum(box[..., 3], cand[..., 3])
    inter = torch.clamp(ir - il, min=0.0) * torch.clamp(ib - it, min=0.0)
    area = lambda bx: (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])
    iou = inter / torch.clamp(area(box) + area(cand) - inter, min=1e-9)
    ok = inside & (iou >= iou_lower_bound) & gt.valid[..., None]
    bin_idx = torch.clamp(torch.floor((iou - iou_lower_bound) / granularity), 0, nbins - 1)
    order = torch.arange(pool, device=offsets.device)
    boxes_out, valid_out = [], []
    for bi in range(nbins):
        score = torch.where(ok & (bin_idx == bi), order, pool)
        sel = torch.sort(score, dim=-1).values[..., :required_num]   # (B, G, required)
        pick = torch.clamp(sel, max=pool - 1)
        boxes_out.append(torch.gather(cand, 2, pick[..., None].expand(*pick.shape, 4)))
        valid_out.append(sel < pool)
    b, g = gt.valid.shape
    xyxy = torch.cat(boxes_out, dim=2).reshape(b, g * nbins * required_num, 4)
    valid = torch.cat(valid_out, dim=2).reshape(b, -1)
    ones = torch.where(valid, 1.0, 0.0)
    return Boxes(xyxy=xyxy, valid=valid, size=gt.size,
                 fields={"scores": ones, "objectness": ones})


def roi_head_loss(
    logits: torch.Tensor,         # (B*S, num_classes)
    deltas: torch.Tensor,         # (B*S, 4*num_reg)
    labels: torch.Tensor,         # (B, S)
    reg_targets: torch.Tensor,    # (B, S, 4)
    sampled_valid: torch.Tensor,  # (B, S)
    cls_loss_type: str = "ce_loss",
    cls_agnostic_bbox_reg: bool = False,
    loss_weighted: bool = False,
    soft_labels: Optional[torch.Tensor] = None,    # (B, S) in [0, 1]
    neg_logits: Optional[torch.Tensor] = None,     # (B*S, num_classes)
    rev_logits: Optional[torch.Tensor] = None,     # (B*S, num_classes)
    focal_gamma: float = 2.0,
    focal_alpha: float = 0.25,
) -> Tuple[torch.Tensor, ...]:
    """(cls_loss, box_loss), or (cls_loss, box_loss, extra) with
    ``rev_logits`` or ``neg_logits``. Over the valid sampled slots (label
    >= 0), the class loss of ``cls_loss_type``:

      - ce_loss: softmax CE, class weights 0.25 / 0.75 with
        ``loss_weighted``; soft labels are not read;
      - focal_loss: sigmoid focal loss (gamma, alpha) over the positives'
        count;
      - mse_loss, l1_loss: (sigmoid(logit 0) - target)^2 or |...|, mean;
      - cxe_loss: the mean over both classes of -target log softmax, mean;

    where target is the soft label, or the label without ``soft_labels``.
    box_loss: smooth-L1 (beta 1) of the positives' regression slot
    4 * label + [0..3] (slot 1 when class-agnostic) over the valid count.
    extra, with ``rev_logits``: the reverse-order consistency term, the mean
    of -d log(1 - d + 1e-6) with d = |softmax(logits) - softmax(rev_logits)|;
    else, with ``neg_logits``: the negative-support margin relu(neg class-1
    score - pos class-1 score + 0.3) averaged over the label-1 slots."""
    labels_flat = labels.reshape(-1)
    valid_flat = sampled_valid.reshape(-1) & (labels_flat >= 0)
    pos = (labels_flat > 0) & valid_flat
    vf = valid_flat.to(torch.float32)
    denom = torch.clamp(vf.sum(), min=1.0)
    if soft_labels is not None:
        target = soft_labels.reshape(-1)
    else:
        target = labels_flat.to(torch.float32)

    if cls_loss_type == "ce_loss":
        weight = None
        if loss_weighted:
            weight = torch.tensor([0.25] + [0.75] * (logits.shape[-1] - 1), device=logits.device)
        cls_loss = cross_entropy(logits, labels_flat, weight=weight, valid=valid_flat)
    elif cls_loss_type == "focal_loss":
        cls_loss = sigmoid_focal_loss(
            logits, torch.where(valid_flat, labels_flat, -1), focal_gamma, focal_alpha
        ) / torch.clamp(pos.sum(), min=1)
    elif cls_loss_type in ("mse_loss", "l1_loss"):
        d = torch.sigmoid(logits[:, 0]) - target
        per = d ** 2 if cls_loss_type == "mse_loss" else torch.abs(d)
        cls_loss = (per * vf).sum() / denom
    elif cls_loss_type == "cxe_loss":
        probs = torch.softmax(logits[:, :2], dim=-1)
        two = torch.stack([1 - target, target], dim=1)
        per = -(two * torch.log(torch.clamp(probs, min=1e-9))).mean(dim=1)
        cls_loss = (per * vf).sum() / denom
    else:
        raise ValueError(f"unsupported cls loss {cls_loss_type}")

    d = deltas.reshape(deltas.shape[0], -1, 4)
    if cls_agnostic_bbox_reg:
        slot = torch.ones_like(labels_flat)
    else:
        slot = torch.clamp(labels_flat, min=0)
    slot = torch.clamp(slot, max=d.shape[1] - 1).long()
    picked = torch.gather(d, 1, slot[:, None, None].expand(-1, 1, 4))[:, 0]
    box_l = smooth_l1_loss(picked, reg_targets.reshape(-1, 4), beta=1.0).sum(-1)
    box_loss = (box_l * pos).sum() / torch.clamp(valid_flat.sum(), min=1)

    if rev_logits is not None:
        diff = torch.abs(torch.softmax(logits, dim=-1) - torch.softmax(rev_logits, dim=-1))
        per = -(diff * torch.log(1 - diff + 1e-6))
        return cls_loss, box_loss, (per.mean(dim=1) * vf).sum() / denom
    if neg_logits is not None:
        pos_scores = torch.softmax(logits, dim=-1)[:, 1]
        neg_scores = torch.softmax(neg_logits, dim=-1)[:, 1]
        is_fg = ((labels_flat == 1) & valid_flat).to(torch.float32)
        margin = torch.clamp(neg_scores - pos_scores + 0.3, min=0.0)
        return cls_loss, box_loss, (margin * is_fg).sum() / torch.clamp(is_fg.sum(), min=1.0)
    return cls_loss, box_loss


def roi_head_postprocess(
    logits: torch.Tensor,       # (B*P, num_classes)
    deltas: torch.Tensor,       # (B*P, 4*num_reg)
    proposals: Boxes,           # (B, P)
    target_ids: torch.Tensor,   # (B,)
    box_coder: BoxCoder,
    score_thresh: float = 0.0,
    nms_thresh: float = 0.5,
    detections_per_img: int = 2000,
    cls_loss_type: str = "ce_loss",
) -> Boxes:
    """Class-1 scores and boxes -> NMS -> top-k padded detections with fields
    'scores' and 'labels'."""
    b, p = proposals.valid.shape
    deltas = deltas[:, :8]
    if cls_loss_type in ("focal_loss", "mse_loss", "l1_loss"):
        fg = torch.sigmoid(logits)[:, 0]
    else:
        fg = torch.softmax(logits[:, :2], dim=-1)[:, 1]
    scores = fg.reshape(b, p)

    decoded = box_coder.decode(deltas, proposals.xyxy.reshape(-1, 4))
    boxes_fg = clip_to_image(decoded.reshape(b, p, -1)[..., 4:8], proposals.size)

    valid = proposals.valid & (scores > score_thresh)
    keep = nms_keep_mask(boxes_fg, scores, valid, nms_thresh)
    ranked = torch.where(keep, scores, -torch.inf)
    k = min(detections_per_img, p)
    top_scores, top_idx = top_k(ranked, k)
    out_boxes = torch.gather(boxes_fg, 1, top_idx[..., None].expand(b, k, 4))
    out_valid = top_scores > -torch.inf
    out_scores = torch.where(out_valid, top_scores, 0.0)
    labels = target_ids.to(torch.int32)[:, None].expand(b, k)
    return Boxes(xyxy=out_boxes, valid=out_valid, size=proposals.size,
                 fields={"scores": out_scores, "labels": labels})
