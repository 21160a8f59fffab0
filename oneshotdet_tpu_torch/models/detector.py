"""Siamese GeneralizedRCNN, one-shot eval and train paths (counterpart of
``oneshotdet_tpu/models/detector.py``).

  stage 0: query and support through their own ResNet-50-FPN (SIAMESE_BACKBONE);
           with FEW_SHOT.SUPP_AUG, each shot's 1 + NUM_SUPP_AUG augmented
           supports (consecutive) merged per level into one map by their
           mean, their element-wise max, or a 3x3 conv over their
           channels concatenated (SUPP_AUG_METHOD avg | max | conv);
  fusion:  the support pooled to 1x1 per FPN level by ROIAlign over the whole
           support box [0, 0, w, h], shot-averaged, and multiplied channel-wise
           into the query pyramid;
  stage 1: class-agnostic FCOS on the fused pyramid (MODEL.FCOS.DENSE_POINTS
           1, 4 or 5 points per cell) -> padded proposals; with MODEL.FCOS_ON
           False the anchor RPN (``models.rpn``) in its place, or with
           MODEL.RETINANET_ON RetinaNet (``models.retinanet``), whose
           detections are the proposals (or, with RPN_ONLY, the output);
  stage 2: 7x7 ROIAlign of the raw query pyramid over the proposals and of the
           whole support -> relation head -> detections.

With MODEL.MASK_ON / KEYPOINT_ON the mask and keypoint heads
(``roi_heads.mask``, ``roi_heads.keypoint``) run over 14x14 pools (the
heads' POOLER_RESOLUTION, scales and sampling ratio, the reference's 0
taken as 2, as the JAX package does) of the raw query pyramid: in eval over
every detection slot, giving the fields 'mask_probs' (B, K, 28, 28),
'keypoints_xy' (B, K, NK, 2) and 'keypoints_scores' (B, K, NK); in training
over the sampled ROIs, giving loss_mask and loss_kp against their matched
GT's mask raster and keypoints (the targets' fields 'masks' and
'keypoints'). The pools write zeros in invalid slots, where the JAX
package pools whatever box the slot holds.

Every ROIAlign of the path (5 one-level 1x1 pools, the whole-support 7x7,
the proposals' 7x7 and the heads' 14x14) goes through
``ops.roi_align.multilevel_roi_align``: the CUDA kernels on the card
(forward and, in training, backward), the plain version on the CPU.

``forward_train`` is the train step's forward: the FCOS losses, proposals
under ``no_grad`` at the train capacities with the GT boxes appended (with
FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS, IoU-binned jitters of the GT boxes first
and the whole capped at 1000 real boxes), ROI matching (with soft labels
under FEW_SHOT.SOFT_LABELING) and balanced sampling, the 7x7 pool of the
sampled ROIs and the unfused relation head on shot 0, the reverse-order pass
(FEW_SHOT.REVERSE_ORDER) and the negative-support pass (NEG_SUPPORT, when
negative supports are given), and the stage-2 losses x5 / x2.5 (the extra
term x1 or x2.5). TPU.REMAT_BACKBONE recomputes both backbones' forwards in
the backward pass (``torch.utils.checkpoint``).

TPU.QUANT ('int8', 'int8_weight'; eval only, ``ops.quant``) makes every
bottleneck conv, the FPN's convs, the FCOS towers, the relation head's
compress, aggreg, fc6 and fc7 and the mask and keypoint fcn convs int8; the
stems, the predictors and supp_aug_conv stay in the compute dtype. Under
'int8' the ROI pools of eval (the proposals' 7x7, the heads' 14x14) pool
every slot, valid or not, as the JAX package does, because the per-tensor
activation scale of compress_0's query half and of the heads' first convs
is the maximum over all of them.

The anchor RPN feeds stage 2 as FCOS does (its proposals at the train
capacities with the GT boxes appended in training; EVAL_ROI_TOPK, the 7x7
pool and the relation head in eval) and trains its own losses,
loss_objectness (x10) and loss_rpn_box_reg (x500). RetinaNet trains stage 1
alone, loss_retina_cls and loss_retina_reg, whatever RPN_ONLY says, as the
JAX package does. The mask and keypoint heads follow stage 2 whatever stage
1 is.

ONESHOT_PREPOOL_COMPRESS=1 (read when the model is built, without linear
fusion: the JAX package's gate) hoists compress_0's query half, a 1x1 map
C -> 2C, onto the full FPN maps before the eval ROI pool (under 'int8' an
``int8_dot`` per level map, each with its own activation scale, as the JAX
package's ``_eval_roi_pool``; under 'int8_weight' the float kernel, as
there); K1 pools the 2C-channel maps and the relation head adds the support
half (``prepooled_query``), never through the fused head. The stages are
``torch.profiler.record_function`` ranges (query_backbone, support_backbone,
support_pool, fcos_head, fcos_postprocess or rpn_head, rpn_postprocess or
retinanet_head, retinanet_postprocess, then roi_pool, roi_head,
roi_postprocess, mask_head, keypoint_head), so a profiler trace reads the
time of each.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ops.box_coder import BoxCoder
from ..ops.quant import int8_dot
from ..ops.roi_align import fpn_level_map, multilevel_roi_align, roi_align
from ..ops.roi_head_fused import check_kernel_widths
from ..structures.boxes import Boxes, cat_boxes, compact_boxes, truncate_boxes
from ..structures.image_batch import ImageBatch
from .fcos import FCOSModule, compute_locations, fcos_losses, fcos_postprocess, fcos_targets
from .fpn import ResNetFPN
from .keypoint_head import (KeypointHead, heatmaps_to_keypoints, keypoint_head_loss,
                            keypoints_to_heatmap_targets)
from .layers import Conv2d, ConvTranspose2d, FrozenBatchNorm, Scale
from .mask_head import MaskHead, mask_head_loss, project_gt_rasters
from .roi_head import (ROIHeads, draw_art_offsets, make_artificial_proposals,
                       predictor_num_classes, prepare_roi_targets, roi_head_loss,
                       roi_head_postprocess)
from .retinanet import (RetinaNetModule, retina_prior_bias, retinanet_losses,
                        retinanet_postprocess)
from .rpn import RPNModule, rpn_losses, rpn_postprocess, rpn_targets

ART_PROPOSAL_CAP = 1000   # real boxes kept after the artificial proposals


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static model hyperparameters, from the cfg tree."""

    depth: int = 50
    out_channels: int = 256
    use_c5_for_p6: bool = False
    siamese_backbone: bool = True
    stage1: str = "fcos"            # fcos | rpn | retinanet (MODEL.FCOS_ON, RETINANET_ON)
    # the anchor RPN (MODEL.RPN)
    rpn_anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    rpn_aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    rpn_anchor_stride: Tuple[int, ...] = (8, 16, 32, 64, 128)
    rpn_straddle_thresh: float = 0.0
    rpn_fg_iou: float = 0.7
    rpn_bg_iou: float = 0.3
    rpn_batch_per_image: int = 256
    rpn_positive_fraction: float = 0.5
    rpn_post_nms_top_n_train: int = 4000
    rpn_post_nms_top_n_test: int = 2000
    rpn_min_size: float = 0.0
    # RetinaNet (MODEL.RETINANET)
    retina_num_classes: int = 1
    retina_anchor_sizes: Tuple[float, ...] = (32, 64, 128, 256, 512)
    retina_anchor_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    retina_aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    retina_octave: float = 2.0
    retina_scales_per_octave: int = 3
    retina_fg_iou: float = 0.5
    retina_bg_iou: float = 0.4
    retina_inference_th: float = 0.0
    retina_pre_nms_top_n: int = 12000
    retina_nms_th: float = 0.4
    fpn_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    num_convs: int = 4
    dense_points: int = 1
    prior_prob: float = 0.01
    score_mode: str = "BINARY"
    rpn_only: bool = False
    pre_nms_top_n_test: int = 6000
    rpn_nms_thresh: float = 0.8
    fpn_post_nms_top_n_test: int = 2000
    nms_pre_topk: int = 8192
    strict_level_topk: bool = False
    inference_th: float = 0.0
    fcos_nms_th: float = 0.6
    fcos_pre_nms_top_n: int = 12000
    detections_per_img_rpn_only: int = 4000
    pooler_resolution: int = 7
    pooler_scales: Tuple[float, ...] = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
    pooler_sampling_ratio: int = 2
    mlp_head_dim: int = 1024
    second_stage_method: str = "concat"
    second_stage_cls_loss: str = "ce_loss"
    linear_fusion: bool = False
    neg_support: bool = False
    bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    roi_score_thresh: float = 0.0
    roi_nms_thresh: float = 0.5
    roi_detections_per_img: int = 2000
    eval_roi_topk: int = 0
    supp_roialign: bool = True
    supp_aug: bool = False
    num_supp_aug: int = 1
    supp_aug_method: str = "avg"   # avg | max | conv
    fused_roi_head: bool = False    # ONESHOT_PALLAS_ROI_HEAD=1: the fused head kernel
    prepool_compress: bool = False  # ONESHOT_PREPOOL_COMPRESS=1: compress_0's query half hoisted
    # mask / keypoint heads (MODEL.MASK_ON / KEYPOINT_ON)
    mask_on: bool = False
    keypoint_on: bool = False
    mask_pooler_resolution: int = 14
    mask_pooler_scales: Tuple[float, ...] = (0.0625,)
    mask_pooler_sampling_ratio: int = 2
    mask_conv_layers: Tuple[int, ...] = (256, 256, 256, 256)
    kp_pooler_resolution: int = 14
    kp_pooler_scales: Tuple[float, ...] = (0.0625,)
    kp_pooler_sampling_ratio: int = 2
    kp_conv_layers: Tuple[int, ...] = (512,) * 8
    num_keypoints: int = 17
    mask_raster: int = 56
    # training
    center_sample: bool = True
    pos_radius: float = 1.5
    loc_loss_type: str = "giou"
    loss_gamma: float = 2.0
    loss_alpha: float = 0.25
    focal_mode: str = "SIGMOID"
    pre_nms_top_n_train: int = 12000
    fpn_post_nms_top_n_train: int = 4000
    cls_agnostic_bbox_reg: bool = False
    roi_batch_size_per_image: int = 128
    roi_positive_fraction: float = 0.25
    roi_fg_iou: float = 0.5
    roi_bg_iou: float = 0.5
    loss_weighted: bool = False
    add_artificial_proposals: bool = False
    soft_labeling: bool = False
    soft_labeling_func: str = "linear"
    reverse_order: bool = False
    remat_backbone: bool = False
    quant: str = "none"            # TPU.QUANT: none | int8 | int8_weight (eval only)


def detector_config_from_cfg(cfg) -> DetectorConfig:
    """Map the cfg tree onto DetectorConfig. The opt-ins of the fused head
    (ONESHOT_PALLAS_ROI_HEAD=1) and of the hoisted compress_0 query half
    (ONESHOT_PREPOOL_COMPRESS=1) are read here, once, and hold only without
    linear fusion, the JAX package's gates (which it reads at each trace)."""
    rpn, retina = cfg.MODEL.RPN, cfg.MODEL.RETINANET
    return DetectorConfig(
        depth=50 if "50" in cfg.MODEL.BACKBONE.CONV_BODY else 101,
        out_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        use_c5_for_p6=cfg.MODEL.RETINANET.USE_C5,
        siamese_backbone=cfg.FEW_SHOT.SIAMESE_BACKBONE,
        stage1=("fcos" if cfg.MODEL.FCOS_ON else
                "retinanet" if cfg.MODEL.RETINANET_ON else "rpn"),
        rpn_anchor_sizes=tuple(rpn.ANCHOR_SIZES),
        rpn_aspect_ratios=tuple(rpn.ASPECT_RATIOS),
        rpn_anchor_stride=tuple(rpn.ANCHOR_STRIDE),
        rpn_straddle_thresh=float(rpn.STRADDLE_THRESH),
        rpn_fg_iou=rpn.FG_IOU_THRESHOLD,
        rpn_bg_iou=rpn.BG_IOU_THRESHOLD,
        rpn_batch_per_image=rpn.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=rpn.POSITIVE_FRACTION,
        rpn_post_nms_top_n_train=rpn.POST_NMS_TOP_N_TRAIN,
        rpn_post_nms_top_n_test=rpn.POST_NMS_TOP_N_TEST,
        rpn_min_size=float(rpn.MIN_SIZE),
        retina_num_classes=retina.NUM_CLASSES - 1,
        retina_anchor_sizes=tuple(retina.ANCHOR_SIZES),
        retina_anchor_strides=tuple(retina.ANCHOR_STRIDES),
        retina_aspect_ratios=tuple(retina.ASPECT_RATIOS),
        retina_octave=retina.OCTAVE,
        retina_scales_per_octave=retina.SCALES_PER_OCTAVE,
        retina_fg_iou=retina.FG_IOU_THRESHOLD,
        retina_bg_iou=retina.BG_IOU_THRESHOLD,
        retina_inference_th=retina.INFERENCE_TH,
        retina_pre_nms_top_n=retina.PRE_NMS_TOP_N,
        retina_nms_th=retina.NMS_TH,
        fpn_strides=tuple(cfg.MODEL.FCOS.FPN_STRIDES),
        num_convs=cfg.MODEL.FCOS.NUM_CONVS,
        dense_points=cfg.MODEL.FCOS.DENSE_POINTS,
        prior_prob=cfg.MODEL.FCOS.PRIOR_PROB,
        score_mode=cfg.LOSS.CLS_LOSS,
        rpn_only=cfg.MODEL.RPN_ONLY,
        pre_nms_top_n_test=cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST,
        rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
        fpn_post_nms_top_n_test=cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST,
        nms_pre_topk=cfg.TPU.NMS_PRE_TOPK,
        strict_level_topk=cfg.TPU.STRICT_LEVEL_TOPK,
        inference_th=cfg.MODEL.FCOS.INFERENCE_TH,
        fcos_nms_th=cfg.MODEL.FCOS.NMS_TH,
        fcos_pre_nms_top_n=cfg.MODEL.FCOS.PRE_NMS_TOP_N,
        detections_per_img_rpn_only=cfg.TEST.DETECTIONS_PER_IMG,
        pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        pooler_scales=tuple(cfg.MODEL.ROI_BOX_HEAD.POOLER_SCALES),
        pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        mlp_head_dim=cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM,
        second_stage_method=cfg.FEW_SHOT.SECOND_STAGE_METHOD,
        second_stage_cls_loss=cfg.FEW_SHOT.SECOND_STAGE_CLS_LOSS,
        linear_fusion=cfg.FEW_SHOT.LINEAR_FUSION,
        neg_support=cfg.FEW_SHOT.NEG_SUPPORT.TURN_ON,
        bbox_reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
        roi_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH,
        roi_nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
        roi_detections_per_img=cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
        eval_roi_topk=cfg.TPU.EVAL_ROI_TOPK,
        supp_roialign=cfg.FEW_SHOT.SUPP_ROIALIGN,
        supp_aug=cfg.FEW_SHOT.SUPP_AUG,
        num_supp_aug=cfg.FEW_SHOT.NUM_SUPP_AUG,
        supp_aug_method=cfg.FEW_SHOT.SUPP_AUG_METHOD,
        # the JAX package's opt-in, read once here
        fused_roi_head=(os.environ.get("ONESHOT_PALLAS_ROI_HEAD") == "1"
                        and not cfg.FEW_SHOT.LINEAR_FUSION),
        prepool_compress=(os.environ.get("ONESHOT_PREPOOL_COMPRESS") == "1"
                          and not cfg.FEW_SHOT.LINEAR_FUSION),
        mask_on=cfg.MODEL.MASK_ON,
        keypoint_on=cfg.MODEL.KEYPOINT_ON,
        mask_pooler_resolution=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION,
        mask_pooler_scales=tuple(cfg.MODEL.ROI_MASK_HEAD.POOLER_SCALES),
        # the reference's 0 (adaptive sampling) taken as the FPN yamls' 2
        mask_pooler_sampling_ratio=cfg.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO or 2,
        mask_conv_layers=tuple(cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS),
        kp_pooler_resolution=cfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION,
        kp_pooler_scales=tuple(cfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES),
        kp_pooler_sampling_ratio=cfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO or 2,
        kp_conv_layers=tuple(cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS),
        num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES,
        mask_raster=cfg.TPU.MASK_RASTER,
        center_sample=cfg.MODEL.FCOS.CENTER_SAMPLE,
        pos_radius=cfg.MODEL.FCOS.POS_RADIUS,
        loc_loss_type=cfg.MODEL.FCOS.LOC_LOSS_TYPE,
        loss_gamma=cfg.MODEL.FCOS.LOSS_GAMMA,
        loss_alpha=cfg.MODEL.FCOS.LOSS_ALPHA,
        focal_mode=cfg.LOSS.FOCAL_LOSS,
        pre_nms_top_n_train=cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN,
        fpn_post_nms_top_n_train=cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN,
        cls_agnostic_bbox_reg=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
        roi_batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        roi_fg_iou=cfg.MODEL.ROI_HEADS.FG_IOU_THRESHOLD,
        roi_bg_iou=cfg.MODEL.ROI_HEADS.BG_IOU_THRESHOLD,
        loss_weighted=cfg.FEW_SHOT.LOSS_WEIGHTED,
        add_artificial_proposals=cfg.FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS,
        soft_labeling=cfg.FEW_SHOT.SOFT_LABELING,
        soft_labeling_func=cfg.FEW_SHOT.SOFT_LABELING_FUNC,
        reverse_order=cfg.FEW_SHOT.REVERSE_ORDER,
        remat_backbone=cfg.TPU.REMAT_BACKBONE,
        quant=cfg.TPU.QUANT,
    )


def _whole_image_rois(sizes_hw: torch.Tensor) -> torch.Tensor:
    """(N, 2) true (h, w) -> (N, 5) float32 rois (idx, 0, 0, w, h)."""
    n = sizes_hw.shape[0]
    idx = torch.arange(n, dtype=torch.float32, device=sizes_hw.device)[:, None]
    zeros = torch.zeros((n, 2), dtype=torch.float32, device=sizes_hw.device)
    return torch.cat([idx, zeros, sizes_hw.flip(-1).to(torch.float32)], dim=1)


def _nhwc(f: torch.Tensor) -> torch.Tensor:
    """NHWC view of a channels_last NCHW map: contiguous, no copy (the FPN
    returns channels_last levels; the kernel wrapper raises otherwise)."""
    return f.permute(0, 2, 3, 1)


class GeneralizedRCNN(nn.Module):
    """The one-shot detector's eval path. Parameters are float32 under the
    reference's state-dict names; activations run in ``dtype``."""

    def __init__(self, config: DetectorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.backbone = ResNetFPN(c.depth, c.out_channels, c.use_c5_for_p6, c.quant)
        if c.siamese_backbone:
            self.supp_backbone = ResNetFPN(c.depth, c.out_channels, c.use_c5_for_p6, c.quant)
        if c.supp_aug and c.supp_aug_method == "conv":
            # the variants' channels concatenated, aug-major, 3x3 to C
            self.supp_aug_conv = Conv2d((1 + c.num_supp_aug) * c.out_channels, c.out_channels,
                                        3, padding=1, bias=False)
        # stage 1, under the reference's ``rpn`` name whichever it is
        if c.stage1 == "fcos":
            self.rpn = FCOSModule(in_channels=c.out_channels, num_convs=c.num_convs,
                                  num_levels=len(c.fpn_strides), dense_points=c.dense_points,
                                  quant=c.quant)
        elif c.stage1 == "retinanet":
            self.rpn = RetinaNetModule(c.out_channels, c.retina_num_classes,
                                       c.retina_anchor_sizes, c.retina_anchor_strides,
                                       c.retina_aspect_ratios, c.retina_octave,
                                       c.retina_scales_per_octave, quant=c.quant)
        else:
            self.rpn = RPNModule(c.out_channels, c.rpn_anchor_sizes, c.rpn_aspect_ratios,
                                 c.rpn_anchor_stride, c.rpn_straddle_thresh)
        if not c.rpn_only:
            ncls, nreg = predictor_num_classes(c.second_stage_method,
                                               c.second_stage_cls_loss, c.neg_support)
            self.roi_heads = ROIHeads(
                in_channels=c.out_channels, resolution=c.pooler_resolution,
                representation_size=c.mlp_head_dim, num_classes=ncls,
                num_bbox_reg=nreg, linear_fusion=c.linear_fusion, quant=c.quant)
            if c.mask_on:
                self.roi_heads.mask = MaskHead(c.out_channels, num_classes=ncls,
                                               conv_layers=c.mask_conv_layers, quant=c.quant)
            if c.keypoint_on:
                self.roi_heads.keypoint = KeypointHead(c.out_channels,
                                                       num_keypoints=c.num_keypoints,
                                                       conv_layers=c.kp_conv_layers,
                                                       quant=c.quant)

    # -- helpers ----------------------------------------------------------

    def _pyramid(self, net: nn.Module, pixels: torch.Tensor):
        """NHWC pixels -> P3..P7 as channels_last NCHW in ``self.dtype``.
        With TPU.REMAT_BACKBONE, in training with grad enabled, the backbone
        keeps no activations and runs its forward again in the backward
        pass (FrozenBN has no state and there is no dropout: the same
        computation)."""
        x = pixels.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=torch.channels_last)
        if self.config.remat_backbone and self.training and torch.is_grad_enabled():
            return checkpoint(net, x, use_reentrant=False)
        return net(x)

    def _supp_features(self, supp: ImageBatch):
        net = self.supp_backbone if self.config.siamese_backbone else self.backbone
        return self._merge_supp_aug(self._pyramid(net, supp.pixels))

    def _merge_supp_aug(self, feats):
        """FEW_SHOT.SUPP_AUG: per level, the 1 + NUM_SUPP_AUG consecutive
        variants of each support, (N, C, H, W) channels_last, merged into
        (N / (1 + NUM_SUPP_AUG), C, H, W) channels_last: their mean, their
        max (``amax``: tied variants share the gradient equally, as
        ``jnp.max``'s), or ``supp_aug_conv`` over their channels
        concatenated variant-major (channel a * C + c)."""
        c = self.config
        if not c.supp_aug:
            return feats
        a = 1 + c.num_supp_aug
        out = []
        for f in feats:
            n, ch, h, w = f.shape
            if n % a:
                raise ValueError(f"{n} support images are not a whole number of groups of "
                                 f"1 + FEW_SHOT.NUM_SUPP_AUG = {a} augmented variants")
            if c.supp_aug_method == "avg":
                g = _nhwc(f).reshape(n // a, a, h, w, ch).mean(dim=1)
            elif c.supp_aug_method == "max":
                g = torch.amax(_nhwc(f).reshape(n // a, a, h, w, ch), dim=1)
            elif c.supp_aug_method == "conv":
                x = _nhwc(f).reshape(n // a, a, h, w, ch).permute(0, 2, 3, 1, 4)
                g = _nhwc(self.supp_aug_conv(x.reshape(n // a, h, w, a * ch).permute(0, 3, 1, 2)))
            else:
                raise ValueError(c.supp_aug_method)
            out.append(g.contiguous().permute(0, 3, 1, 2))
        return out

    def _supp_sizes(self, supp: ImageBatch) -> torch.Tensor:
        """One (h, w) per merged support: the first variant's (the variants
        of a support share its size)."""
        c = self.config
        return supp.sizes[::1 + c.num_supp_aug] if c.supp_aug else supp.sizes

    def _pool_supp_1x1(self, features_supp, supp_sizes_hw, batch_size):
        """Per level: 1x1 ROIAlign over the whole support (or the spatial
        mean), averaged over shots -> list of (B, 1, 1, C) NHWC."""
        c = self.config
        rois = _whole_image_rois(supp_sizes_hw)
        pooled = []
        for lvl, fs in enumerate(features_supp):
            fs = _nhwc(fs)
            if c.supp_roialign:
                p = roi_align(fs, rois, (1, 1), c.pooler_scales[lvl], c.pooler_sampling_ratio)
            else:
                p = fs.mean(dim=(1, 2), keepdim=True)
            shot = p.shape[0] // batch_size
            pooled.append(p.reshape(batch_size, shot, 1, 1, -1).mean(dim=1))
        return pooled

    def _pool_valid(self, boxes: Boxes) -> Optional[torch.Tensor]:
        """The ROIAlign's ``valid`` for an eval pool of ``boxes``: None (every
        slot pooled) under TPU.QUANT 'int8', whose per-tensor activation
        scale takes the maximum over every slot, as in the JAX package."""
        if self.config.quant == "int8":
            return None
        return boxes.valid.reshape(-1).contiguous()

    def _pool_rois(self, features, boxes: Boxes) -> torch.Tensor:
        """7x7 multi-level ROIAlign of batched padded Boxes -> (B*P, 7, 7, C);
        slots with valid=False are zeros (pooled under TPU.QUANT 'int8')."""
        c = self.config
        b, p = boxes.valid.shape
        flat_xyxy = boxes.xyxy.reshape(-1, 4).to(torch.float32)
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=flat_xyxy.device).repeat_interleave(p)[:, None]
        rois = torch.cat([batch_idx, flat_xyxy], dim=1)
        if len(c.pooler_scales) > 1:
            levels = fpn_level_map(flat_xyxy, 3, 3 + len(c.pooler_scales) - 1)
        else:
            levels = torch.zeros((b * p,), dtype=torch.int32, device=rois.device)
        r = c.pooler_resolution
        return multilevel_roi_align(
            [_nhwc(f) for f in features], rois, levels, (r, r), c.pooler_scales,
            c.pooler_sampling_ratio, valid=self._pool_valid(boxes))

    def _eval_roi_pool(self, features, proposals: Boxes):
        """The eval ROI pool: (7x7 ROI features in the compute dtype, None),
        or with ONESHOT_PREPOOL_COMPRESS=1 (None, compress_0's query half
        pooled): the 1x1 map C -> 2C on every FPN level (under 'int8'
        ``int8_dot`` with one activation scale per level map; otherwise the
        float kernel in the compute dtype, under 'int8_weight' too, as the
        JAX package's ``_eval_roi_pool``), then K1 over the 2C-channel maps.
        The map commutes with the bilinear pool, so only rounding differs."""
        c = self.config
        if not c.prepool_compress:
            return self._pool_rois(features, proposals).to(self.dtype), None
        wq = self.roi_heads.box.compress_dim_conv[0].weight[:, :c.out_channels, 0, 0]
        maps = []
        for f in features:
            x = _nhwc(f)
            if c.quant == "int8":
                y = int8_dot(x, wq).to(self.dtype)
            else:
                y = x.to(self.dtype) @ wq.to(self.dtype).t()
            maps.append(y.permute(0, 3, 1, 2))      # channels_last NCHW, as the FPN's
        return None, self._pool_rois(maps, proposals)

    def _pool_rois_at(self, features, boxes: Boxes, resolution: int,
                      scales: Sequence[float], sampling_ratio: int) -> torch.Tensor:
        """ROIAlign of batched padded Boxes at any (resolution, scales,
        sampling ratio), the mask and keypoint heads' pooler: the levels
        ``scales`` name (1 / 2^k is P_k), one, or several mapped by
        ``fpn_level_map`` from the first -> (B*P, res, res, C); slots with
        valid=False are zeros (pooled under TPU.QUANT 'int8')."""
        b, p = boxes.valid.shape
        flat_xyxy = boxes.xyxy.reshape(-1, 4).to(torch.float32)
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=flat_xyxy.device).repeat_interleave(p)[:, None]
        rois = torch.cat([batch_idx, flat_xyxy], dim=1)
        lvl_of = [int(round(-math.log2(s))) - 3 for s in scales]
        feats = [_nhwc(features[i]) for i in lvl_of]
        if len(scales) > 1:
            k_min = lvl_of[0] + 3
            levels = fpn_level_map(flat_xyxy, k_min, k_min + len(scales) - 1)
        else:
            levels = torch.zeros((b * p,), dtype=torch.int32, device=rois.device)
        return multilevel_roi_align(feats, rois, levels, (resolution, resolution),
                                    tuple(scales), sampling_ratio, valid=self._pool_valid(boxes))

    def _mask_kp_eval(self, features, dets: Boxes) -> Boxes:
        """The mask and keypoint heads over every detection slot: the
        fields 'mask_probs' (the sigmoid of the foreground channel, float32
        (B, K, 2R, 2R)), 'keypoints_xy' (B, K, NK, 2) and 'keypoints_scores'
        (B, K, NK) added to ``dets``."""
        c = self.config
        b, k = dets.valid.shape
        fields = dict(dets.fields)
        if c.mask_on:
            with record_function("mask_head"):
                feats = self._pool_rois_at(features, dets, c.mask_pooler_resolution,
                                           c.mask_pooler_scales, c.mask_pooler_sampling_ratio)
                logits = self.roi_heads.mask(feats.to(self.dtype))
                ch = min(1, logits.shape[-1] - 1)     # one-shot: the foreground slot
                probs = torch.sigmoid(logits[..., ch])
                fields["mask_probs"] = probs.reshape((b, k) + probs.shape[1:])
        if c.keypoint_on:
            with record_function("keypoint_head"):
                feats = self._pool_rois_at(features, dets, c.kp_pooler_resolution,
                                           c.kp_pooler_scales, c.kp_pooler_sampling_ratio)
                logits = self.roi_heads.keypoint(feats.to(self.dtype))
                xy, scores = heatmaps_to_keypoints(logits, dets.xyxy.reshape(-1, 4).float())
                fields["keypoints_xy"] = xy.reshape(b, k, -1, 2)
                fields["keypoints_scores"] = scores.reshape(b, k, -1)
        return dataclasses.replace(dets, fields=fields)

    def _mask_kp_losses(self, features, sampled: Boxes, targets: Boxes, gt_idx: torch.Tensor,
                        labels: torch.Tensor, s_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """loss_mask and loss_kp over the sampled ROIs (B, S) and their
        matched GT (``gt_idx``): positive, valid ROIs only."""
        c = self.config
        labels_flat, valid_flat = labels.reshape(-1), s_valid.reshape(-1)
        prop = sampled.xyxy.reshape(-1, 4).to(torch.float32)
        losses = {}
        if c.mask_on:
            with record_function("mask_head"):
                feats = self._pool_rois_at(features, sampled, c.mask_pooler_resolution,
                                           c.mask_pooler_scales, c.mask_pooler_sampling_ratio)
                logits = self.roi_heads.mask(feats.to(self.dtype))
                rasters = targets.get_field("masks").to(torch.float32)      # (B, G, S, S)
                s = rasters.shape[-1]
                sel_rast = torch.gather(rasters, 1, gt_idx[..., None, None].expand(
                    -1, -1, s, s)).reshape(-1, s, s)
                sel_gt = torch.gather(targets.xyxy.to(torch.float32), 1,
                                      gt_idx[..., None].expand(-1, -1, 4)).reshape(-1, 4)
                mask_t = project_gt_rasters(sel_rast, sel_gt, prop, logits.shape[1])
                losses["loss_mask"] = mask_head_loss(logits, mask_t, labels_flat, valid_flat)
        if c.keypoint_on:
            with record_function("keypoint_head"):
                feats = self._pool_rois_at(features, sampled, c.kp_pooler_resolution,
                                           c.kp_pooler_scales, c.kp_pooler_sampling_ratio)
                logits = self.roi_heads.keypoint(feats.to(self.dtype))
                kps = targets.get_field("keypoints").to(torch.float32)      # (B, G, NK, 3)
                nk = kps.shape[2]
                sel = torch.gather(kps, 1, gt_idx[..., None, None].expand(
                    -1, -1, nk, 3)).reshape(-1, nk, 3)
                idx, hm_valid = keypoints_to_heatmap_targets(sel, prop, logits.shape[1])
                hm_valid = hm_valid & ((labels_flat > 0) & valid_flat)[:, None]
                losses["loss_kp"] = keypoint_head_loss(logits, idx, hm_valid)
        return losses

    def _supp_roi_7x7(self, features_supp, supp_sizes_hw, batch_size):
        """Whole-support 7x7 features, (B, shot, 7, 7, C)."""
        c = self.config
        rois = _whole_image_rois(supp_sizes_hw)
        levels = fpn_level_map(rois[:, 1:], 3, 3 + len(c.pooler_scales) - 1)
        r = c.pooler_resolution
        pooled = multilevel_roi_align(
            [_nhwc(f) for f in features_supp], rois, levels, (r, r),
            c.pooler_scales, c.pooler_sampling_ratio)
        return pooled.reshape(batch_size, -1, r, r, pooled.shape[-1])

    def _roi_head_multi_shot(self, roi_feats, supp_7x7, prepooled=None):
        """One head pass per support shot (each through the fused head when
        it is on and nothing is hoisted); element-wise max over class
        logits, each class slot's deltas from its winning shot."""
        head = self.roi_heads.box
        fused = self.config.fused_roi_head
        if supp_7x7.shape[1] == 1:
            return head(roi_feats, supp_7x7[:, 0], use_fused=fused, prepooled_query=prepooled)
        outs = [head(roi_feats, supp_7x7[:, s], use_fused=fused, prepooled_query=prepooled)
                for s in range(supp_7x7.shape[1])]
        logits = torch.stack([o[0] for o in outs])          # (S, N, ncls)
        regs = torch.stack([o[1] for o in outs])            # (S, N, 4*nreg)
        merged_logits, cls_idx = logits.max(dim=0)
        n, ncls = cls_idx.shape
        if regs.shape[-1] == 4 * ncls:
            box_idx = cls_idx.repeat_interleave(4, dim=-1)
        else:
            box_idx = cls_idx[:, :1].expand(n, regs.shape[-1])
        return merged_logits, torch.gather(regs, 0, box_idx[None])[0]

    @staticmethod
    def _fuse(features, supp_pooled):
        """The query pyramid times the pooled support, channel-wise."""
        return [f * p.reshape(p.shape[0], 1, 1, -1).permute(0, 3, 1, 2).to(f.dtype)
                for f, p in zip(features, supp_pooled)]

    def _fcos_head(self, features, supp_pooled):
        """Fusion and the FCOS head: (locations, logits, bbox_reg, ctrness)."""
        with record_function("fcos_head"):
            combined = self._fuse(features, supp_pooled)
            logits, bbox_reg, ctrness = self.rpn.head(combined)
        locations = compute_locations([(f.shape[2], f.shape[3]) for f in combined],
                                      self.config.fpn_strides, device=combined[0].device,
                                      dense_points=self.config.dense_points)
        return locations, logits, bbox_reg, ctrness

    def _anchor_head(self, features, supp_pooled):
        """Fusion and the anchor RPN's or RetinaNet's head: (anchors per
        level, class logits, deltas)."""
        with record_function(f"{self.config.stage1}_head"):
            combined = self._fuse(features, supp_pooled)
            cls, reg = self.rpn.head(combined)
        anchors = self.rpn.generator.grid_anchors([(f.shape[2], f.shape[3]) for f in combined],
                                                  combined[0].device)
        return anchors, cls, reg

    def _anchor_proposals(self, stage1, sizes_wh, train: bool = False) -> Boxes:
        """The anchor RPN's proposals (at the train or test capacities), or
        RetinaNet's detections."""
        c = self.config
        anchors, cls, reg = stage1
        if c.stage1 == "retinanet":
            with record_function("retinanet_postprocess"):
                return retinanet_postprocess(
                    anchors, cls, reg, sizes_wh, self.rpn.box_coder, c.retina_num_classes,
                    min(c.retina_pre_nms_top_n, c.nms_pre_topk), c.retina_inference_th,
                    c.retina_nms_th, c.fpn_post_nms_top_n_test)
        with record_function("rpn_postprocess"):
            return rpn_postprocess(
                anchors, cls, reg, sizes_wh, self.rpn.box_coder,
                c.pre_nms_top_n_train if train else c.pre_nms_top_n_test,
                c.rpn_post_nms_top_n_train if train else c.rpn_post_nms_top_n_test,
                c.rpn_nms_thresh,
                c.fpn_post_nms_top_n_train if train else c.fpn_post_nms_top_n_test,
                c.rpn_min_size)

    # -- public eval API ------------------------------------------------------

    @torch.inference_mode()
    def compute_support_features(self, images_supp: ImageBatch, batch_size: int = 1):
        """The support branch once: (list of (B, 1, 1, C) per level,
        (B, shot, 7, 7, C)), for reuse across query frames."""
        return self._support_branch(images_supp, batch_size)

    @torch.inference_mode()
    def backbone_features(self, images: ImageBatch):
        """Query backbone+FPN alone: P3..P7, channels_last NCHW."""
        return self._backbone_features(images)

    @torch.inference_mode()
    def detect_with_support(self, images: ImageBatch, supp_pooled, supp_7x7,
                            target_ids=None) -> Boxes:
        """Eval forward with precomputed (cached) support features."""
        return self._detect_with_support(images, supp_pooled, supp_7x7, target_ids)

    @torch.inference_mode()
    def detect_from_features(self, features, sizes_wh, supp_pooled, supp_7x7,
                             target_ids=None) -> Boxes:
        """Fusion -> stage 1 -> stage 2 -> postprocess. With RPN_ONLY, the
        stage-1 proposals (FCOS: the RPN settings, as the JAX package's
        ``detect_from_features``; the anchor RPN's proposals with
        'objectness' and 'scores'; RetinaNet's detections)."""
        return self._detect_from_features(features, sizes_wh, supp_pooled, supp_7x7,
                                          target_ids)

    @torch.inference_mode()
    def forward(self, images: ImageBatch, images_supp: ImageBatch,
                target_ids: Optional[torch.Tensor] = None) -> Boxes:
        """Eval forward: padded detections (B, K) with fields 'scores' and
        'labels', and with MASK_ON / KEYPOINT_ON 'mask_probs',
        'keypoints_xy' and 'keypoints_scores' (or, with RPN_ONLY, the
        stage-1 detections)."""
        return self._forward_eval(images, images_supp, target_ids)

    # The bodies of the eval API, undecorated: ``export`` traces them under
    # ``torch.no_grad()`` (an exported graph holds no inference-mode tensors
    # and no profiler ranges; the ranges run once, at trace time).

    def _support_branch(self, images_supp: ImageBatch, batch_size: int = 1):
        """``compute_support_features``' body."""
        with record_function("support_backbone"):
            features_supp = self._supp_features(images_supp)
        with record_function("support_pool"):
            sizes = self._supp_sizes(images_supp)
            pooled = self._pool_supp_1x1(features_supp, sizes, batch_size)
            return pooled, self._supp_roi_7x7(features_supp, sizes, batch_size)

    def _backbone_features(self, images: ImageBatch):
        with record_function("query_backbone"):
            return self._pyramid(self.backbone, images.pixels)

    def _detect_with_support(self, images: ImageBatch, supp_pooled, supp_7x7,
                             target_ids=None) -> Boxes:
        """``detect_with_support``'s body."""
        return self._detect_from_features(self._backbone_features(images), images.sizes_wh(),
                                          supp_pooled, supp_7x7, target_ids)

    def _detect_from_features(
        self,
        features: Sequence[torch.Tensor],   # query P3..P7, NCHW
        sizes_wh: torch.Tensor,             # (B, 2) true (w, h)
        supp_pooled,                        # per level (B or 1, 1, 1, C)
        supp_7x7: torch.Tensor,             # (B or 1, shot, 7, 7, C)
        target_ids=None,                    # (B,) or a scalar
    ) -> Boxes:
        c = self.config
        b = features[0].shape[0]
        dev = features[0].device
        sizes_wh = sizes_wh.to(torch.float32)
        if target_ids is None:
            target_ids = torch.ones((b,), dtype=torch.int32, device=dev)
        else:
            target_ids = torch.as_tensor(target_ids, dtype=torch.int32,
                                         device=dev).reshape(-1).expand(b)

        if c.stage1 == "fcos":
            stage1 = self._fcos_head(features, supp_pooled)
            with record_function("fcos_postprocess"):
                proposals = fcos_postprocess(
                    *stage1, sizes_wh,
                    c.pre_nms_top_n_test, c.rpn_nms_thresh, c.fpn_post_nms_top_n_test,
                    c.nms_pre_topk, 0.0, c.score_mode, level_topk=c.strict_level_topk,
                    dense_points=c.dense_points)
        else:
            proposals = self._anchor_proposals(self._anchor_head(features, supp_pooled),
                                               sizes_wh)
        if c.rpn_only:
            return proposals
        if c.eval_roi_topk:
            proposals = truncate_boxes(proposals, c.eval_roi_topk)

        with record_function("roi_pool"):
            roi_feats, prepooled = self._eval_roi_pool(features, proposals)
        with record_function("roi_head"):
            supp_7x7 = supp_7x7.expand((b,) + supp_7x7.shape[1:]).to(self.dtype)
            cls_logits, box_deltas = self._roi_head_multi_shot(roi_feats, supp_7x7, prepooled)
        with record_function("roi_postprocess"):
            dets = roi_head_postprocess(
                cls_logits, box_deltas, proposals, target_ids,
                BoxCoder(c.bbox_reg_weights), c.roi_score_thresh,
                c.roi_nms_thresh, c.roi_detections_per_img, c.second_stage_cls_loss)
        if c.mask_on or c.keypoint_on:
            dets = self._mask_kp_eval(features, dets)
        return dets

    def _forward_eval(self, images: ImageBatch, images_supp: ImageBatch,
                      target_ids: Optional[torch.Tensor] = None) -> Boxes:
        """``forward``'s body."""
        b = images.batch_size
        features = self._backbone_features(images)
        supp_pooled, supp_7x7 = self._support_branch(images_supp, b)
        c = self.config
        if c.rpn_only and c.stage1 == "fcos":
            # the FCOS stage-1 settings, as the JAX package's __call__
            stage1 = self._fcos_head(features, supp_pooled)
            with record_function("fcos_postprocess"):
                return fcos_postprocess(
                    *stage1, images.sizes_wh().to(torch.float32),
                    c.fcos_pre_nms_top_n, c.fcos_nms_th, c.detections_per_img_rpn_only,
                    c.nms_pre_topk, c.inference_th, c.score_mode,
                    level_topk=c.strict_level_topk, dense_points=c.dense_points)
        return self._detect_from_features(features, images.sizes_wh(),
                                          supp_pooled, supp_7x7, target_ids)

    # -- train ------------------------------------------------------------------

    def forward_train(self, images: ImageBatch, images_supp: ImageBatch, targets: Boxes,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[torch.Tensor] = None,
                      images_neg_supp: Optional[ImageBatch] = None,
                      art_offsets: Optional[torch.Tensor] = None,
                      rpn_draws: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The train forward: a dict of scalar float32 losses, loss_cls,
        loss_reg and loss_centerness (FCOS), or loss_objectness (x10) and
        loss_rpn_box_reg (x500) (the anchor RPN), or loss_retina_cls and
        loss_retina_reg alone (RetinaNet, which trains stage 1 only) and,
        unless RPN_ONLY, loss_classifier (x5) and loss_box_reg (x2.5), with
        loss_reverse (REVERSE_ORDER) or else loss_cls_suppress (x2.5; NEG_SUPPORT with
        ``images_neg_supp`` given), and loss_mask (MASK_ON) and loss_kp
        (KEYPOINT_ON) over the sampled ROIs.

        ``targets``: (B, G) GT Boxes with field 'labels' (1 for the episode's
        class, 0 on padding), and with MASK_ON 'masks' (B, G, S, S), each
        GT's mask raster over its box, and with KEYPOINT_ON 'keypoints' (B,
        G, NK, 3). ``images_neg_supp``: one negative support per
        image (another class's crop), read only with NEG_SUPPORT; its pass
        runs with REVERSE_ORDER too, but only loss_reverse is returned then.
        With SUPP_AUG both hold each support's 1 + NUM_SUPP_AUG variants,
        consecutive.

        The random inputs, each drawn from ``generator`` on the model's
        device (a generator of that device) when None, in this order:
        ``rpn_draws`` (the anchor RPN only), (B, A) uniform sampling
        priorities of the A anchors of every level; ``art_offsets``, (B, G,
        64, 4) jitters of the artificial proposals in [thres - 1, 1 - thres),
        thres = 0.8499 (ADD_ARTIFICIAL_PROPOSALS only); then ``draws``, (B,
        N) uniform sampling priorities of the N proposals: N = P + G (the GT
        boxes appended), or with artificial proposals min(1000, 12 G + G +
        P), the capacity after the cap, where P is FPN_POST_NMS_TOP_N_TRAIN
        (FCOS) or the anchor RPN's proposal capacity, min(FPN_POST_NMS_TOP_N_
        TRAIN, the sum over levels of min(POST_NMS_TOP_N_TRAIN,
        PRE_NMS_TOP_N_TRAIN, the level's anchors)). The JAX package draws
        ``rpn_draws`` from ``fold_in(rng, 7)`` split per image; here they
        come first from the one generator, so ``step_generator(it)`` still
        gives a resumed run the draws of an uninterrupted one."""
        c = self.config
        if c.quant != "none":
            # round() has a zero gradient: the int8 path is eval only
            raise ValueError("TPU.QUANT is an eval-time flag; train with TPU.QUANT='none'")
        b = images.batch_size
        with record_function("query_backbone"):
            features = self._pyramid(self.backbone, images.pixels)
        with record_function("support_backbone"):
            features_supp = self._supp_features(images_supp)
        supp_sizes = self._supp_sizes(images_supp)
        with record_function("support_pool"):
            supp_pooled = self._pool_supp_1x1(features_supp, supp_sizes, b)
        sizes_wh = images.sizes_wh().to(torch.float32)
        if c.stage1 == "fcos":
            locations, logits, bbox_reg, ctrness = self._fcos_head(features, supp_pooled)
            labels, reg_targets = fcos_targets(
                locations, c.fpn_strides, targets.xyxy, targets.get_field("labels"),
                targets.valid, c.center_sample, c.pos_radius)
            loss_cls, loss_reg, loss_ctr = fcos_losses(
                logits, bbox_reg, ctrness, labels, reg_targets, c.loss_gamma, c.loss_alpha,
                c.loc_loss_type, c.focal_mode, dense_points=c.dense_points)
            losses = {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss_centerness": loss_ctr}
            if c.rpn_only:
                return losses
            with torch.no_grad(), record_function("fcos_postprocess"):
                proposals = fcos_postprocess(
                    locations, logits, bbox_reg, ctrness, sizes_wh,
                    c.pre_nms_top_n_train, c.rpn_nms_thresh, c.fpn_post_nms_top_n_train,
                    c.nms_pre_topk, 0.0, c.score_mode, level_topk=c.strict_level_topk,
                    dense_points=c.dense_points)
        else:
            stage1 = self._anchor_head(features, supp_pooled)
            anchors, cls, reg = stage1
            anchors_all = torch.cat(anchors)
            if c.stage1 == "retinanet":
                loss_cls, loss_reg = retinanet_losses(
                    anchors_all, cls, reg, targets.xyxy, targets.get_field("labels"),
                    targets.valid, self.rpn.box_coder, c.retina_num_classes, c.retina_fg_iou,
                    c.retina_bg_iou)
                return {"loss_retina_cls": loss_cls, "loss_retina_reg": loss_reg}
            if rpn_draws is None:
                rpn_draws = torch.rand((b, anchors_all.shape[0]), generator=generator,
                                       device=anchors_all.device)
            labels, reg_targets = rpn_targets(
                anchors_all, self.rpn.generator.visibility(anchors_all, sizes_wh), targets.xyxy,
                targets.valid, self.rpn.box_coder, c.rpn_fg_iou, c.rpn_bg_iou)
            obj_loss, box_loss = rpn_losses(
                rpn_draws.to(anchors_all.device), cls, reg, labels, reg_targets,
                c.rpn_batch_per_image, c.rpn_positive_fraction)
            losses = {"loss_objectness": obj_loss * 10.0, "loss_rpn_box_reg": box_loss * 500.0}
            if c.rpn_only:
                return losses
            with torch.no_grad():
                proposals = self._anchor_proposals(stage1, sizes_wh, train=True)
        with record_function("support_pool"):
            supp_7x7 = self._supp_roi_7x7(features_supp, supp_sizes, b)
        ones = torch.where(targets.valid, 1.0, 0.0)
        gt_props = Boxes(xyxy=targets.xyxy.to(torch.float32), valid=targets.valid,
                         size=targets.size, fields={"scores": ones, "objectness": ones})
        dev = proposals.valid.device
        if c.add_artificial_proposals:
            # the jitters lead, then the GT boxes, then the scored proposals;
            # the cap counts real boxes, so the valid ones move first
            if art_offsets is None:
                art_offsets = draw_art_offsets(targets.valid.shape, generator, dev)
            art = make_artificial_proposals(art_offsets.to(dev), gt_props)
            proposals = truncate_boxes(compact_boxes(
                cat_boxes(cat_boxes(art, gt_props), proposals)), ART_PROPOSAL_CAP)
        else:
            proposals = cat_boxes(proposals, gt_props)
        if draws is None:
            draws = torch.rand(proposals.valid.shape, generator=generator, device=dev)
        idx, s_valid, roi_labels, roi_reg_t, gt_idx, *soft = prepare_roi_targets(
            draws.to(dev), proposals, targets, BoxCoder(c.bbox_reg_weights),
            c.roi_batch_size_per_image, c.roi_positive_fraction, c.roi_fg_iou, c.roi_bg_iou,
            c.soft_labeling, c.soft_labeling_func)
        sampled = Boxes(xyxy=torch.gather(proposals.xyxy, 1, idx[..., None].expand(-1, -1, 4)),
                        valid=s_valid, size=proposals.size)
        with record_function("roi_pool"):
            roi_feats = self._pool_rois(features, sampled).to(self.dtype)
        head = self.roi_heads.box
        with record_function("roi_head"):
            # shot 0, the unfused head, as the JAX package trains
            supp_s0 = supp_7x7[:, 0].to(self.dtype)
            cls_logits, box_deltas = head(roi_feats, supp_s0, use_fused=False)
            rev_logits = neg_logits = None
            if c.reverse_order:
                # the support leads: broadcast to the ROIs, which take its place
                n = roi_feats.shape[0]
                supp_exp = supp_s0[:, None].expand(b, n // b, *supp_s0.shape[1:])
                rev_logits, _ = head(supp_exp.reshape(roi_feats.shape), roi_feats)
        if c.neg_support and images_neg_supp is not None:
            with record_function("support_backbone"):
                feats_neg = self._supp_features(images_neg_supp)
            with record_function("support_pool"):
                neg_7x7 = self._supp_roi_7x7(feats_neg, self._supp_sizes(images_neg_supp), b)
            with record_function("roi_head"):
                neg_logits, _ = head(roi_feats, neg_7x7[:, 0].to(self.dtype))
        out = roi_head_loss(
            cls_logits, box_deltas, roi_labels, roi_reg_t, s_valid, c.second_stage_cls_loss,
            c.cls_agnostic_bbox_reg, c.loss_weighted, soft_labels=soft[0] if soft else None,
            neg_logits=neg_logits, rev_logits=rev_logits, focal_gamma=c.loss_gamma,
            focal_alpha=c.loss_alpha)
        if c.reverse_order:
            losses["loss_reverse"] = out[2]
        elif neg_logits is not None:
            losses["loss_cls_suppress"] = out[2] * 2.5
        losses.update(loss_classifier=out[0] * 5.0, loss_box_reg=out[1] * 2.5)
        if c.mask_on or c.keypoint_on:
            losses.update(self._mask_kp_losses(features, sampled, targets, gt_idx, roi_labels,
                                               s_valid))
        return losses


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer from ``generator``, a CPU generator:
    values are drawn on the CPU and copied, so a seed gives the same weights
    on every device. Backbone convs are variance-scaled uniform, FPN convs
    and fc6/fc7 kaiming-uniform(a=1), the mask and keypoint heads as the JAX
    package's (mask_fcn kaiming-normal over fan-out, their other convs
    flax's lecun-normal), other head layers N(0, 0.01) (bbox_pred
    N(0, 0.001)); biases 0 but the prior bias on FCOS's and RetinaNet's
    cls_logits (not the anchor RPN's, as in the JAX package); FrozenBN
    statistics are the identity and GN/Scale factors 1."""
    # FCOS's from MODEL.FCOS.PRIOR_PROB, RetinaNet's from its fixed 0.01
    prior_bias = {"fcos": -math.log((1 - model.config.prior_prob) / model.config.prior_prob),
                  "retinanet": retina_prior_bias()}.get(model.config.stage1)

    def uniform(shape, scale):
        bound = math.sqrt(3.0 * scale / math.prod(shape[1:]))   # var scale/fan_in
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)

    def normal(shape, std):
        return torch.empty(shape).normal_(0.0, std, generator=generator)

    def lecun_normal(shape, fan_in):
        # flax's default: cut at two sigma, its std corrected for the cut
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                           generator=generator)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, FrozenBatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, Scale):
                mod.scale.fill_(1.0)
            elif isinstance(mod, (nn.Conv2d, nn.Linear, ConvTranspose2d)):
                shape = tuple(mod.weight.shape)
                if ".body." in name:
                    w = uniform(shape, 1.0)
                elif ".fpn." in name or name.endswith(("fc6", "fc7")):
                    w = uniform(shape, 1.0 / 3.0)
                elif ".mask.feature_extractor." in name:       # (out, in, kh, kw)
                    w = normal(shape, math.sqrt(2.0 / (shape[0] * math.prod(shape[2:]))))
                elif name.startswith(("roi_heads.mask.", "roi_heads.keypoint.")):
                    # a transposed conv's weight is (in, out, kh, kw)
                    fan_in = shape[0 if isinstance(mod, ConvTranspose2d) else 1]
                    w = lecun_normal(shape, fan_in * math.prod(shape[2:]))
                elif name == "roi_heads.box.predictor.bbox_pred":
                    w = normal(shape, 0.001)
                else:
                    w = normal(shape, 0.01)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
                    if name.endswith("cls_logits") and prior_bias is not None:
                        mod.bias.fill_(prior_bias)


def build_detection_model(cfg, device=None,
                          generator: Optional[torch.Generator] = None) -> GeneralizedRCNN:
    """The one-shot detector on ``device`` (default "cuda") in eval mode,
    computing in cfg.TPU.COMPUTE_DTYPE, its weights drawn from ``generator``
    (default: a CPU generator seeded with 0). Load trained weights with
    ``load_state_dict`` (see ``utils.weights``). Raises NotImplementedError
    off the CPU where the fused head is switched on and its kernel does not
    take the widths."""
    config = detector_config_from_cfg(cfg)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.TPU.COMPUTE_DTYPE]
    device = torch.device("cuda" if device is None else device)
    if config.fused_roi_head and not config.rpn_only and device.type != "cpu":
        check_kernel_widths(config.out_channels, config.out_channels // 2, config.mlp_head_dim)
    with torch.device("meta"):
        model = GeneralizedRCNN(config, dtype=dtype)
    model = model.to_empty(device=device)
    init_parameters(model, generator or torch.Generator().manual_seed(0))
    return model.eval()
