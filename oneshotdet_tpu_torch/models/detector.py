"""Siamese GeneralizedRCNN, one-shot eval path (counterpart of
``oneshotdet_tpu/models/detector.py``).

  stage 0: query and support through their own ResNet-50-FPN (SIAMESE_BACKBONE);
  fusion:  the support pooled to 1x1 per FPN level by ROIAlign over the whole
           support box [0, 0, w, h], shot-averaged, and multiplied channel-wise
           into the query pyramid;
  stage 1: class-agnostic FCOS on the fused pyramid -> padded proposals;
  stage 2: 7x7 ROIAlign of the raw query pyramid over the proposals and of the
           whole support -> relation head -> detections.

Every ROIAlign of the path (5 one-level 1x1 pools, the whole-support 7x7 and
the proposals' 7x7) goes through ``ops.roi_align.multilevel_roi_align``: the
CUDA kernel on the card, the plain version on the CPU.

Only inference is ported; a config that turns on a part not ported yet raises
``NotImplementedError`` (see ``detector_config_from_cfg``). The stages are
``torch.profiler.record_function`` ranges (query_backbone, support_backbone,
support_pool, fcos_head, fcos_postprocess, roi_pool, roi_head,
roi_postprocess), so a profiler trace reads the time of each.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from ..ops.box_coder import BoxCoder
from ..ops.roi_align import fpn_level_map, multilevel_roi_align, roi_align
from ..ops.roi_head_fused import check_kernel_widths
from ..structures.boxes import Boxes, truncate_boxes
from ..structures.image_batch import ImageBatch
from .fcos import FCOSModule, compute_locations, fcos_postprocess
from .fpn import ResNetFPN
from .layers import FrozenBatchNorm, Scale
from .roi_head import ROIHeads, predictor_num_classes, roi_head_postprocess


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static model hyperparameters of the eval path, from the cfg tree."""

    depth: int = 50
    out_channels: int = 256
    use_c5_for_p6: bool = False
    siamese_backbone: bool = True
    fpn_strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    num_convs: int = 4
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
    bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0)
    roi_score_thresh: float = 0.0
    roi_nms_thresh: float = 0.5
    roi_detections_per_img: int = 2000
    eval_roi_topk: int = 0
    supp_roialign: bool = True
    fused_roi_head: bool = False    # ONESHOT_PALLAS_ROI_HEAD=1: the fused head kernel


def _not_ported(cfg) -> List[str]:
    """Names of the switches this cfg turns on that the port does not run."""
    c = cfg
    checks = {
        "MODEL.FCOS_ON=False (anchor RPN / RetinaNet stage 1)": not c.MODEL.FCOS_ON,
        "MODEL.MASK_ON": c.MODEL.MASK_ON,
        "MODEL.KEYPOINT_ON": c.MODEL.KEYPOINT_ON,
        "MODEL.FCOS.DENSE_POINTS!=1": c.MODEL.FCOS.DENSE_POINTS != 1,
        "FEW_SHOT.SUPP_AUG": c.FEW_SHOT.SUPP_AUG,
        "FEW_SHOT.NEG_SUPPORT.TURN_ON": c.FEW_SHOT.NEG_SUPPORT.TURN_ON,
        "FEW_SHOT.LINEAR_FUSION": c.FEW_SHOT.LINEAR_FUSION,
        "FEW_SHOT.SECOND_STAGE_METHOD!=concat": c.FEW_SHOT.SECOND_STAGE_METHOD != "concat",
        "TPU.QUANT": c.TPU.QUANT != "none",
    }
    return [name for name, on in checks.items() if on]


def detector_config_from_cfg(cfg) -> DetectorConfig:
    """Map the cfg tree onto DetectorConfig; raises NotImplementedError for
    switches whose code is not ported yet."""
    missing = _not_ported(cfg)
    if missing:
        raise NotImplementedError(
            "not ported to oneshotdet_tpu_torch yet: " + ", ".join(missing))
    return DetectorConfig(
        depth=50 if "50" in cfg.MODEL.BACKBONE.CONV_BODY else 101,
        out_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        use_c5_for_p6=cfg.MODEL.RETINANET.USE_C5,
        siamese_backbone=cfg.FEW_SHOT.SIAMESE_BACKBONE,
        fpn_strides=tuple(cfg.MODEL.FCOS.FPN_STRIDES),
        num_convs=cfg.MODEL.FCOS.NUM_CONVS,
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
        bbox_reg_weights=tuple(cfg.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS),
        roi_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH,
        roi_nms_thresh=cfg.MODEL.ROI_HEADS.NMS,
        roi_detections_per_img=cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG,
        eval_roi_topk=cfg.TPU.EVAL_ROI_TOPK,
        supp_roialign=cfg.FEW_SHOT.SUPP_ROIALIGN,
        # the JAX package's opt-in, read once here
        fused_roi_head=os.environ.get("ONESHOT_PALLAS_ROI_HEAD") == "1",
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
        self.backbone = ResNetFPN(c.depth, c.out_channels, c.use_c5_for_p6)
        if c.siamese_backbone:
            self.supp_backbone = ResNetFPN(c.depth, c.out_channels, c.use_c5_for_p6)
        self.rpn = FCOSModule(in_channels=c.out_channels, num_convs=c.num_convs,
                              num_levels=len(c.fpn_strides))
        if not c.rpn_only:
            ncls, nreg = predictor_num_classes(c.second_stage_method,
                                               c.second_stage_cls_loss, False)
            self.roi_heads = ROIHeads(
                in_channels=c.out_channels, resolution=c.pooler_resolution,
                representation_size=c.mlp_head_dim, num_classes=ncls,
                num_bbox_reg=nreg)

    # -- helpers ----------------------------------------------------------

    def _pyramid(self, net: nn.Module, pixels: torch.Tensor):
        """NHWC pixels -> P3..P7 as channels_last NCHW in ``self.dtype``."""
        x = pixels.permute(0, 3, 1, 2).to(self.dtype)
        return net(x.contiguous(memory_format=torch.channels_last))

    def _supp_features(self, supp: ImageBatch):
        net = self.supp_backbone if self.config.siamese_backbone else self.backbone
        return self._pyramid(net, supp.pixels)

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

    def _pool_rois(self, features, boxes: Boxes) -> torch.Tensor:
        """7x7 multi-level ROIAlign of batched padded Boxes -> (B*P, 7, 7, C);
        slots with valid=False are zeros."""
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
            c.pooler_sampling_ratio, valid=boxes.valid.reshape(-1).contiguous())

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

    def _roi_head_multi_shot(self, roi_feats, supp_7x7):
        """One head pass per support shot (each through the fused head when
        it is on); element-wise max over class logits, each class slot's
        deltas from its winning shot."""
        head = self.roi_heads.box
        fused = self.config.fused_roi_head
        if supp_7x7.shape[1] == 1:
            return head(roi_feats, supp_7x7[:, 0], use_fused=fused)
        outs = [head(roi_feats, supp_7x7[:, s], use_fused=fused)
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

    def _fcos_head(self, features, supp_pooled):
        """Fusion and the FCOS head: (locations, logits, bbox_reg, ctrness)."""
        with record_function("fcos_head"):
            combined = [f * p.reshape(p.shape[0], 1, 1, -1).permute(0, 3, 1, 2).to(f.dtype)
                        for f, p in zip(features, supp_pooled)]
            logits, bbox_reg, ctrness = self.rpn.head(combined)
        locations = compute_locations([(f.shape[2], f.shape[3]) for f in combined],
                                      self.config.fpn_strides, device=combined[0].device)
        return locations, logits, bbox_reg, ctrness

    # -- public eval API ------------------------------------------------------

    @torch.inference_mode()
    def compute_support_features(self, images_supp: ImageBatch, batch_size: int = 1):
        """The support branch once: (list of (B, 1, 1, C) per level,
        (B, shot, 7, 7, C)), for reuse across query frames."""
        with record_function("support_backbone"):
            features_supp = self._supp_features(images_supp)
        with record_function("support_pool"):
            pooled = self._pool_supp_1x1(features_supp, images_supp.sizes, batch_size)
            return pooled, self._supp_roi_7x7(features_supp, images_supp.sizes, batch_size)

    @torch.inference_mode()
    def backbone_features(self, images: ImageBatch):
        """Query backbone+FPN alone: P3..P7, channels_last NCHW."""
        with record_function("query_backbone"):
            return self._pyramid(self.backbone, images.pixels)

    @torch.inference_mode()
    def detect_with_support(self, images: ImageBatch, supp_pooled, supp_7x7,
                            target_ids=None) -> Boxes:
        """Eval forward with precomputed (cached) support features."""
        return self.detect_from_features(self.backbone_features(images),
                                         images.sizes_wh(), supp_pooled,
                                         supp_7x7, target_ids)

    @torch.inference_mode()
    def detect_from_features(
        self,
        features: Sequence[torch.Tensor],   # query P3..P7, NCHW
        sizes_wh: torch.Tensor,             # (B, 2) true (w, h)
        supp_pooled,                        # per level (B or 1, 1, 1, C)
        supp_7x7: torch.Tensor,             # (B or 1, shot, 7, 7, C)
        target_ids=None,                    # (B,) or a scalar
    ) -> Boxes:
        """Fusion -> stage 1 -> stage 2 -> postprocess. With RPN_ONLY, the
        stage-1 proposals (the RPN settings, as the JAX package's
        ``detect_from_features``)."""
        c = self.config
        b = features[0].shape[0]
        dev = features[0].device
        sizes_wh = sizes_wh.to(torch.float32)
        if target_ids is None:
            target_ids = torch.ones((b,), dtype=torch.int32, device=dev)
        else:
            target_ids = torch.as_tensor(target_ids, dtype=torch.int32,
                                         device=dev).reshape(-1).expand(b)

        stage1 = self._fcos_head(features, supp_pooled)
        with record_function("fcos_postprocess"):
            proposals = fcos_postprocess(
                *stage1, sizes_wh,
                c.pre_nms_top_n_test, c.rpn_nms_thresh, c.fpn_post_nms_top_n_test,
                c.nms_pre_topk, 0.0, c.score_mode, level_topk=c.strict_level_topk)
        if c.rpn_only:
            return proposals
        if c.eval_roi_topk:
            proposals = truncate_boxes(proposals, c.eval_roi_topk)

        with record_function("roi_pool"):
            roi_feats = self._pool_rois(features, proposals).to(self.dtype)
        with record_function("roi_head"):
            supp_7x7 = supp_7x7.expand((b,) + supp_7x7.shape[1:]).to(self.dtype)
            cls_logits, box_deltas = self._roi_head_multi_shot(roi_feats, supp_7x7)
        with record_function("roi_postprocess"):
            return roi_head_postprocess(
                cls_logits, box_deltas, proposals, target_ids,
                BoxCoder(c.bbox_reg_weights), c.roi_score_thresh,
                c.roi_nms_thresh, c.roi_detections_per_img, c.second_stage_cls_loss)

    @torch.inference_mode()
    def forward(self, images: ImageBatch, images_supp: ImageBatch,
                target_ids: Optional[torch.Tensor] = None) -> Boxes:
        """Eval forward: padded detections (B, K) with fields 'scores' and
        'labels' (or, with RPN_ONLY, the stage-1 detections)."""
        b = images.batch_size
        features = self.backbone_features(images)
        supp_pooled, supp_7x7 = self.compute_support_features(images_supp, b)
        c = self.config
        if c.rpn_only:
            # the FCOS stage-1 settings, as the JAX package's __call__
            stage1 = self._fcos_head(features, supp_pooled)
            with record_function("fcos_postprocess"):
                return fcos_postprocess(
                    *stage1, images.sizes_wh().to(torch.float32),
                    c.fcos_pre_nms_top_n, c.fcos_nms_th, c.detections_per_img_rpn_only,
                    c.nms_pre_topk, c.inference_th, c.score_mode,
                    level_topk=c.strict_level_topk)
        return self.detect_from_features(features, images.sizes_wh(),
                                         supp_pooled, supp_7x7, target_ids)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer from ``generator``, a CPU generator:
    values are drawn on the CPU and copied, so a seed gives the same weights
    on every device. Backbone convs are variance-scaled uniform, FPN convs
    and fc6/fc7 kaiming-uniform(a=1), other head layers N(0, 0.01) (bbox_pred
    N(0, 0.001)) with the FCOS prior bias on cls_logits; FrozenBN statistics
    are the identity and GN/Scale factors 1."""
    prior = model.config.prior_prob

    def uniform(shape, scale):
        bound = math.sqrt(3.0 * scale / math.prod(shape[1:]))   # var scale/fan_in
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)

    def normal(shape, std):
        return torch.empty(shape).normal_(0.0, std, generator=generator)

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
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                shape = tuple(mod.weight.shape)
                if ".body." in name:
                    w = uniform(shape, 1.0)
                elif ".fpn." in name or name.endswith(("fc6", "fc7")):
                    w = uniform(shape, 1.0 / 3.0)
                elif name == "roi_heads.box.predictor.bbox_pred":
                    w = normal(shape, 0.001)
                else:
                    w = normal(shape, 0.01)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
                    if name.endswith("cls_logits"):
                        mod.bias.fill_(-math.log((1 - prior) / prior))


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
