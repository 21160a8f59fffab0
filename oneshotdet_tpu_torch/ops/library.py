"""The op boundary: the port's kernels as ``torch.library`` custom ops.

Three ops under the ``oneshotdet`` namespace, each with a fake (meta)
implementation that gives its outputs' shapes and dtypes from the inputs'
shapes alone, so that ``torch.export`` traces through them and an
AOTInductor package calls them:

- ``oneshotdet::roi_align``: multi-level ROIAlign. CPU tensors take
  ``multilevel_roi_align_plain``, CUDA tensors launch K1
  (``multilevel_roi_align_cuda``). Its autograd is registered: the gradient
  reaches the feature levels only, through ``oneshotdet::roi_align_backward``
  (K1b on CUDA tensors, ``multilevel_roi_align_backward_plain`` on CPU
  tensors), which returns the levels' gradients as one flat level-major
  tensor.
- ``oneshotdet::roi_head_fused``: the fused relation head. CPU tensors take
  ``fused_roi_head_plain``, CUDA tensors launch K3 (``fused_roi_head_cuda``).
  The operands of ``kernel_operands`` travel as a tensor list in
  ``OPERAND_KEYS`` order, the route's pre-tiled weights as a second list
  (``ROUTE_TILES`` order; empty on the CPU).
- ``oneshotdet::nms_keep_mask``: greedy NMS's keep mask, plain PyTorch on
  every device (``ops.nms.nms_keep_mask_plain``); an op so that its
  data-dependent loop stays out of a traced graph.

A CUDA tensor launches its kernel or raises; nothing gives way to a plain
version. The kernels' launch counters count inside the CUDA implementations,
so launches made from a loaded artifact count too. A process that loads an
AOTInductor package of the port imports this module first. No kernel is
built when this module is imported.
"""

from typing import List, Optional, Tuple

import torch

from . import nms as _nms
from . import roi_align as _ra
from . import roi_head_fused as _rf

# kernel_operands' tensors, in the order the fused head's op takes them
OPERAND_KEYS = ("c0a", "c0s", "c0b", "gn0g", "gn0b", "c1", "c1b", "gn1g", "gn1b",
                "ag", "agb", "gng", "gnb", "fc6", "fc6b", "fc7", "fc7b", "pred", "predb")


# -- K1 and K1b ------------------------------------------------------------------

@torch.library.custom_op("oneshotdet::roi_align", mutates_args=(), device_types="cpu")
def roi_align(features: List[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
              valid: Optional[torch.Tensor], output_size: List[int], scales: List[float],
              sampling_ratio: int) -> torch.Tensor:
    """(R, pooled_h, pooled_w, C) in the features' dtype; zeros where
    ``valid`` is False."""
    return _ra.multilevel_roi_align_plain(features, rois, levels, tuple(output_size),
                                          scales, sampling_ratio, valid)


@roi_align.register_kernel("cuda")
def _roi_align_cuda(features, rois, levels, valid, output_size, scales, sampling_ratio):
    return _ra.multilevel_roi_align_cuda(features, rois, levels, tuple(output_size), scales,
                                         sampling_ratio, valid)


@roi_align.register_fake
def _roi_align_fake(features, rois, levels, valid, output_size, scales, sampling_ratio):
    return features[0].new_empty((rois.shape[0], output_size[0], output_size[1],
                                  features[0].shape[-1]))


@torch.library.custom_op("oneshotdet::roi_align_backward", mutates_args=(), device_types="cpu")
def roi_align_backward(grad_out: torch.Tensor, feature_shapes: List[int], rois: torch.Tensor,
                       levels: torch.Tensor, valid: Optional[torch.Tensor],
                       output_size: List[int], scales: List[float],
                       sampling_ratio: int) -> torch.Tensor:
    """The levels' gradients in ``grad_out``'s dtype, one flat level-major
    tensor (each level's (B, H, W, C) block after the one before);
    ``feature_shapes`` is the levels' (B, H, W, C) flattened."""
    ws = _ra.multilevel_roi_align_backward_workspace(
        grad_out, _shapes(feature_shapes), rois, levels, tuple(output_size), scales,
        sampling_ratio, valid)
    return ws.to(grad_out.dtype).reshape(-1)


@roi_align_backward.register_kernel("cuda")
def _roi_align_backward_cuda(grad_out, feature_shapes, rois, levels, valid, output_size,
                             scales, sampling_ratio):
    return _ra.multilevel_roi_align_backward_cuda_flat(
        grad_out.contiguous(), _shapes(feature_shapes), grad_out.dtype, rois, levels,
        tuple(output_size), scales, sampling_ratio, valid)


@roi_align_backward.register_fake
def _roi_align_backward_fake(grad_out, feature_shapes, rois, levels, valid, output_size,
                             scales, sampling_ratio):
    total = 0
    for b, h, w, c in _shapes(feature_shapes):
        total = total + b * h * w * c
    return grad_out.new_empty((total,))


def _shapes(flat: List[int]) -> List[Tuple[int, int, int, int]]:
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


def _roi_align_setup(ctx, inputs, output):
    features, rois, levels, valid, output_size, scales, sampling_ratio = inputs
    ctx.save_for_backward(rois, levels, valid)
    ctx.geometry = ([d for f in features for d in f.shape], output_size, scales,
                    sampling_ratio)


def _roi_align_grad(ctx, grad_out):
    rois, levels, valid = ctx.saved_tensors
    shapes, output_size, scales, sampling_ratio = ctx.geometry
    flat = roi_align_backward(grad_out, shapes, rois, levels, valid, output_size, scales,
                              sampling_ratio)
    grads, start = [], 0
    for b, h, w, c in _shapes(shapes):
        grads.append(flat[start:start + b * h * w * c].view(b, h, w, c))
        start = start + b * h * w * c
    return grads, None, None, None, None, None, None


roi_align.register_autograd(_roi_align_grad, setup_context=_roi_align_setup)


# -- K3 ------------------------------------------------------------------------------

@torch.library.custom_op("oneshotdet::roi_head_fused", mutates_args=(), device_types="cpu")
def roi_head_fused(roi_feats: torch.Tensor, supp_7x7: torch.Tensor, operands: List[torch.Tensor],
                   tiles: List[torch.Tensor], ncls: int,
                   per_image: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (logits (R, ncls), deltas (R, npred - ncls))."""
    logits, deltas = _rf.fused_roi_head_plain(
        roi_feats, supp_7x7, _operand_dict(roi_feats.dtype, operands, tiles, ncls, False),
        per_image)
    return logits.clone(), deltas.clone()      # two slices of one product


@roi_head_fused.register_kernel("cuda")
def _roi_head_fused_cuda(roi_feats, supp_7x7, operands, tiles, ncls, per_image):
    return _rf.fused_roi_head_cuda(
        roi_feats, supp_7x7, _operand_dict(roi_feats.dtype, operands, tiles, ncls, True),
        per_image)


@roi_head_fused.register_fake
def _roi_head_fused_fake(roi_feats, supp_7x7, operands, tiles, ncls, per_image):
    r, npred = roi_feats.shape[0], operands[OPERAND_KEYS.index("pred")].shape[1]
    return (roi_feats.new_empty((r, ncls), dtype=torch.float32),
            roi_feats.new_empty((r, npred - ncls), dtype=torch.float32))


def _operand_dict(dtype, operands, tiles, ncls, tiled):
    """The op's lists -> ``kernel_operands``' dict for ``dtype`` (the
    kernel's wrapper raises where a tile it reads is missing)."""
    ops = dict(zip(OPERAND_KEYS, operands), dtype=dtype, ncls=ncls, tiled=tiled)
    if tiles:
        ops.update(zip(_rf.ROUTE_TILES[dtype], tiles))
    return ops


def head_operand_lists(ops) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``kernel_operands``' dict -> (operands, tiles) as the fused head's op
    takes them; tiles only where the dict holds all of its route's."""
    tiles = [ops.get(k) for k in _rf.ROUTE_TILES.get(ops["dtype"], ())] if ops["tiled"] else []
    return [ops[k] for k in OPERAND_KEYS], [] if None in tiles else tiles


# -- NMS ---------------------------------------------------------------------------------

@torch.library.custom_op("oneshotdet::nms_keep_mask", mutates_args=())
def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                  iou_threshold: float) -> torch.Tensor:
    """Greedy NMS's keep mask (..., K) in the original index order."""
    return _nms.nms_keep_mask_plain(boxes, scores, valid, iou_threshold)


@nms_keep_mask.register_fake
def _nms_keep_mask_fake(boxes, scores, valid, iou_threshold):
    return torch.empty_like(valid)
