"""JAX (flax) variables -> the port's reference-keyed state dict.

The port's own copy of the name map of
``oneshotdet_tpu/utils/torch_export.py::map_flax_leaf`` and its layout
transforms: HWIO conv kernels -> OIHW, (in, out) dense kernels -> (out, in),
scalar FCOS scales () -> (1,). Beyond the JAX package's map it carries
``supp_aug_conv`` (FEW_SHOT.SUPP_AUG_METHOD 'conv') and the mask and keypoint
heads (MODEL.MASK_ON / KEYPOINT_ON: ``roi_heads.mask.feature_extractor.
mask_fcn{i}``, ``roi_heads.mask.predictor.{conv5_mask,mask_fcn_logits}``,
``roi_heads.keypoint.feature_extractor.conv_fcn{i}``,
``roi_heads.keypoint.predictor.kps_score_lowres``), under the reference
modules' names; a flax ``ConvTranspose`` kernel (kh, kw, in, out) becomes
the (in, out, kh, kw) weight of ``conv_transpose2d`` flipped in both
spatial axes. A tree transformed by the JAX package's
``quantize_weights_int8`` (TPU.QUANT 'int8_weight') keeps its int8 kernels
and carries its ``quant_scales`` as ``<module>.weight_scale``. The result
loads into ``models.GeneralizedRCNN`` with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_PREDICTOR = {"cls_score", "bbox_pred"}
_FCOS_FINAL = {"cls_logits", "bbox_pred", "centerness"}
_COMPRESS = {"compress_0": 0, "compress_gn0": 1, "compress_1": 3, "compress_gn1": 4}
_HEADS = {"mask_head": "mask", "keypoint_head": "keypoint"}
_DECONV = {"conv5_mask", "kps_score_lowres"}


def _w(leaf: str) -> str:
    return "weight" if leaf in ("kernel", "scale") else "bias"


def _t(leaf: str, kind: str) -> str:
    return kind if leaf == "kernel" else "none"


def map_flax_leaf(collection: str, path: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
    """(collection, flax path) -> (state-dict key, transform) or None."""
    p = path
    if p[0] in ("backbone", "supp_backbone"):
        net = p[0]
        if p[1] == "body":
            if p[2] == "stem":
                if collection == "params" and p[3:] == ("conv1", "kernel"):
                    return f"{net}.body.stem.conv1.weight", "conv"
                if collection == "constants" and p[3] == "bn1":
                    return f"{net}.body.stem.bn1.{p[4]}", "none"
                return None
            m = re.match(r"^layer(\d)_(\d+)$", p[2])
            if not m:
                return None
            s, b = m.groups()
            if collection == "params":
                r = re.match(r"^conv(\d)$", p[3])
                if r and p[4] == "kernel":
                    return f"{net}.body.layer{s}.{b}.conv{r.group(1)}.weight", "conv"
                if p[3] == "downsample_conv" and p[4] == "kernel":
                    return f"{net}.body.layer{s}.{b}.downsample.0.weight", "conv"
            else:
                r = re.match(r"^bn(\d)$", p[3])
                if r:
                    return f"{net}.body.layer{s}.{b}.bn{r.group(1)}.{p[4]}", "none"
                if p[3] == "downsample_bn":
                    return f"{net}.body.layer{s}.{b}.downsample.1.{p[4]}", "none"
            return None
        if p[1] == "fpn" and collection == "params":
            name, leaf = p[2], p[3]
            if re.match(r"^(fpn_inner\d|fpn_layer\d)$", name):
                return f"{net}.fpn.{name}.{_w(leaf)}", _t(leaf, "conv")
            r = re.match(r"^top_p(\d)$", name)
            if r:
                return f"{net}.fpn.top_blocks.p{r.group(1)}.{_w(leaf)}", _t(leaf, "conv")
        return None

    if collection != "params":
        return None

    if p == ("supp_aug_conv", "kernel"):
        return "supp_aug_conv.weight", "conv"

    if p[0] in _HEADS and len(p) == 4 and p[1] in ("feature_extractor", "predictor"):
        if re.match(r"^(mask_fcn\d+|conv_fcn\d+|mask_fcn_logits)$", p[2]) or p[2] in _DECONV:
            kind = "deconv" if p[2] in _DECONV else "conv"
            return f"roi_heads.{_HEADS[p[0]]}.{p[1]}.{p[2]}.{_w(p[3])}", _t(p[3], kind)
        return None

    if p[0] == "fcos_head":
        m = re.match(r"^(cls_tower|bbox_tower)_(\d+)$", p[1])
        if m:
            tower, block = m.group(1), int(m.group(2))
            if p[2] == "Conv_0":
                return f"rpn.head.{tower}.{3 * block}.{_w(p[3])}", _t(p[3], "conv")
            if p[2] == "GroupNorm_0":
                return f"rpn.head.{tower}.{3 * block + 1}.{_w(p[3])}", "none"
            return None
        if p[1] in _FCOS_FINAL:
            return f"rpn.head.{p[1]}.{_w(p[2])}", _t(p[2], "conv")
        m = re.match(r"^scale_(\d)$", p[1])
        if m and p[2] == "scale":
            return f"rpn.head.scales.{m.group(1)}.scale", "scalar"
        return None

    if p[0] == "roi_head":
        name, leaf = p[1], p[2]
        if name in _COMPRESS:
            kind = "none" if "gn" in name else "conv"
            return f"roi_heads.box.compress_dim_conv.{_COMPRESS[name]}.{_w(leaf)}", _t(leaf, kind)
        if name == "aggreg":
            return f"roi_heads.box.feature_aggreg.0.{_w(leaf)}", _t(leaf, "conv")
        if name == "aggreg_gn":
            return f"roi_heads.box.feature_aggreg.1.{_w(leaf)}", "none"
        if name in ("fc6", "fc7"):
            return f"roi_heads.box.{name}.{_w(leaf)}", _t(leaf, "linear")
        if name in _PREDICTOR:
            return f"roi_heads.box.predictor.{name}.{_w(leaf)}", _t(leaf, "linear")
    return None


def _leaves(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def group_norm_params_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax ``FusedGroupNorm``'s params (``scale``, ``bias``) -> the state
    dict of ``models.layers.FusedGroupNorm`` (``weight``, ``bias``)."""
    extra = set(params) - {"scale", "bias"}
    if extra:
        raise KeyError(f"no FusedGroupNorm counterpart for {sorted(extra)}")
    return {_w(k): torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in params.items()}


def _map_leaf(collection: str, path: Tuple[str, ...]) -> Optional[Tuple[str, str]]:
    """``map_flax_leaf`` and, for the ``quant_scales`` collection of an
    'int8_weight' tree, a ``kernel_scale`` -> ``<module>.weight_scale``."""
    if collection != "quant_scales":
        return map_flax_leaf(collection, path)
    if path[-1] != "kernel_scale":
        return None
    mapping = map_flax_leaf("params", path[:-1] + ("kernel",))
    return None if mapping is None else (mapping[0] + "_scale", "none")


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'constants': ..., ['quant_scales': ...]}`` nested
    dicts of arrays -> the port's state dict, float32 but for the int8
    kernels of a tree transformed by the JAX package's
    ``quantize_weights_int8``, which stay int8 with their ``weight_scale``.
    Raises on a leaf with no counterpart."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "constants", "quant_scales"):
        for path, arr in _leaves(variables.get(collection, {})):
            mapping = _map_leaf(collection, path)
            if mapping is None:
                raise KeyError(f"no port counterpart for {collection}/{'/'.join(path)}")
            key, transform = mapping
            a = np.asarray(arr)
            a = a if a.dtype == np.int8 else a.astype(np.float32)
            if transform == "conv":
                a = a.transpose(3, 2, 0, 1)      # HWIO -> OIHW
            elif transform == "deconv":          # flipped (kh, kw, in, out) -> (in, out, kh, kw)
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif transform == "linear":
                a = a.transpose(1, 0)            # (in, out) -> (out, in)
            elif transform == "scalar":
                a = a.reshape((1,))
            out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out
