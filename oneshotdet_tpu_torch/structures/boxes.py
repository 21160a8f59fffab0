"""Padded, fixed-capacity boxes (counterpart of the JAX package's ``Boxes``).

    xyxy:  (..., K, 4) float   boxes, 'xyxy' pixel coords
    valid: (..., K)    bool    which slots hold real boxes
    size:  (..., 2)    float   image (width, height), the BoxList.size order

The reference's legacy ``TO_REMOVE = 1`` pixel convention holds throughout:
width = x2 - x1 + 1, and IoU uses the same +1 extents.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

TO_REMOVE = 1.0


@dataclasses.dataclass
class Boxes:
    xyxy: torch.Tensor
    valid: torch.Tensor
    size: torch.Tensor
    fields: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return self.xyxy.shape[-2]

    def get_field(self, name: str) -> torch.Tensor:
        return self.fields[name]


def box_area(xyxy: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...) areas under the +1 convention."""
    return (xyxy[..., 2] - xyxy[..., 0] + TO_REMOVE) * (xyxy[..., 3] - xyxy[..., 1] + TO_REMOVE)


def clip_to_image(xyxy: torch.Tensor, sizes_wh: torch.Tensor) -> torch.Tensor:
    """Clamp (B, K, 4) boxes to [0, w - 1] x [0, h - 1] of each image's
    (B, 2) (w, h)."""
    w = sizes_wh[:, 0:1]
    h = sizes_wh[:, 1:2]
    zero = torch.zeros_like(w)
    return torch.stack([
        torch.clamp(xyxy[..., 0], zero, w - TO_REMOVE),
        torch.clamp(xyxy[..., 1], zero, h - TO_REMOVE),
        torch.clamp(xyxy[..., 2], zero, w - TO_REMOVE),
        torch.clamp(xyxy[..., 3], zero, h - TO_REMOVE),
    ], dim=-1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., M, 4) and (..., N, 4) -> (..., M, N), +1 extents."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + TO_REMOVE, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a + area_b - inter)


def masked_box_iou(a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor,
                   b_valid: torch.Tensor) -> torch.Tensor:
    """``box_iou`` with the pairs of an invalid row or column set to 0."""
    mask = a_valid[..., :, None] & b_valid[..., None, :]
    return torch.where(mask, box_iou(a, b), 0.0)


def cat_boxes(a: Boxes, b: Boxes) -> Boxes:
    """Concatenate along the capacity axis; fields present in both are kept."""
    k_axis = a.valid.dim() - 1
    fields = {k: torch.cat([a.fields[k], b.fields[k]], dim=k_axis)
              for k in a.fields if k in b.fields}
    return Boxes(
        xyxy=torch.cat([a.xyxy, b.xyxy], dim=-2),
        valid=torch.cat([a.valid, b.valid], dim=-1),
        size=a.size,
        fields=fields,
    )


def truncate_boxes(boxes: Boxes, k: int) -> Boxes:
    """The first ``k`` capacity slots of batched (B, K) Boxes."""
    if boxes.capacity <= k:
        return boxes
    return Boxes(
        xyxy=boxes.xyxy[:, :k],
        valid=boxes.valid[:, :k],
        size=boxes.size,
        fields={n: v[:, :k] for n, v in boxes.fields.items()},
    )
