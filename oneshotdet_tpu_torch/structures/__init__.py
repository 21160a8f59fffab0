from .boxes import (Boxes, box_area, box_iou, cat_boxes, clip_to_image, compact_boxes,
                    masked_box_iou, truncate_boxes)
from .image_batch import ImageBatch, round_up, to_image_batch

__all__ = ["Boxes", "ImageBatch", "box_area", "box_iou", "cat_boxes", "clip_to_image",
           "compact_boxes", "masked_box_iou", "round_up", "to_image_batch", "truncate_boxes"]
