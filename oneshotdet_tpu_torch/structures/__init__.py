from .boxes import (Boxes, box_area, box_iou, cat_boxes, clip_to_image, masked_box_iou,
                    truncate_boxes)
from .image_batch import ImageBatch

__all__ = ["Boxes", "ImageBatch", "box_area", "box_iou", "cat_boxes", "clip_to_image",
           "masked_box_iou", "truncate_boxes"]
