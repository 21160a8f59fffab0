from .coco_api import LiteCOCO
from .transforms import get_resize_size

__all__ = ["LiteCOCO", "get_resize_size"]
