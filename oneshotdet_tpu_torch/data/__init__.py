from .build import build_dataset, make_data_loader
from .coco_api import LiteCOCO
from .transforms import get_resize_size

__all__ = ["LiteCOCO", "build_dataset", "get_resize_size", "make_data_loader"]
