from .transforms import get_resize_size

__all__ = ["get_resize_size"]
