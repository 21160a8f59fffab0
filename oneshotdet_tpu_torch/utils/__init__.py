from .metric_logger import Timer
from .weights import map_flax_leaf, state_dict_from_flax

__all__ = ["Timer", "map_flax_leaf", "state_dict_from_flax"]
