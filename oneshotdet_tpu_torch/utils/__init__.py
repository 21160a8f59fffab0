from .metric_logger import MetricLogger, SmoothedValue, TensorboardLogger, Timer
from .weights import map_flax_leaf, state_dict_from_flax

__all__ = ["MetricLogger", "SmoothedValue", "TensorboardLogger", "Timer", "map_flax_leaf",
           "state_dict_from_flax"]
