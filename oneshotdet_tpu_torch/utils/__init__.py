from .weights import map_flax_leaf, state_dict_from_flax

__all__ = ["map_flax_leaf", "state_dict_from_flax"]
