from .inference import (
    compute_on_dataset,
    inference,
    make_cached_support_eval_steps,
    make_eval_step,
    make_multiclass_eval_step,
)

__all__ = [
    "compute_on_dataset",
    "inference",
    "make_cached_support_eval_steps",
    "make_eval_step",
    "make_multiclass_eval_step",
]
