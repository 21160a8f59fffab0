from .inference import (
    compute_on_dataset,
    inference,
    make_cached_support_eval_steps,
    make_eval_step,
    make_multiclass_eval_step,
)
from .trainer import batch_to_inputs, do_train, step_generator, train_step

__all__ = [
    "batch_to_inputs",
    "compute_on_dataset",
    "do_train",
    "inference",
    "make_cached_support_eval_steps",
    "make_eval_step",
    "make_multiclass_eval_step",
    "step_generator",
    "train_step",
]
