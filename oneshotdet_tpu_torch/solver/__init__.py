"""Optimizer and learning-rate schedule (counterpart of
``oneshotdet_tpu/solver/__init__.py``).

``make_optimizer`` builds the reference's SGD with momentum and two
parameter groups: biases at BIAS_LR_FACTOR x BASE_LR with
WEIGHT_DECAY_BIAS, every other trainable parameter at BASE_LR with
WEIGHT_DECAY. ``torch.optim.SGD``'s update (weight decay added to the
gradient, then the momentum buffer, then the step) is optax's
``add_decayed_weights -> trace -> scale_by_learning_rate``. Frozen
parameters (the stem and layer1 of both backbones at FREEZE_CONV_BODY_AT = 2,
and names holding a FEW_SHOT.UNTRAINED_KEYWORD) get ``requires_grad_(False)``
and stay out of the optimizer, where the JAX package zeroes their updates.
``make_lr_scheduler`` is WarmupMultiStepLR as a ``LambdaLR``: the group's
learning rate times ``warmup_multistep_schedule``'s factor at the step count.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..models.resnet import frozen_param_paths


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                              warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                              warmup_method: str = "linear") -> Callable[[int], float]:
    """count -> learning rate: ``base_lr`` times the warmup factor (constant,
    or linear from ``warmup_factor`` to 1 over ``warmup_iters`` updates)
    times ``gamma`` for every milestone in ``steps`` reached."""
    if warmup_method not in ("constant", "linear"):
        raise ValueError(warmup_method)
    steps = tuple(steps)

    def schedule(count: int) -> float:
        wf = 1.0
        if count < warmup_iters:
            if warmup_method == "constant":
                wf = warmup_factor
            else:
                alpha = count / max(warmup_iters, 1)
                wf = warmup_factor * (1 - alpha) + alpha
        decay = 1.0
        for s in steps:
            if count >= s:
                decay *= gamma
        return base_lr * wf * decay

    return schedule


def param_label(name: str, untrained_keywords=(), freeze_conv_body_at: int = 2) -> str:
    """'frozen', 'bias' or 'weight' for a parameter's state-dict name (the
    counterpart of ``make_param_labels``' labels): frozen in both backbones'
    frozen stages and where an untrained keyword occurs; bias where the last
    name component holds 'bias'."""
    if any(kw and kw in name for kw in untrained_keywords):
        return "frozen"
    if any(f".body.{prefix}." in f".{name}" for prefix in frozen_param_paths(freeze_conv_body_at)):
        return "frozen"
    return "bias" if "bias" in name.rsplit(".", 1)[-1] else "weight"


def make_param_groups(cfg, model: nn.Module) -> List[Dict]:
    """Freeze what ``param_label`` calls frozen (``requires_grad_(False)``)
    and return the SGD groups of the rest: weights, then biases."""
    groups = {"weight": [], "bias": []}
    for name, p in model.named_parameters():
        label = param_label(name, cfg.FEW_SHOT.UNTRAINED_KEYWORD,
                            cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
        if label == "frozen":
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            groups[label].append(p)
    s = cfg.SOLVER
    return [
        {"params": groups["weight"], "lr": s.BASE_LR, "weight_decay": s.WEIGHT_DECAY},
        {"params": groups["bias"], "lr": s.BASE_LR * s.BIAS_LR_FACTOR,
         "weight_decay": s.WEIGHT_DECAY_BIAS},
    ]


def make_optimizer(cfg, model: nn.Module) -> torch.optim.SGD:
    """SGD with SOLVER.MOMENTUM over ``make_param_groups``."""
    return torch.optim.SGD(make_param_groups(cfg, model), lr=cfg.SOLVER.BASE_LR,
                           momentum=cfg.SOLVER.MOMENTUM)


def make_lr_scheduler(cfg, optimizer: torch.optim.Optimizer
                      ) -> torch.optim.lr_scheduler.LambdaLR:
    """WarmupMultiStepLR: each group's learning rate times the schedule's
    factor at the number of steps taken (the first step uses count 0, as
    optax's schedules do)."""
    s = cfg.SOLVER
    factor = warmup_multistep_schedule(1.0, s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                       s.WARMUP_ITERS, s.WARMUP_METHOD)
    return torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
