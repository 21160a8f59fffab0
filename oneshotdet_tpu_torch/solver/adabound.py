"""AdaBound (counterpart of ``oneshotdet_tpu/solver/adabound.py``).

Adam with its per-parameter step size clipped into bounds that tighten
toward ``final_lr`` over time (Luo et al., ICLR 2019), with the JAX
package's formula, step t counted from 1:

    g = grad + weight_decay * p               (when weight_decay > 0)
    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2
    step_size = lr sqrt(1 - b2^t) / (1 - b1^t)
    lower = final_lr (1 - 1 / (gamma t + 1)),  upper = final_lr (1 + 1 / (gamma t))
    p = p - clip(step_size / (sqrt(v) + eps), lower, upper) m

The scalars of a step are float32, as the JAX transform computes them.
``final_lr`` is used as given (not scaled by lr / base_lr). Like the JAX
package's ``make_optimizer``, the trainer's ``make_optimizer`` does not
build it; construct it over the model's parameters or groups.
"""

from __future__ import annotations

import torch


class AdaBound(torch.optim.Optimizer):
    """AdaBound over parameter groups, each with lr, betas, final_lr, gamma,
    eps and weight_decay. ``amsbound`` is accepted and ignored, as the JAX
    transform ignores it: the update is AdaBound's, never AMSBound's."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), final_lr: float = 0.1,
                 gamma: float = 1e-3, eps: float = 1e-8, weight_decay: float = 0.0,
                 amsbound: bool = False):
        defaults = dict(lr=lr, betas=tuple(betas), final_lr=final_lr, gamma=gamma, eps=eps,
                        weight_decay=weight_decay, amsbound=amsbound)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"] > 0:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                c = torch.tensor(float(state["step"]), dtype=torch.float32)
                bc1 = 1 - b1 ** c
                bc2 = 1 - b2 ** c
                lower = float(group["final_lr"] * (1 - 1 / (group["gamma"] * c + 1)))
                upper = float(group["final_lr"] * (1 + 1 / (group["gamma"] * c)))
                step_size = float(group["lr"] * torch.sqrt(bc2) / bc1)
                step = torch.clamp(step_size / (torch.sqrt(v) + group["eps"]), lower, upper)
                p.sub_(step * m)
        return loss
