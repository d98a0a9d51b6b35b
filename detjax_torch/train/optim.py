"""optax's adam, adamw and sgd as one ``torch.optim.Optimizer``.

detjax trains with ``optax.adam``, ``optax.adamw`` or ``optax.sgd(momentum
=0.9)`` (``detjax/train/step.py:48-68``). torch's own optimizers compute
the same rules in another order, and one of them differs in effect:
``torch.optim.AdamW`` decays by multiplying each parameter by ``1 - lr *
wd``, a factor rounded to fp32, so at detjax's defaults (lr 1e-5, optax's
wd 1e-4) the factor is exactly 1.0 and no decay happens at all. optax adds
``wd * p`` to the Adam direction before scaling by ``-lr``, where it
survives. This optimizer therefore follows optax's order of operations,
with ``torch._foreach`` ops over each parameter group:

  adam(w):  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;
            u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
            [+ wd * p];  p = p + (-lr) u
  sgd:      m = g + 0.9 m;  p = p + (-lr) m

with b1 0.9, b2 0.999, eps 1e-8, eps_root 0, and every scalar rounded
to fp32 as jax rounds a Python float.
"""

from __future__ import annotations

import numpy as np
import torch

RULES = ("adam", "adamw", "sgd")


def _f32(x: float) -> float:
    return float(np.float32(x))


class OptaxOptimizer(torch.optim.Optimizer):
    """``rule`` in "adam", "adamw" (``weight_decay`` added to the Adam
    direction) or "sgd" (``momentum``); the rate is ``param_groups[i]
    ["lr"]``, which the host may change between steps."""

    def __init__(self, params, rule: str, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, momentum: float = 0.9):
        if rule not in RULES:
            raise ValueError(f"unknown optimizer {rule!r}; have "
                             f"{', '.join(RULES)}")
        # the rule lives in the groups, which pickling and deepcopy keep
        super().__init__(params, dict(rule=rule, lr=lr, b1=b1, b2=b2,
                                      eps=eps, weight_decay=weight_decay,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxOptimizer takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["count"] = 0
                    self.state[p]["mu"] = torch.zeros_like(p)
                    if group["rule"] != "sgd":
                        self.state[p]["nu"] = torch.zeros_like(p)
            if group["rule"] == "sgd":
                u = self._sgd(group, params, grads)
            else:
                u = self._adam(group, params, grads)
            torch._foreach_mul_(u, _f32(-group["lr"]))
            torch._foreach_add_(params, u)

    def _sgd(self, group, params, grads):
        mu = [self.state[p]["mu"] for p in params]
        torch._foreach_mul_(mu, _f32(group["momentum"]))
        torch._foreach_add_(mu, grads)  # g + m * momentum
        for p in params:
            self.state[p]["count"] += 1
        return [m.clone() for m in mu]

    def _adam(self, group, params, grads):
        b1, b2 = group["b1"], group["b2"]
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mu, _f32(b1))
        torch._foreach_add_(mu, torch._foreach_mul(grads, _f32(1 - b1)))
        torch._foreach_mul_(nu, _f32(b2))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, _f32(1 - b2))
        torch._foreach_add_(nu, sq)
        count = self.state[params[0]]["count"] + 1
        for p in params:
            self.state[p]["count"] = count
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count))
        u = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _f32(group["eps"]))
        torch._foreach_div_(u, denom)
        if group["rule"] == "adamw":
            torch._foreach_add_(u, torch._foreach_mul(
                params, _f32(group["weight_decay"])))
        return u
