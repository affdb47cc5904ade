"""optax's RAdam as a PyTorch optimizer.

The JAX package trains the vocoders and the aligner with ``optax.radam``
(``optax/_src/transform.py::scale_by_radam``), which is not
``torch.optim.RAdam``:

* ``eps`` is added to ``sqrt(nu_hat)`` of the bias-corrected second moment
  (torch adds it before the bias correction);
* the update is rectified, ``r * mu_hat / (sqrt(nu_hat) + eps)``, where
  ``rho_t >= 5``, and is ``mu_hat`` itself before that: with b2 = 0.9 the
  first five updates are ``lr * mu_hat``;
* the rate is the group's ``lr`` at the update's start, which a torch
  scheduler stepped after each update keeps at the schedule's value of the
  updates done (optax reads its schedule at the pre-increment count).

Every parameter with a ``.grad`` moves its moments, a zero gradient's too:
give a parameter that the loss does not reach a zero gradient, as optax
updates every leaf of its tree.  The state per parameter is torch's
(``step``, ``exp_avg``, ``exp_avg_sq``), so it saves and loads as any torch
optimizer's.
"""

from __future__ import annotations

import math

import torch


class RAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
            b1, b2 = group["betas"]
            grads = [p.grad for p in params]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            for p in params:
                self.state[p]["step"] += 1
            t = int(self.state[params[0]]["step"])
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            b2t = b2 ** t
            ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
            mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
            if ro >= group["threshold"]:
                r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                              / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2t))
                torch._foreach_add_(denom, group["eps"])
                torch._foreach_mul_(mu_hat, r)
                torch._foreach_div_(mu_hat, denom)
            torch._foreach_add_(params, mu_hat, alpha=-group["lr"])
