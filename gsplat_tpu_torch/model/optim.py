"""Adam with per-group learning rates and moment surgery (port of
gsplat_tpu/model/optim.py).

torch.optim.Adam(eps=1e-15) as the reference configures it
(gaussian_model_static.py:200): betas (0.9, 0.999), bias correction, eps
added after the sqrt. Learning rates come per step as a dict keyed by the
parameter-group name. ``zero_moments_at`` replaces the reference's
optimizer-state surgery (replace_tensors_to_optimizer,
gaussian_model_static.py:354-392): both moments zeroed at masked rows.
The functions return new tensors and never update in place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Params
    nu: Params
    count: int


def init(params: Params) -> AdamState:
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     count=0)


@torch.no_grad()
def step(params: Params, grads: Params, state: AdamState,
         lrs: Dict[str, float], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-15):
    """One Adam step; returns (new params, new AdamState)."""
    count = state.count + 1
    # bias corrections in float32, as JAX computes them
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(count))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(count))
    new_params, new_mu, new_nu = {}, {}, {}
    for name, p in params.items():
        g = grads[name]
        mu = b1 * state.mu[name] + (1 - b1) * g
        nu = b2 * state.nu[name] + (1 - b2) * (g * g)
        update = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        new_params[name] = p - lrs[name] * update
        new_mu[name] = mu
        new_nu[name] = nu
    return new_params, AdamState(mu=new_mu, nu=new_nu, count=count)


def zero_moments_at(state: AdamState, row_mask: torch.Tensor) -> AdamState:
    """Zero both moments at the rows of ``row_mask`` [C] (all groups)."""
    def zero(leaf):
        m = row_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(m, torch.zeros_like(leaf), leaf)

    return AdamState(mu={k: zero(v) for k, v in state.mu.items()},
                     nu={k: zero(v) for k, v in state.nu.items()},
                     count=state.count)
