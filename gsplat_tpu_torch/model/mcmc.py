"""MCMC densification over a fixed-capacity state (port of
gsplat_tpu/model/mcmc.py).

- relocation math, Eq. 9 of 3DGS-MCMC (cuda_rasterizer/utils.cu:6-36),
  in the JAX package's closed form
  denom = sum_{j=1..N} (-1)^(j-1) C(N, j) o_new^j / sqrt(j);
- ``relocate_gs``: dead Gaussians (opacity <= 0.005) teleport onto
  opacity-sampled live templates (gaussian_model_static.py:425-455);
- ``add_new_gs``: +5% growth per call up to cap_max (:458-492);
- covariance-shaped, opacity-gated noise (train_static.py:132-140).

Sizes stay fixed (masks do the data-dependent work), as in JAX. The
randomness comes from an explicit ``torch.Generator``; the ``*_forced``
variants and ``raw_noise`` take injected draws, which is how the tests hold
the port against JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.special import comb as _comb

from gsplat_tpu_torch.core.covariance import covariance_6
from gsplat_tpu_torch.model import optim
from gsplat_tpu_torch.model.gaussians import GaussianState, inverse_sigmoid
from gsplat_tpu_torch.raster import scan_kernel

N_MAX = 51  # fan-out bound of utils/reloc_utils.py:7 (N clamped to 50)

_BINOM = np.zeros((N_MAX, N_MAX), np.float32)
for _n in range(N_MAX):
    for _j in range(_n + 1):
        _BINOM[_n, _j] = _comb(_n, _j)

_F32_EPS = float(np.finfo(np.float32).eps)
_F32_TINY = float(np.finfo(np.float32).tiny)


def compute_relocation(opacity_old, scale_old, n_samples):
    """New (opacity [M], scale [M, 3]) when a Gaussian splits into N
    copies; ``scale_old`` is activated, ``n_samples`` [M] int."""
    n = torch.clamp(n_samples, 1, N_MAX - 1).long()
    o_new = 1.0 - torch.pow(1.0 - opacity_old, 1.0 / n.float())
    binom = torch.as_tensor(_BINOM, device=opacity_old.device)[n]  # [M, N]
    denom = torch.zeros_like(o_new)
    power = torch.ones_like(o_new)
    for j in range(1, N_MAX):
        power = power * o_new
        sign = 1.0 if j % 2 == 1 else -1.0
        denom = denom + sign * binom[:, j] * power / float(np.sqrt(
            np.float32(j)))
    coeff = opacity_old / denom
    return o_new, coeff[:, None] * scale_old


def _relocated_raw(state: GaussianState, template_idx, counts_plus_one):
    """Raw (logit, log) opacity and scaling of rows cloned from templates,
    with the clamp of gaussian_model_static.py:405."""
    o_old = state.get_opacity()[template_idx, 0]
    s_old = state.get_scaling()[template_idx]
    o_new, s_new = compute_relocation(o_old, s_old, counts_plus_one)
    o_new = torch.clamp(o_new, 0.005, 1.0 - _F32_EPS)
    return inverse_sigmoid(o_new), torch.log(s_new)


def _template_cdf(probs):
    """The array the template sampler searches: ``scan_kernel.multi_cumsum``
    of ``probs`` [C], where row i holds the largest CDF value of a
    positive-probability row at or before i (0 before the first), by
    ``scan_kernel.multi_cummax`` over the values' bit patterns (a
    non-negative float32 orders as its int32 bits). One launch of each on
    the card, the same bits on every call. The raw scan may step down, or
    up across a zero row, where its sums round differently (at its
    16384-element tile joins, and inside a tile); this array never
    decreases and is flat across every zero-probability row."""
    p = probs[None].contiguous()
    cdf = scan_kernel.multi_cumsum(p)
    pos = torch.where(p > 0, cdf, torch.zeros_like(cdf))
    return scan_kernel.multi_cummax(pos.view(torch.int32)).view(
        torch.float32)[0]


def _sample_templates(gen: torch.Generator, probs, capacity: int):
    """iid opacity-weighted template indices for every row: inverse-CDF
    sampling (``_template_cdf`` + uniform + searchsorted). With u in
    (0, total] and ``side="left"``, a zero-probability row is never drawn
    while any mass is positive; each row keeps its probability up to the
    CDF's ULP, as in JAX's sampler."""
    cdf = _template_cdf(probs)
    u = torch.rand(capacity, generator=gen, device=probs.device)
    u = torch.clamp(u * cdf[-1], min=_F32_TINY)
    idx = torch.searchsorted(cdf, u, side="left")
    return torch.clamp(idx, 0, capacity - 1)


def _clone_rows(state: GaussianState, row_mask, t, o_raw, s_raw):
    """Rows in ``row_mask`` become clones of their template ``t``
    (opacity/scaling set to the relocated values); the sampled templates
    are weakened to the same values (gaussian_model_static.py:452-453,
    485-486). Returns (state, template_mask)."""
    c = state.capacity
    p = state.params()

    def take(leaf):
        m = row_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(m, leaf[t], leaf)

    new = {k: take(v) for k, v in p.items()}
    new["opacity"] = torch.where(row_mask[:, None], o_raw[:, None],
                                 p["opacity"])
    new["scaling"] = torch.where(row_mask[:, None], s_raw, p["scaling"])
    # weaken the templates: write the relocated values at the sampled rows
    # (rows outside the mask write to a dropped spare row)
    scatter_idx = torch.where(row_mask, t, torch.full_like(t, c))
    opa = torch.cat([new["opacity"], new["opacity"][:1]])
    opa[scatter_idx] = o_raw[:, None]
    scl = torch.cat([new["scaling"], new["scaling"][:1]])
    scl[scatter_idx] = s_raw
    new["opacity"], new["scaling"] = opa[:c], scl[:c]
    template_mask = torch.zeros(c + 1, dtype=torch.bool,
                                device=row_mask.device)
    template_mask[scatter_idx] = True
    return state.replace_params(new), template_mask[:c]


def _relocate_with(state: GaussianState, opt_state: optim.AdamState,
                   row_mask, t):
    """relocate_gs given the dead-row mask and a per-row template map
    ``t`` ([C]; only its entries at masked rows are used)."""
    counts = torch.zeros(state.capacity, dtype=torch.int64,
                         device=t.device).index_add_(
        0, t, row_mask.long())
    n_per_dead = counts[t] + 1
    o_raw, s_raw = _relocated_raw(state, t, n_per_dead)
    new_state, template_mask = _clone_rows(state, row_mask, t, o_raw, s_raw)
    return new_state, optim.zero_moments_at(opt_state, template_mask)


def _add_with(state: GaussianState, opt_state: optim.AdamState, t,
              target: int):
    """add_new_gs given the template map and the post-growth alive count
    ``target`` (new rows are [n_alive, target))."""
    c = state.capacity
    n = state.n_alive
    target = max(int(target), n)
    rows = torch.arange(c, device=t.device)
    new_mask = (rows >= n) & (rows < target)
    counts = torch.zeros(c, dtype=torch.int64, device=t.device).index_add_(
        0, t, new_mask.long())
    n_per_new = counts[t] + 1
    o_raw, s_raw = _relocated_raw(state, t, n_per_new)
    new_state, template_mask = _clone_rows(state, new_mask, t, o_raw, s_raw)
    new_state = dataclasses.replace(new_state, n_alive=target)
    return new_state, optim.zero_moments_at(opt_state,
                                            template_mask | new_mask)


def _source_probs(state: GaussianState, src):
    """(sampling weights, whether any source has positive opacity); with
    none, every alive row weighs 1."""
    opa = state.get_opacity()[:, 0]
    probs = torch.where(src, opa, torch.zeros_like(opa))
    any_src = bool((probs > 0).any())
    return (probs if any_src else state.alive_mask.float()), any_src


@torch.no_grad()
def relocate_gs(state: GaussianState, opt_state: optim.AdamState,
                gen: torch.Generator, dead_opacity: float = 0.005):
    """Teleport dead Gaussians onto live templates; Adam moments zeroed at
    the sampled template rows only (gaussian_model_static.py:455)."""
    alive = state.alive_mask
    opa = state.get_opacity()[:, 0]
    dead = alive & (opa <= dead_opacity)
    probs, any_src = _source_probs(state, alive & ~dead)
    t = _sample_templates(gen, probs, state.capacity)
    return _relocate_with(state, opt_state, dead & any_src, t)


@torch.no_grad()
def relocate_gs_forced(state: GaussianState, opt_state: optim.AdamState,
                       dead_mask, templates):
    """relocate_gs with the dead mask and per-row templates injected."""
    return _relocate_with(state, opt_state, dead_mask, templates.long())


@torch.no_grad()
def add_new_gs(state: GaussianState, opt_state: optim.AdamState,
               gen: torch.Generator, cap_max: int | None = None,
               growth: float = 1.05):
    """Activate up to +5% new rows (to the cap) as clones of
    opacity-sampled templates; moments zeroed at the new rows and at the
    weakened templates (gaussian_model_static.py:314-315, 490)."""
    c = state.capacity
    cap = c if cap_max is None else min(cap_max, c)
    n = state.n_alive
    target = max(min(cap, int(np.float32(growth) * np.float32(n))), n)
    probs, _ = _source_probs(state, state.alive_mask)
    t = _sample_templates(gen, probs, c)
    return _add_with(state, opt_state, t, target)


@torch.no_grad()
def add_new_gs_forced(state: GaussianState, opt_state: optim.AdamState,
                      templates, target: int):
    """add_new_gs with the templates of the new rows injected."""
    return _add_with(state, opt_state, templates.long(), target)


@torch.no_grad()
def inject_noise(state: GaussianState, gen: torch.Generator | None,
                 noise_lr: float, xyz_lr: float, raw_noise=None):
    """xyz += Sigma @ (randn * gate * noise_lr * xyz_lr) on alive rows,
    gate = sigmoid(100 * ((1 - opacity) - 0.995)). ``raw_noise`` ([C, 3]
    standard normal) replaces the generator's draw."""
    opa = state.get_opacity()
    gate = torch.sigmoid(100.0 * ((1.0 - opa) - 0.995))          # [C, 1]
    raw = (torch.randn(state.xyz.shape, generator=gen,
                       device=state.xyz.device)
           if raw_noise is None else raw_noise)
    noise = raw * gate * noise_lr * xyz_lr
    xx, xy, xz, yy, yz, zz = covariance_6(state.get_scaling(),
                                          state.get_rotation()).unbind(-1)
    nx, ny, nz = noise.unbind(-1)
    noise = torch.stack([xx * nx + xy * ny + xz * nz,
                         xy * nx + yy * ny + yz * nz,
                         xz * nx + yz * ny + zz * nz], dim=-1)
    noise = torch.where(state.alive_mask[:, None], noise,
                        torch.zeros_like(noise))
    return dataclasses.replace(state, xyz=state.xyz + noise)
