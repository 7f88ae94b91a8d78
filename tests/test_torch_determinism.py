"""Reproducible densification and gradient reduction in gsplat_tpu_torch,
against the JAX package on the CPU.

- the template sampler's searched CDF (``mcmc._template_cdf``) over four
  16384-element tiles of ``multi_cumsum``, with zero-probability rows at
  the tile joins and past ``n_alive``: never decreasing, flat across every
  zero row; a u placed in each up-step that the raw scan takes at a zero
  row (found in ``multi_cumsum_plain``'s output, where a plain
  searchsorted would draw the zero row) draws a positive row; 2^20 draws
  return no zero-probability row;
- the port's sampler and JAX's ``_sample_templates`` draw the same
  distribution: 2^20 draws each, 64 row buckets, every bucket within 5
  sigma of its exact probability (JAX's may draw zero rows: its cumsum
  on the CPU steps up at some of them; the port's draws none);
- two densifications from one seeded generator are bit-equal (states,
  Adam moments, ``n_alive``, templates), static and SwinGS;
- the scatter branch of the per-Gaussian reduction
  (``rasterize._scatter_reduce``: ``index_put_(accumulate=True)`` on the
  card, ``index_add_`` on the CPU) twice bit-equal, and against a float64
  sum, JAX's scatter-add and ``index_put_``, within
  ``test_segsum_reduce_matches_scatter_add``'s 2e-6 of the largest sum.

Their card counterparts (the sampler and the reduction twice, bit-equal)
are ``gpu`` tests in the JAX-free tests/test_torch_kernels.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu.model import mcmc as jmcmc
from gsplat_tpu_torch.model import mcmc as tmcmc
from gsplat_tpu_torch.model import optim as toptim
from gsplat_tpu_torch.model import swin as tswin
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import scan_kernel as tscan
from gsplat_tpu_torch.train import step as tstep
from gsplat_tpu_torch.train import swin_step as tsstep
from tests.test_torch_swin import state_pair
from tests.test_torch_train import _states

# the module (the package exports a function of the same name)
jrasterize = importlib.import_module("gsplat_tpu.raster.rasterize")
BLOCK = tscan.CUMSUM_BLOCK
ROWS, ALIVE = 50_000, 49_500     # four scan tiles; zero rows past ALIVE


def tile_join_probs(seed):
    """[ROWS] float32 probabilities: opacity-like values, a zero row at the
    start of each scan tile after the first, and zeros past ALIVE."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.005, 1.0, ROWS).astype(np.float32)
    p[rng.uniform(size=ROWS) < 0.05] = 0.0
    p[np.arange(BLOCK, ROWS, BLOCK)] = 0.0
    p[ALIVE:] = 0.0
    return torch.from_numpy(p)


def zero_row_up_steps(probs):
    """(zero row, lower, upper) of each zero row where the raw scan steps
    up (upper > lower: a u in (lower, upper] draws the row from the raw
    scan), and the count of down-steps of the raw scan."""
    raw = tscan.multi_cumsum_plain(probs[None])[0]
    prev, cur = raw[:-1], raw[1:]
    zero = probs[1:] == 0
    up = torch.nonzero(zero & (cur > prev))[:, 0] + 1
    return ([(int(z), float(raw[z - 1]), float(raw[z])) for z in up],
            int((cur < prev).sum()))


def test_template_cdf_is_flat_at_zero_rows_across_tile_joins():
    ups, downs, joins = [], 0, 0
    for seed in range(20):
        probs = tile_join_probs(seed)
        cdf = tmcmc._template_cdf(probs)
        assert bool((cdf[1:] >= cdf[:-1]).all())        # never decreases
        zero = torch.nonzero(probs[1:] == 0)[:, 0] + 1
        assert torch.equal(cdf[zero], cdf[zero - 1])     # flat at zero rows
        assert float(cdf[-1]) > 0.0
        found, d = zero_row_up_steps(probs)
        downs += d
        joins += sum(z % BLOCK == 0 for z, _, _ in found)
        for z, lo, hi in found:
            # u in the raw scan's up-step: the plain searchsorted picks
            # the zero row, the sampler's array a positive one
            u = torch.tensor([np.nextafter(np.float32(lo), np.float32(hi)),
                              hi], dtype=torch.float32)
            raw = tscan.multi_cumsum_plain(probs[None])[0]
            assert int(torch.searchsorted(raw, u[1:], side="left")) == z
            idx = torch.searchsorted(cdf, u, side="left")
            assert bool((probs[idx] > 0).all()), (seed, z, idx)
        ups.append(len(found))
    # the seeds do meet the fault: up-steps at zero rows (tile joins among
    # them) and down-steps of the raw scan
    assert sum(ups) > 0 and joins > 0 and downs > 0, (ups, joins, downs)


def test_sampler_draws_no_zero_probability_row():
    probs = tile_join_probs(0)
    gen = torch.Generator().manual_seed(0)
    draws = torch.cat([tmcmc._sample_templates(gen, probs, ROWS)
                       for _ in range(-(-(1 << 20) // ROWS))])
    assert draws.numel() >= 1 << 20
    assert int((probs[draws] == 0).sum()) == 0
    assert int(draws.max()) < ALIVE


def test_sampler_distribution_matches_jax():
    """2^20 draws of each package over 2^16 rows (four scan tiles) against
    the exact bucket probabilities, 64 buckets, 5 sigma."""
    rows, n_buckets, calls = 1 << 16, 64, 16
    rng = np.random.default_rng(5)
    p = (rng.uniform(0, 1, rows) ** 3).astype(np.float32)
    p[rng.uniform(size=rows) < 0.2] = 0.0
    p[np.arange(0, rows, BLOCK)] = 0.0
    bucket = np.arange(rows) // (rows // n_buckets)
    exact = np.bincount(bucket, p.astype(np.float64), n_buckets)
    exact /= exact.sum()
    n = calls * rows

    gen = torch.Generator().manual_seed(1)
    tp = torch.from_numpy(p)
    t_draws = np.concatenate([tmcmc._sample_templates(gen, tp, rows).numpy()
                              for _ in range(calls)])
    jsample = jax.jit(jmcmc._sample_templates, static_argnums=2)
    keys = jax.random.split(jax.random.PRNGKey(1), calls)
    j_draws = np.concatenate([np.asarray(jsample(k, jnp.asarray(p), rows))
                              for k in keys])
    sigma = np.sqrt(n * exact * (1 - exact))
    # the port never draws a zero row; JAX's CPU cumsum steps up at some
    # zero rows (101 of 13,088 here), so its draws may (13 of 2^20 here)
    assert (p[t_draws] > 0).all()
    for name, d in (("port", t_draws), ("jax", j_draws)):
        assert d.shape == (n,), name
        counts = np.bincount(bucket[d], minlength=n_buckets)
        z = np.abs(counts - n * exact) / sigma
        assert z.max() < 5.0, (name, float(z.max()))


def _leaves(state, adam):
    return ([state.n_alive] + list(state.params().values())
            + list(adam.mu.values()) + list(adam.nu.values()))


def _bit_equal(a, b):
    return all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(a, b, strict=True))


def test_static_densification_is_reproducible(monkeypatch):
    ts, _, tadam, _, _ = _states(seed=10)
    drawn = []
    sample = tmcmc._sample_templates
    monkeypatch.setattr(tmcmc, "_sample_templates",
                        lambda *a: drawn.append(sample(*a)) or drawn[-1])
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        s, a = tstep.make_densify_step(64)(ts, tadam, gen)
        runs.append(_leaves(s, a))
    assert len(drawn) == 4                       # relocation + growth, twice
    assert _bit_equal(runs[0], runs[1])
    assert torch.equal(drawn[0], drawn[2]) and torch.equal(drawn[1],
                                                           drawn[3])
    assert runs[0][0] > ts.n_alive


def test_swin_densification_is_reproducible(monkeypatch):
    ts, _ = state_pair(seed=3, cap=48, buf=32, n=40, m_count=20,
                       lifespan=4)
    # a few dead rows in every birth frame, so each frame's draw is used
    opa = ts.im.opacity.clone()
    opa[::3] = -8.0
    ts = dataclasses.replace(ts, im=dataclasses.replace(ts.im, opacity=opa))
    adam = toptim.init(ts.params())
    drawn = []
    sample = tmcmc._sample_templates
    monkeypatch.setattr(tmcmc, "_sample_templates",
                        lambda *a: drawn.append(sample(*a)) or drawn[-1])
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(4)
        s, a = tsstep.make_swin_densify_step(48, 4)(ts, adam, gen, 0.0, True)
        runs.append([s.im.n_alive, s.frame_start, s.frame_end]
                    + _leaves(s.im, a)[1:]
                    + [getattr(s, k) for k in tswin.RIGID_KEYS])
    assert len(drawn) == 2 * (4 + 1)    # a draw a window frame, then growth
    assert _bit_equal(runs[0], runs[1])
    assert all(torch.equal(x, y) for x, y in zip(drawn[:5], drawn[5:]))


def _reduction_case(seed=9, k=20_000, p1=700):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, p1, k).astype(np.int32)
    gid[rng.uniform(size=k) < 0.3] = p1 - 1          # padding slots
    dfeat = rng.normal(size=(9, k)).astype(np.float32)
    dfeat[:, gid == p1 - 1] = 0.0
    return dfeat, gid, p1


def test_scatter_reduce_matches_float64_and_jax():
    dfeat, gid, p1 = _reduction_case()
    exact = np.zeros((p1, 9), np.float64)
    np.add.at(exact, gid, dfeat.T.astype(np.float64))
    scale = np.abs(exact).max()
    t = torch.from_numpy
    got = trasterize._scatter_reduce(t(dfeat), t(gid), p1)
    assert torch.equal(got, trasterize._scatter_reduce(t(dfeat), t(gid), p1))
    card_op = torch.zeros(p1, 9).index_put_((t(gid).long(),), t(dfeat).t(),
                                            accumulate=True)
    seg_bounds = np.zeros(p1, np.int32)       # unused by the scatter branch
    jgot = jrasterize._gather_rows_t_bwd(
        p1, True, (jnp.asarray(gid), jnp.asarray(seg_bounds)),
        jnp.asarray(dfeat))[0]
    for want in (exact, card_op.numpy(), np.asarray(jgot)):
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   atol=2e-6)
