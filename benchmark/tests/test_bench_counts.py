"""CPU tests of the frozen work counts and of the benchmark's inputs:
hand-worked figures of PERF.md's kernel table, shares that cannot pass
100% by construction, the state drawn without a nearest-neighbour search
against bench_torch.trained_stats_state on the same draws, the cameras
against the port's.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import inputs  # noqa: E402
from benchmark.counts import (blend_backward, blend_forward,  # noqa: E402
                              merge_expand, peaks,
                              render, train_step, view_frame)


def ms(s):
    return s * 1e3


def test_merge_expand_bound_of_the_kernel_table():
    # PERF.md: 8P + 12K bytes at P = 1M, K = 3,431,424 -> 0.0147 ms
    work = {"gaussians": 1_000_000, "pairs": 3_431_424}
    assert ms(merge_expand.least_s(work)) == pytest.approx(0.0147, abs=5e-5)


def test_blend_and_render_counts():
    work = {"slots": 1000, "pixels": 64, "passing": 10_000}
    assert blend_forward.nbytes(work) == 1000 * 36 + 64 * 16
    assert blend_forward.ops(work) == 270_000
    assert blend_backward.nbytes(work) == 1000 * 72 + 64 * 16
    assert blend_backward.ops(work) == 620_000
    assert render.nbytes(work) == 1000 * 18 + 64 * 6
    assert render.ops(work) == 250_000
    assert peaks.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_s(0, 67e12) == pytest.approx(1.0)


def test_step_and_frame_include_their_kernels():
    work = {"slots": 3e6, "pixels": 1296 * 840, "passing": 1e9,
            "pairs": 3e6, "gaussians": 1_000_000, "param_floats": 59}
    adam = 7 * 59 * 4 * 1_000_000
    assert train_step.nbytes(work) > adam + blend_forward.nbytes(work) \
        + blend_backward.nbytes(work)
    assert train_step.ops(work) == blend_forward.ops(work) \
        + blend_backward.ops(work)
    assert view_frame.least_s(work) >= render.least_s(work)


def test_a_share_needs_device_time():
    assert peaks.share(1.0, 0.0) is None
    assert peaks.share(0.5, 1.0) == pytest.approx(50.0)


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "mcmc-1m.json")) as f:
        return json.load(f)


def test_state_draws_match_trained_stats_state():
    """The benchmark's draw of opacities and scales (no 3-NN) equals
    bench_torch.trained_stats_state's on the same draws, at a small P."""
    import bench_torch

    p, seed = 3000, 11
    state, _ = bench_torch.trained_stats_state(
        p, 3, np.random.default_rng(seed), "cpu")
    rng = np.random.default_rng(seed)
    rng.uniform(-1, 1, (p, 3))                     # positions
    rng.uniform(0, 1, (p, 3))                      # colours
    u_opa = rng.uniform(0, 1, p).astype(np.float32)
    u_tri = rng.uniform(0, 1, p).astype(np.float32)
    perm = rng.permuted(np.tile(np.arange(3), (p, 1)), axis=1)
    opa, logscale = inputs.stats_leaves(
        torch.as_tensor(u_opa), torch.as_tensor(u_tri),
        torch.as_tensor(perm), _config()["trained_stats"], p)
    assert torch.allclose(opa, state.opacity, rtol=1e-5, atol=1e-5)
    assert torch.allclose(logscale, state.scaling, rtol=1e-6, atol=1e-6)


def test_state_leaves_are_seeded_and_shaped():
    cfg = dict(_config(), gaussians=500)
    a = inputs.state_leaves(cfg, "cpu", 2**40 + 3)
    b = inputs.state_leaves(cfg, "cpu", 2**40 + 3)
    c = inputs.state_leaves(cfg, "cpu", 2**40 + 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["xyz"], c["xyz"])
    assert a["f_rest"].shape == (500, 15, 3) and a["opacity"].shape == (500,
                                                                       1)
    assert float(a["xyz"].abs().max()) <= 1.0


def test_cameras_match_the_ports():
    import bench_torch

    m = inputs.orbit_matrices(2 * math.pi / 4, 1296, 840, 6.0,
                              (0.0, 0.0, 4.0), 0.9)
    cam = bench_torch.orbit_cameras(4, 1296, 840, "cpu")[1]
    assert np.allclose(m["view"], cam.view.numpy(), atol=1e-6)
    assert np.allclose(m["full_proj"], cam.full_proj.numpy(), atol=1e-6)
    assert np.allclose(m["cam_pos"], cam.cam_pos.numpy(), atol=1e-5)
    assert m["tan_fovx"] == pytest.approx(float(cam.tan_fovx))
