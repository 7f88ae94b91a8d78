"""gsplat_tpu_torch binning and owner-expansion kernels against JAX.

- ``expand_scan`` / ``merge_expand``: the plain PyTorch versions (what a
  CPU tensor runs) are bit-equal to the JAX Pallas kernels in interpret
  mode on live slots, over the cases of tests/test_raster.py plus
  multi-block (K > 4096) cases.
- ``bin_gaussians`` fed the SAME ``Preprocessed`` (JAX's, as numpy), with
  ``train_binning`` after it, is bit-equal to JAX in every integer output
  both compute, on both expansion branches.

The CUDA kernels are held against these plain versions in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.raster import binning as jbinning
from gsplat_tpu.raster import project as jproject
from gsplat_tpu.raster import scan_kernel as jscan
from gsplat_tpu.raster.rasterize import _feat_columns as j_feat_columns
from gsplat_tpu_torch.raster import binning as tbinning
from gsplat_tpu_torch.raster import project as tproject
from gsplat_tpu_torch.raster import rasterize as trasterize
from gsplat_tpu_torch.raster import scan_kernel as tscan
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import (MERGE_CASES, expand_case, make_params,
                                      merge_case)
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", [700, 3 * 4096 + 511, 5 * 4096])
def test_expand_scan_plain_matches_jax(k):
    marks, base_in = expand_case(k, seed=k)
    want = jscan.expand_scan(jnp.asarray(marks), jnp.asarray(base_in),
                             interpret=True)
    got = tscan.expand_scan(torch.from_numpy(marks),
                            torch.from_numpy(base_in))
    for name, g, w in zip(("pack", "base", "rank"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("p_act,p_total,k", MERGE_CASES)
def test_merge_expand_plain_matches_jax(p_act, p_total, k):
    starts, pack, num_dup = merge_case(p_act, p_total)
    want = jscan.merge_expand(jnp.asarray(starts), jnp.asarray(pack), k,
                              interpret=True)
    got = tscan.merge_expand(torch.from_numpy(starts),
                             torch.from_numpy(pack), k)
    live = np.arange(k) < min(num_dup, k)
    for name, g, w in zip(("pack", "base", "rank"), got, want):
        np.testing.assert_array_equal(g.numpy()[live], np.asarray(w)[live],
                                      err_msg=name)


CAP = 1000


def jax_preprocessed(width, height, seed=0):
    """JAX preprocess of a random scene; CAP rows, 300 alive."""
    par = make_params(cap=CAP, seed=seed)
    js = jax_state(par, 300, 1)
    cam = jcamera.make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, width,
                              height)
    return jproject.preprocess(js.xyz, js.get_scaling(), js.get_rotation(),
                               js.get_opacity()[:, 0], js.get_features(),
                               cam, 1, alive=js.alive_mask)


def to_torch_proc(jp):
    return tproject.Preprocessed(*(torch.from_numpy(np.array(v))
                                   for v in jp))


# (tile_x, tile_y, width, height, k_dup): 2 k >= 7 P (P = CAP) takes the
# scatter-max + expand_scan branch, 2 k < 7 P the merge_expand branch;
# the last case overflows the budget (num_dup > k_dup)
BIN_CASES = {
    "expand_16x16": (16, 16, 128, 96, 4096),
    "merge_16x16": (16, 16, 128, 96, 2048),
    "expand_128x32": (128, 32, 256, 96, 3584),
    "merge_128x32_overflow": (128, 32, 256, 96, 384),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_gaussians_matches_jax(case):
    tile_x, tile_y, width, height, k_dup = BIN_CASES[case]
    grid_x, grid_y = -(-width // tile_x), -(-height // tile_y)
    jp = jax_preprocessed(width, height)
    kw = dict(tile_x=tile_x, tile_y=tile_y, grid_x=grid_x, grid_y=grid_y,
              k_dup=k_dup, chunk=128, align=8)
    jb = jbinning.bin_gaussians(jp, interpret=True,
                                feat_table=j_feat_columns(jp), **kw)
    tp = to_torch_proc(jp)
    tb = tbinning.bin_gaussians(tp, feat_table=trasterize._feat_columns(tp),
                                **kw)
    tt = tbinning.train_binning(tp, tb)
    num_dup = int(jb.num_dup)
    assert ("merge" in case) == (2 * k_dup < 7 * CAP)
    assert ("overflow" in case) == (num_dup > k_dup)
    assert num_dup > 0
    for got, names in ((tb, ("gid", "chunk_meta", "tile_len", "num_dup")),
                       (tt, ("radius", "used", "seg_bounds"))):
        for name in names:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
    n_fit = int(tt.used.sum())
    assert n_fit > 0
    np.testing.assert_array_equal(tb.order.numpy()[:n_fit],
                                  np.asarray(jb.order)[:n_fit])
    np.testing.assert_array_equal(tb.feat_table.numpy()[:n_fit],
                                  np.asarray(jb.feat_table)[:n_fit])
    n_slots = jbinning.num_slots(k_dup, grid_x * grid_y, 128)
    assert tbinning.num_slots(k_dup, grid_x * grid_y, 128) == n_slots
    assert tb.gid.shape[0] == -(-n_slots // (128 * 8)) * 128 * 8
