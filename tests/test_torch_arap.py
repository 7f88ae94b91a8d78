"""SwinGS's ARAP regulariser in gsplat_tpu_torch against the JAX package
on the CPU.

- ``knn.knn_indices`` vs JAX's: the same neighbour set per row (distinct
  random points; the order within a row is ascending distance in both),
  squared distances within 1e-5 relative (both expand |a - b|^2 in
  float32);
- ``losses.arap_loss`` (over ``build_neighbor``'s graph) vs JAX's: value
  within 1e-5, gradient within 1e-4 (relative to each leaf's max);
- one fused swin step with ``arap_weights`` (the trainer's
  --enable_arap: 0.1 per field, the k = 20 graph of the immature rows)
  vs JAX's, noise off: loss rel <= 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu.model import knn as jknn
from gsplat_tpu.model import optim as joptim
from gsplat_tpu.model import swin as jswin
from gsplat_tpu.raster.rasterize import RasterizeSettings as JSettings
from gsplat_tpu.train import losses as jlosses
from gsplat_tpu.train import swin_step as jsstep
from gsplat_tpu.train.config import OptimizationConfig as JOpt
from gsplat_tpu_torch.model import knn as tknn
from gsplat_tpu_torch.model import optim as toptim
from gsplat_tpu_torch.model import swin as tswin
from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
from gsplat_tpu_torch.train import losses as tlosses
from gsplat_tpu_torch.train import swin_step as tsstep
from gsplat_tpu_torch.train.config import OptimizationConfig
from tests.test_torch_core import jax_state
from tests.test_torch_parallel import cam_spec, jcam, tcam
from tests.test_torch_swin import SWIN_FIELDS, swin_leaves

T = torch.from_numpy
ARAP_W = (0.1, 0.1, 0.1)


def test_knn_indices_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    td, ti = tknn.knn_indices(T(pts), k=20, block=256)
    jd, ji = jax.jit(lambda p: jknn.knn_indices(p, k=20, block=256))(
        jnp.asarray(pts))
    ti, ji = ti.numpy(), np.asarray(ji)
    assert ti.shape == (700, 20)
    assert all(set(a) == set(b) for a, b in zip(ti, ji))
    assert not (ti == np.arange(700)[:, None]).any()        # self excluded
    # |a|^2 + |b|^2 - 2 a.b in float32 on both sides
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_arap_loss_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    n = 300
    xyz = (0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    paras = [(0.1 * rng.normal(size=(n, 3))).astype(np.float32)
             for _ in range(3)]
    graph = tlosses.build_neighbor(T(xyz), num_knn=8)
    idx = graph["indices"]
    tp = [T(p).requires_grad_(True) for p in paras]
    tpen = tlosses.arap_loss(T(xyz), tp, idx)
    (tpen * torch.tensor([1.0, 2.0, 3.0])).sum().backward()

    def jfn(ps):
        pens = jlosses.arap_loss(jnp.asarray(xyz), ps,
                                 jnp.asarray(idx.numpy()))
        return jnp.sum(pens * jnp.asarray([1.0, 2.0, 3.0])), pens

    (_, jpen), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        [jnp.asarray(p) for p in paras])
    np.testing.assert_allclose(tpen.detach().numpy(), np.asarray(jpen),
                               rtol=1e-5)
    for t, j in zip(tp, jg):
        j = np.asarray(j)
        assert np.abs(t.grad.numpy() - j).max() <= 1e-4 * np.abs(j).max()
    np.testing.assert_allclose(graph["weight"].numpy(),
                               np.exp(-2000.0 * graph["dist"].numpy()),
                               rtol=1e-6)


def clustered_pair(n=40, seed=9):
    """The same SwinState in both packages, its immature rows in a tight
    cluster at the origin so that the ARAP weights exp(-2000 d^2) are not
    all 0."""
    lv = swin_leaves(seed=seed, cap=48, buf=32, n=n, m_count=20,
                     lifespan=4)
    lv["xyz"][:n] = 0.01 * np.random.default_rng(seed).normal(size=(n, 3))
    js = jswin.SwinState(im=jax_state(lv, n, 1),
                         **{k: jnp.asarray(lv[k]) for k in SWIN_FIELDS},
                         m_count=jnp.asarray(20, jnp.int32), max_lifespan=4,
                         deform=True)
    ts = tswin.swin_state_from_numpy(lv, n, 20, 1, 4, True, device="cpu")
    return ts, js


def test_swin_step_with_arap_matches_jax():
    ts, js = clustered_pair()
    spec = cam_spec(1, 4, w=32, h=32)
    gt = np.random.default_rng(2).uniform(0, 1, (3, 32, 32)).astype(
        np.float32)
    nbr = tknn.knn_indices(ts.im.xyz, k=20)[1]
    tstep = tsstep.make_swin_train_step(
        OptimizationConfig(noise_lr=0.0),
        RasterizeSettings(k_dup=4096, tile_x=16, tile_y=16, chunk=128), 1.0,
        arap_weights=ARAP_W)
    _, _, tm = tstep(ts, toptim.init(ts.params()), None, tcam(spec), T(gt),
                     torch.zeros(3), 1.0, 1.0, 1, nbr_indices=nbr)
    _, _, tm0 = tstep(ts, toptim.init(ts.params()), None, tcam(spec), T(gt),
                      torch.zeros(3), 1.0, 1.0, 1)
    jstep = jsstep.make_swin_train_step(
        JOpt(noise_lr=0.0),
        JSettings(k_dup=4096, tile_x=16, tile_y=16, chunk=128,
                  super_chunks=1, interpret=True), 1.0,
        arap_weights=ARAP_W)
    _, _, jm = jstep(js, joptim.init(js.params()), jax.random.PRNGKey(0),
                     jcam(spec), jnp.asarray(gt), jnp.zeros(3),
                     jnp.asarray(1.0), jnp.asarray(1.0), 1,
                     nbr_indices=jnp.asarray(nbr.numpy()))
    assert abs(float(tm.loss) - float(jm.loss)) <= 1e-5 * abs(float(jm.loss))
    assert float(tm.loss) > float(tm0.loss)          # the term is there
