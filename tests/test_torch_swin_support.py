"""gsplat_tpu_torch SwinGS slice, the parts around the model, against the
JAX package on the CPU (the model and the steps are in
tests/test_torch_swin.py):

- ``rotvec_to_quat`` / ``rotvec_to_rotmat`` and ``rigid_deform``: values
  rtol 1e-5, gradients rtol 1e-4, finite at rotvec 1e-10 (the small-angle
  branch every new row takes);
- ``stream_dump``: the bytes of the JAX writer's;
- ``SliWinManager``: the same windows and draws under one seed;
- ``read_dynamic_scene`` and ``DynamicScene`` on a copy of the dynamic
  fixture (the readers write PLYs beside it): the same points, cameras,
  images and cameras.json, the LRU bound;
- ``multi_cummax``'s plain version vs JAX ``multi_cummax`` in interpret
  mode (3 arrays, K = 5,000), exact;
- the trainer CLI then stream playback on a tiny synthetic dataset; the
  trainer with --data_parallel 2 (two CPU ranks), --enable_arap,
  --start_checkpoint and --checkpoint_iterations; and the port's training, checkpoint, profiling and parallel
  modules importing with jax and gsplat_tpu blocked.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.core import quaternion as jquat
from gsplat_tpu.data import readers as jreaders
from gsplat_tpu.raster import scan_kernel as jscan
from gsplat_tpu.utils import stream as jstream
from gsplat_tpu_torch.core import quaternion as tquat
from gsplat_tpu_torch.data import readers as treaders
from gsplat_tpu_torch.data.scene import DynamicScene
from gsplat_tpu_torch.model import swin as tswin
from gsplat_tpu_torch.raster import scan_kernel as tscan
from gsplat_tpu_torch.utils import stream as tstream
from tests.test_torch_swin import state_pair
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DYN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "quality_cudaport_dyn")
T = torch.from_numpy


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# ----------------------------------------------------- rotation vectors ----

@pytest.mark.parametrize("scale", [0.7, 1e-10])
def test_rotvec_helpers_match_jax(scale):
    """Values and the gradient of a random projection of each output; at
    1e-10 every row takes the small-angle branch."""
    rng = np.random.default_rng(1)
    v = (scale * rng.normal(size=(32, 3))).astype(np.float32)
    for tf, jf in ((tquat.rotvec_to_quat, jquat.rotvec_to_quat),
                   (tquat.rotvec_to_rotmat, jquat.rotvec_to_rotmat)):
        w = rng.normal(size=np.asarray(jf(v)).shape).astype(np.float32)
        tv = T(v).requires_grad_(True)
        out = tf(tv)
        (out * T(w)).sum().backward()
        jgrad = jax.jit(jax.grad(lambda a: jnp.sum(jf(a) * w)))(
            jnp.asarray(v))
        np.testing.assert_allclose(_np(out), np.asarray(jf(v)), rtol=1e-5,
                                   atol=1e-7)
        assert np.isfinite(tv.grad.numpy()).all()
        np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgrad),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["screw", "linear", "skip"])
def test_rigid_deform_matches_jax(mode):
    rng = np.random.default_rng(2)
    n = 40
    args = [rng.normal(size=(n, 3)), rng.normal(size=(n, 4)),
            0.05 * rng.normal(size=(n, 3)), 0.3 * rng.normal(size=(n, 3)),
            rng.normal(size=(n, 3)), rng.integers(0, 5, n)]
    args[3][:8] = [1e-10, 0.0, 0.0]
    args = [a.astype(np.float32) for a in args]
    wx, wr = (rng.normal(size=(n, k)).astype(np.float32) for k in (3, 4))

    def jloss(*a):
        x, r = jquat.rigid_deform(*a, mode=mode)
        return jnp.sum(x * wx) + jnp.sum(r * wr), (x, r)

    (_, (jx, jr)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *map(jnp.asarray, args))
    leaves = [T(a).requires_grad_(i < 5) for i, a in enumerate(args)]
    x, r = tquat.rigid_deform(*leaves, mode=mode)
    np.testing.assert_allclose(_np(x), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(r), np.asarray(jr), rtol=1e-5, atol=1e-6)
    if mode == "skip":
        return
    loss = (x * T(wx)).sum() + (r * T(wr)).sum()
    grads = torch.autograd.grad(loss, leaves[:5], allow_unused=True)
    for i, (g, want) in enumerate(zip(grads, jg)):
        got = np.zeros_like(args[i]) if g is None else g.numpy()
        assert np.isfinite(got).all(), i
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-6, err_msg=str(i))


# --------------------------------------------------- stream, window, data ----

def test_stream_dump_bytes_match_jax(tmp_path):
    ts, js = state_pair(seed=16)
    mask = np.zeros(48, bool)
    mask[[0, 3, 9, 20, 33]] = True
    rows = tswin.extract_rows_host(ts, T(mask))
    for side, mod in (("t", tstream), ("j", jstream)):
        d = tmp_path / side
        for sh in (1, 0):
            r = dict(rows)
            if sh == 0:
                r["f_rest"] = r["f_rest"][:, :0]
            mod.stream_dump(r, str(d / f"sh{sh}" / "streamable.dat"), sh)
            mod.stream_dump(r, str(d / f"sh{sh}" / "streamable.dat"), sh)
    for sh in (1, 0):
        for name in ("streamable.dat", "format.json"):
            a = (tmp_path / "t" / f"sh{sh}" / name).read_bytes()
            b = (tmp_path / "j" / f"sh{sh}" / name).read_bytes()
            assert a == b and len(a) > 0, (sh, name)
        back = tstream.stream_load(str(tmp_path / "t" / f"sh{sh}" /
                                       "format.json"),
                                   str(tmp_path / "t" / f"sh{sh}" /
                                       "streamable.dat"))
        np.testing.assert_array_equal(back["xyz"][:5], rows["xyz"])


def test_sliwin_manager_matches_jax():
    import random

    seqs = []
    for mod in (tstream, jstream):
        random.seed(3)
        mgr = mod.SliWinManager(5, 12, max_sample=3)
        seq = []
        while mgr.frame_end <= mgr.max_frame + 2:
            seq.append((str(mgr), list(mgr.all_frames()),
                        list(mgr.sampled_frames()),
                        mgr.sampled_frames_biased(), mgr.state_dump()))
            mgr.tick()
        seqs.append(seq)
    assert seqs[0] == seqs[1] and len(seqs[0]) == 10


def test_render_stream_frame_renders_the_active_rows(tmp_path):
    """Playback of a stream written from a state's rows equals the union
    render of that state (no ring, no deformation) at each frame, byte
    for byte."""
    from gsplat_tpu_torch.core.camera import make_camera
    from gsplat_tpu_torch.eval.render_stream import (load_stream_state,
                                                     render_stream_frame)
    from gsplat_tpu_torch.raster.rasterize import render_frame

    ts, _ = state_pair(seed=18, m_count=0, deform=False)
    rows = tswin.extract_rows_host(ts, ts.im.alive_mask)
    tstream.stream_dump(rows, str(tmp_path / "streamable.dat"), 1)
    data = load_stream_state(str(tmp_path), "cpu")
    cam = make_camera(np.eye(3), np.zeros(3), 0.9, 0.7, 64, 48,
                      device="cpu")
    k_dup = 1 << 13
    bg = torch.zeros(3)
    for frame in (0.0, 1.0, 3.0):
        got = render_stream_frame(data, cam, frame, bg, k_dup)
        kw = tswin.union_params_at(ts, frame)
        want, _ = render_frame(kw["means3d"], kw["scales"], kw["quats"],
                               kw["opacities"], kw["shs"], cam, 1, bg, k_dup,
                               alive=kw["alive"])
        assert got.dtype == torch.uint8 and got.shape == (48, 64, 3)
        assert int(want.max()) > 0.05 * 255
        assert torch.equal(got, want)


@pytest.fixture
def dyn_copy(tmp_path):
    """A copy of the dynamic fixture (the readers write PLYs beside it)."""
    dst = tmp_path / "dyn"
    shutil.copytree(DYN_FIXTURE, dst)
    return str(dst)


@pytest.mark.parametrize("init_type,min_frame", [("sfm", 0), ("sfm", 1),
                                                 ("random", 0)])
def test_read_dynamic_scene_matches_jax(dyn_copy, init_type, min_frame):
    kw = dict(init_type=init_type, num_pts=50, max_frame=4,
              min_frame=min_frame)
    np.random.seed(0)
    t = treaders.read_dynamic_scene(dyn_copy, **kw)
    np.random.seed(0)
    j = jreaders.read_dynamic_scene(dyn_copy, **kw)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.radius == j.radius
    np.testing.assert_array_equal(t.translate, j.translate)
    assert len(t.train_cam_at) == 4 - min_frame
    for tl, jl in ((t.train_cam_at, j.train_cam_at),
                   (t.test_cam_at, j.test_cam_at)):
        for tf, jf in zip(tl, jl):
            assert len(tf) == len(jf) > 0
            for a, b in zip(tf, jf):
                assert (a.uid, a.frame, a.image_name, a.image_path,
                        a.width, a.height, a.fovx, a.fovy, a.extra_para) == (
                    b.uid, b.frame, b.image_name, b.image_path, b.width,
                    b.height, b.fovx, b.fovy, b.extra_para)
                np.testing.assert_array_equal(a.R, b.R)
                np.testing.assert_array_equal(a.T, b.T)
    assert t.train_cam_at[0][0].frame == 0
    assert f"/{min_frame}/" in t.train_cam_at[0][0].image_path


def test_dynamic_scene_lru_and_cameras_match_jax(dyn_copy, tmp_path):
    from gsplat_tpu.data.scene import DynamicScene as JDynamicScene

    scene = DynamicScene(dyn_copy, str(tmp_path / "out"), init_type="sfm",
                         max_frame=4, max_in_memory=2, shuffle=False,
                         device="cpu")
    jscene = JDynamicScene(dyn_copy, str(tmp_path / "jout"), init_type="sfm",
                           max_frame=4, max_in_memory=2, shuffle=False)
    assert scene.num_frames == 4 and scene.cameras_extent == \
        jscene.cameras_extent
    assert (tmp_path / "out" / "cameras.json").read_text() == \
        (tmp_path / "jout" / "cameras.json").read_text()
    scene.prefetch_train_frames([0, 1, 9])
    cams = scene.get_train_cams_at([0, 1])
    assert all(c.loaded for c in cams) and len(cams) == 14
    scene.get_train_cams_at([2])                   # evicts frame 0
    assert not scene.train_cam_at[0][0].loaded
    assert scene.train_cam_at[1][0].loaded
    (tc, timg), (jc, jimg) = (scene.get_test_cams_at([3])[0].load(),
                              jscene.get_test_cams_at([3])[0].load())
    np.testing.assert_array_equal(timg, jimg)
    np.testing.assert_allclose(tc.full_proj.numpy(), np.asarray(jc.full_proj),
                               rtol=1e-6, atol=1e-6)
    scene.unload_all()
    scene.unload_all_test()
    assert not any(c.loaded for cs in scene.train_cam_at for c in cs)
    scene.close()


# --------------------------------------------------------- multi_cummax ----

def test_multi_cummax_plain_matches_jax():
    rng = np.random.default_rng(17)
    arrays = [rng.integers(-1000, 1000, 5000).astype(np.int32)
              for _ in range(3)]
    arrays[1][:7] = np.iinfo(np.int32).min
    arrays[2] = np.sort(arrays[2])[::-1].copy()
    want = jscan.multi_cummax([jnp.asarray(a) for a in arrays],
                              interpret=True)
    got = tscan.multi_cummax(T(np.stack(arrays)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------- CLI and isolation ----

def test_train_swin_cli_then_render_stream(tmp_path, monkeypatch):
    """A tiny sliding-window run on a synthetic dataset (genesis, two
    ticks, a densification in each window), then playback of the stream."""
    from PIL import Image

    from gsplat_tpu_torch.eval.render_stream import main as stream_main
    from gsplat_tpu_torch.train.train_swin import main as swin_main
    from tests.test_data import _make_swings_fixture

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _make_swings_fixture(tmp_path, n_cams=3, n_frames=4)
    out = str(tmp_path / "model")
    state = swin_main([
        "-s", str(tmp_path), "-m", out, "--iterations", "8",
        "--cap_max", "48", "--init_pts", "24", "--max_frame", "4",
        "--swin_size", "2", "--deform", "--densify_from_iter", "2",
        "--densify_until_iter", "7", "--densification_interval", "3",
        "--test_iterations", "6", "--save_iterations", "-1",
        "--dup_budget", "4096", "--data_device", "cpu"])
    assert state.im.n_alive > 24                    # genesis grew
    for name in ("streamable.dat", "format.json", "psnr.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    data = tstream.stream_load(os.path.join(out, "format.json"),
                               os.path.join(out, "streamable.dat"))
    assert data["xyz"].shape[0] >= state.im.n_alive  # everything matured
    assert np.isfinite(data["xyz"]).all()
    assert data["start_frame"].min() == 0 and data["end_frame"].max() <= 6
    stream_main(["-m", out, "-s", str(tmp_path), "--max_frame", "4",
                 "--frames", "0", "2", "--dup_budget", "2048",
                 "--data_device", "cpu"])
    renders = os.path.join(out, "test", "stream", "renders")
    assert len(os.listdir(renders)) == 2            # 1 test cam x 2 frames
    img = np.asarray(Image.open(os.path.join(renders,
                                             sorted(os.listdir(renders))[0])))
    assert img.shape == (12, 16, 3)


@pytest.mark.parametrize("flag", [["--data_parallel", "2"],
                                  ["--enable_arap"],
                                  ["--start_checkpoint", "x.npz"],
                                  ["--checkpoint_iterations", "2"]])
def test_train_swin_refuses_later_slice_options(tmp_path, monkeypatch,
                                                flag):
    """The options this test once saw refused now run, each writing the
    stream: two CPU ranks (--data_parallel 2), ARAP, resuming from a
    checkpoint written by a first run, and writing the window
    checkpoints. The name is kept so that the cases go on counting as
    the same tests."""
    from gsplat_tpu_torch.train.train_swin import main as swin_main
    from gsplat_tpu_torch.utils import checkpoint as tckpt
    from tests.test_data import _make_swings_fixture

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    _make_swings_fixture(tmp_path, n_cams=3, n_frames=2)
    out = str(tmp_path / "m")
    # one window of 4 iterations, a densification at 2
    base = ["-s", str(tmp_path), "-m", out, "--iterations", "4",
            "--cap_max", "48", "--init_pts", "24", "--max_frame", "2",
            "--swin_size", "2", "--deform", "--densify_from_iter", "1",
            "--densify_until_iter", "4", "--densification_interval", "2",
            "--test_iterations", "-1", "--save_iterations", "-1",
            "--dup_budget", "4096", "--data_device", "cpu"]
    if flag[0] == "--start_checkpoint":
        swin_main(base + ["--checkpoint_iterations", "2"])
        flag = [flag[0], os.path.join(out, "chkpnt_0_2.npz")]
        out = str(tmp_path / "resumed")
        base[3] = out
    state = swin_main(base + flag)
    assert torch.isfinite(state.im.xyz).all() and state.im.n_alive > 0
    data = tstream.stream_load(os.path.join(out, "format.json"),
                               os.path.join(out, "streamable.dat"))
    assert data["xyz"].shape[0] > 0 and np.isfinite(data["xyz"]).all()
    if flag[0] == "--checkpoint_iterations":
        from gsplat_tpu_torch.model import optim as toptim

        tree, meta = tckpt.load_pytree(
            os.path.join(out, "chkpnt_0_2.npz"),
            {"state": state, "adam": toptim.init(state.params())})
        assert meta["iteration"] == 2 and meta["swin"]
        assert tree["state"].capacity == 48


def test_swin_modules_import_with_jax_blocked():
    """The SwinGS slice, chip_smoke and bench_torch import with jax,
    gsplat_tpu and the JAX entry scripts made unimportable."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'gsplat_tpu', 'bench',\n"
            "          '__graft_entry__'):\n"
            "    sys.modules[m] = None\n"
            "import gsplat_tpu_torch.train.train_swin\n"
            "import gsplat_tpu_torch.train.train_static\n"
            "import gsplat_tpu_torch.train.replay\n"
            "import gsplat_tpu_torch.utils.checkpoint\n"
            "import gsplat_tpu_torch.utils.profiling\n"
            "import gsplat_tpu_torch.parallel.launch\n"
            "import gsplat_tpu_torch.parallel.dp\n"
            "import gsplat_tpu_torch.parallel.swin_dp\n"
            "import gsplat_tpu_torch.parallel.pshard\n"
            "import gsplat_tpu_torch.parallel.tileshard\n"
            "import gsplat_tpu_torch.eval.render_stream\n"
            "import gsplat_tpu_torch.model.swin\n"
            "import gsplat_tpu_torch.renderer\n"
            "import chip_smoke\n"
            "import bench_torch\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
