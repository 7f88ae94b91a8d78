"""gsplat_tpu_torch evaluation path against the JAX package on the CPU:

- ``eval.render.render_sets`` on a copy of tests/fixtures/quality_blender
  with a seeded 512-row SH-3 model: each test view's render, captured
  before the 8-bit write, within 5e-5 of JAX's (the training rasterizer's
  forward; JAX's Pallas kernels in interpret mode), the GT PNGs identical
  byte for byte, and the render PNGs each the 8-bit write of its package's
  render: equal wherever the two renders round to the same level, one
  level apart only where renders within 5e-5 of each other fall on the
  two sides of a rounding boundary (4 of 12,288 values in view 0);
- the renderer's python SH / covariance switches against the fused path,
  within 1e-5;
- ``eval.metrics.evaluate_dir`` / ``evaluate`` on the same PNG pairs: SSIM
  and PSNR within 1e-5 of JAX's, the same JSON keys, the LPIPS-null and
  ``--require_lpips`` branches, and LPIPS with random-weight heads;
- ``eval.lpips.lpips_from_params`` against JAX with random weights for
  vgg, alex and squeeze at 65 x 67, within 1e-5 relative;
- ``eval.full_eval``: the same job list as JAX's for the same flags, every
  trainer flag accepted by the port's trainer;
- the entry points default to cuda and raise without a card, only
  ``--pshard`` / ``--tileshard`` above 1 raise NotImplementedError, and
  the new modules import with jax and gsplat_tpu blocked.
"""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import renderer as jrenderer
from gsplat_tpu.eval import full_eval as jfull
from gsplat_tpu.eval import lpips as jlpips
from gsplat_tpu.eval import metrics as jmetrics
from gsplat_tpu.eval import render as jrender
from gsplat_tpu.train import config as jconfig
from gsplat_tpu_torch import renderer as trenderer
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.data.scene import Scene
from gsplat_tpu_torch.eval import full_eval as tfull
from gsplat_tpu_torch.eval import lpips as tlpips
from gsplat_tpu_torch.eval import metrics as tmetrics
from gsplat_tpu_torch.eval import render as trender
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.train import config as tconfig
from gsplat_tpu_torch.train import train_static as ttrain
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "quality_blender")
CAP, ITERATION = 512, 7


def write_model(model_dir, seed=0, n=CAP):
    """A seeded SH-3 model in the scene's [-1, 1]^3 written as
    point_cloud/iteration_7/point_cloud.ply."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    tply.save_gaussian_ply(
        os.path.join(model_dir, "point_cloud", f"iteration_{ITERATION}",
                     "point_cloud.ply"),
        rng.uniform(-1, 1, (n, 3)).astype(f32),
        rng.normal(0, 1, (n, 1, 3)).astype(f32),
        (0.2 * rng.normal(size=(n, 15, 3))).astype(f32),
        rng.uniform(-1, 3, (n, 1)).astype(f32),
        rng.uniform(-3.5, -2.0, (n, 3)).astype(f32),
        rng.normal(size=(n, 4)).astype(f32))


def _cfg(module, dataset, model_dir, **extra):
    model = module.ModelConfig(source_path=dataset, model_path=model_dir,
                               white_background=True, cap_max=CAP, **extra)
    return model, module.PipelineConfig()


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """One dataset copy (the Blender reader writes nothing beside it: the
    fixture has its points3d.ply), one model directory per package with
    the same PLY, both packages' render_sets(skip_train) with their
    save_png recording the float renders before the 8-bit write."""
    root = tmp_path_factory.mktemp("eval")
    dataset = str(root / "dataset")
    shutil.copytree(FIXTURE, dataset)
    caps = {}
    for name, mod, cfgmod in (("jax", jrender, jconfig),
                              ("port", trender, tconfig)):
        model_dir = str(root / f"model_{name}")
        write_model(model_dir)
        got = caps[name] = []
        real = mod.save_png

        def record(path, img, real=real, got=got):
            if "renders" in path:
                got.append((os.path.basename(path), np.asarray(img)))
            real(path, img)

        mp = pytest.MonkeyPatch()
        mp.setattr(mod, "save_png", record)
        try:
            model_cfg, pipe = _cfg(cfgmod, dataset, model_dir)
            if name == "port":
                model_cfg.data_device = "cpu"
            mod.render_sets(model_cfg, pipe, iteration=-1, skip_train=True)
        finally:
            mp.undo()
    return root, dataset, caps


def _tree(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), path)] = \
                    fh.read()
    return out


def test_render_sets_match_jax(rendered):
    root, _, caps = rendered
    assert [n for n, _ in caps["jax"]] == [n for n, _ in caps["port"]] \
        == ["00000.png", "00001.png"]
    for (_, j), (_, t) in zip(caps["jax"], caps["port"]):
        assert j.shape == t.shape == (64, 64, 3)
        assert float(np.abs(j - t).max()) <= 5e-5
        assert 0.05 < float(t.mean()) < 0.99
    split = os.path.join("test", f"ours_{ITERATION}")
    jtree = _tree(os.path.join(root, "model_jax", split))
    ttree = _tree(os.path.join(root, "model_port", split))
    assert sorted(jtree) == sorted(ttree) == [
        "gt/00000.png", "gt/00001.png", "renders/00000.png",
        "renders/00001.png"]
    assert all(jtree[k] == ttree[k] for k in ttree if k.startswith("gt/"))
    for (name, j), (_, t) in zip(caps["jax"], caps["port"]):
        jpng = tmetrics.read_image(os.path.join(root, "model_jax", split,
                                                "renders", name))
        tpng = tmetrics.read_image(os.path.join(root, "model_port", split,
                                                "renders", name))
        level = lambda x: np.floor(np.clip(x, 0, 1) * 255 + 0.5)  # noqa
        assert np.array_equal(np.round(jpng * 255), level(j))
        assert np.array_equal(np.round(tpng * 255), level(t))
        flips = level(j) != level(t)
        assert float(np.abs(level(j) - level(t)).max()) <= 1
        assert int(flips.sum()) <= 8, int(flips.sum())
    assert not os.path.exists(os.path.join(root, "model_port", "train"))


@pytest.mark.parametrize("convert_shs,compute_cov", [(True, False),
                                                     (False, True),
                                                     (True, True)])
def test_renderer_switches_match_fused_path(rendered, convert_shs,
                                            compute_cov):
    root, dataset, _ = rendered
    scene = Scene(dataset, "", white_background=True, shuffle=False,
                  device="cpu")
    state = tgauss.load_ply(
        os.path.join(root, "model_port", "point_cloud",
                     f"iteration_{ITERATION}", "point_cloud.ply"),
        capacity=CAP, max_sh_degree=3, device="cpu")
    settings = ttrain.make_settings(tconfig.PipelineConfig(), CAP)
    cam, _ = scene.test_cameras[1].load()
    bg = torch.ones(3)
    with torch.no_grad():
        want = trenderer.render(cam, state, bg, settings)["render"]
        got = trenderer.render(cam, state, bg, settings,
                               convert_shs_python=convert_shs,
                               compute_cov3d_python=compute_cov)["render"]
    assert float((got - want).abs().max()) <= 1e-5
    assert float(want.mean()) > 0.05


def test_render_switches_match_jax_switches(rendered):
    """Both switches on, JAX's renderer vs the port's, one test view."""
    root, dataset, _ = rendered
    from gsplat_tpu.data.scene import Scene as JScene
    from gsplat_tpu.model import gaussians as jgauss
    from gsplat_tpu.train.train_static import make_settings as jsettings

    ply_path = os.path.join(root, "model_port", "point_cloud",
                            f"iteration_{ITERATION}", "point_cloud.ply")
    jcam, _ = JScene(dataset, "", white_background=True,
                     shuffle=False).test_cameras[0].load()
    jstate = jgauss.load_ply(ply_path, capacity=CAP, max_sh_degree=3)
    import jax

    jimg = jax.jit(lambda c: jrenderer.render(
        c, jstate, jnp.ones(3), jsettings(jconfig.PipelineConfig(), CAP),
        convert_shs_python=True, compute_cov3d_python=True)["render"])(jcam)
    tcam, _ = Scene(dataset, "", white_background=True, shuffle=False,
                    device="cpu").test_cameras[0].load()
    tstate = tgauss.load_ply(ply_path, capacity=CAP, max_sh_degree=3,
                             device="cpu")
    with torch.no_grad():
        timg = trenderer.render(
            tcam, tstate, torch.ones(3),
            ttrain.make_settings(tconfig.PipelineConfig(), CAP),
            convert_shs_python=True, compute_cov3d_python=True)["render"]
    assert float(np.abs(np.asarray(jimg) - timg.numpy()).max()) <= 5e-5


@pytest.fixture
def no_lpips_weights(monkeypatch, tmp_path):
    """Neither package finds LPIPS weights (an env path that does not
    exist, the caches cleared before and after)."""
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "none.npz"))
    for mod in (jlpips, tlpips):
        mod._load_weights.cache_clear()
    tlpips._device_weights.cache_clear()
    yield
    for mod in (jlpips, tlpips):
        mod._load_weights.cache_clear()
    tlpips._device_weights.cache_clear()


@pytest.fixture
def random_vgg_weights(monkeypatch, tmp_path):
    """A random-weight VGG npz (NOT LPIPS weights) both packages load."""
    path = tmp_path / "lpips_vgg_random.npz"
    np.savez(path, **tlpips.random_params("vgg", seed=3))
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(path))
    for mod in (jlpips, tlpips):
        mod._load_weights.cache_clear()
    tlpips._device_weights.cache_clear()
    yield
    for mod in (jlpips, tlpips):
        mod._load_weights.cache_clear()
    tlpips._device_weights.cache_clear()


def _method_dirs(root):
    d = os.path.join(root, "model_port", "test", f"ours_{ITERATION}")
    return os.path.join(d, "renders"), os.path.join(d, "gt")


def test_evaluate_dir_matches_jax(rendered, random_vgg_weights):
    renders, gt = _method_dirs(rendered[0])
    jn, js, jp, jl = jmetrics.evaluate_dir(renders, gt)
    tn, ts, tp, tl = tmetrics.evaluate_dir(renders, gt, device="cpu")
    assert jn == tn == ["00000.png", "00001.png"]
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    # against a direct computation on the same pairs
    for name, s, p in zip(tn, ts, tp):
        a = tmetrics.read_image(os.path.join(renders, name))
        b = tmetrics.read_image(os.path.join(gt, name))
        mse = np.mean((a.astype(np.float64) - b) ** 2)
        assert abs(p - 10 * np.log10(1 / mse)) <= 1e-4
        assert -1 <= s <= 1


def test_evaluate_writes_jax_schema_without_lpips(rendered, no_lpips_weights,
                                                  tmp_path):
    trees = {}
    for name, mod, kw in (("jax", jmetrics, {}),
                          ("port", tmetrics, {"device": "cpu"})):
        scene_dir = tmp_path / name
        shutil.copytree(os.path.join(rendered[0], "model_port", "test"),
                        scene_dir / "test")
        mod.evaluate([str(scene_dir)], **kw)
        trees[name] = [json.loads((scene_dir / f).read_text())
                       for f in ("results.json", "per_view.json")]
    (jres, jview), (tres, tview) = trees["jax"], trees["port"]
    method = f"ours_{ITERATION}"
    assert list(jres) == list(tres) == [method]
    assert list(jres[method]) == list(tres[method]) == [
        "SSIM", "PSNR", "LPIPS", "LPIPS_note"]
    assert tres[method]["LPIPS"] is None
    assert list(jview[method]) == list(tview[method])
    assert tview[method]["LPIPS"] is None
    for key in ("SSIM", "PSNR"):
        assert abs(jres[method][key] - tres[method][key]) <= 1e-5
        assert list(jview[method][key]) == list(tview[method][key])
    renders, gt = _method_dirs(rendered[0])
    with pytest.raises(SystemExit, match="require_lpips"):
        tmetrics.evaluate_dir(renders, gt, require_lpips=True, device="cpu")
    with pytest.raises(SystemExit, match="require_lpips"):
        tmetrics.main(["-m", str(tmp_path / "port"), "--require_lpips",
                       "--data_device", "cpu"])


def test_evaluate_with_weights_matches_jax(rendered, random_vgg_weights,
                                           tmp_path):
    out = {}
    for name, mod, kw in (("jax", jmetrics, {}),
                          ("port", tmetrics, {"device": "cpu"})):
        scene_dir = tmp_path / name
        shutil.copytree(os.path.join(rendered[0], "model_port", "test"),
                        scene_dir / "test")
        mod.evaluate([str(scene_dir)], **kw)
        out[name] = json.loads((scene_dir / "results.json").read_text())
    method = f"ours_{ITERATION}"
    j, t = out["jax"][method], out["port"][method]
    assert list(j) == list(t) == ["SSIM", "PSNR", "LPIPS"]
    assert abs(t["LPIPS"] - j["LPIPS"]) <= 1e-5 * abs(j["LPIPS"])


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_lpips_from_params_matches_jax(net):
    params = tlpips.random_params(net, seed=len(net))
    rng = np.random.default_rng(7)
    img1 = rng.uniform(0, 1, (65, 67, 3)).astype(np.float32)
    img2 = np.clip(img1 + 0.1 * rng.normal(size=img1.shape), 0, 1
                   ).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    import jax

    want = float(jax.jit(lambda a, b: jlpips.lpips_from_params(
        jp, a, b, net=net))(jnp.asarray(img1), jnp.asarray(img2)))
    got = tlpips.lpips_from_params(params, torch.from_numpy(img1),
                                   torch.from_numpy(img2), net=net)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)
    assert tlpips.NET_CHANNELS == jlpips.NET_CHANNELS


def test_lpips_refuses_weights_without_heads(tmp_path, monkeypatch):
    params = tlpips.random_params("alex", seed=0)
    path = tmp_path / "no_heads.npz"
    np.savez(path, **{k: v for k, v in params.items()
                      if not k.startswith("lin")})
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(path))
    tlpips._load_weights.cache_clear()
    try:
        with pytest.raises(tlpips.LPIPSUnavailable, match="linear heads"):
            tlpips.lpips(torch.zeros(32, 32, 3), torch.zeros(32, 32, 3),
                         net="alex")
    finally:
        tlpips._load_weights.cache_clear()


def _record_full_eval(pkg, monkeypatch, argv):
    """Run ``pkg``'s full_eval.main with its train, render and metrics
    entries replaced by recorders."""
    if pkg == "jax":
        import gsplat_tpu.train.train_static as train_mod
        mod, render_mod, metrics_mod = jfull, jrender, jmetrics
    else:
        train_mod = ttrain
        mod, render_mod, metrics_mod = tfull, trender, tmetrics
    calls = []
    if pkg == "port":  # the device is resolved, not used, by the job list
        monkeypatch.setattr(tfull, "get_device", torch.device)
    monkeypatch.setattr(train_mod, "main",
                        lambda a: calls.append(("train", list(a))))
    monkeypatch.setattr(render_mod, "main",
                        lambda a: calls.append(("render", list(a))))
    monkeypatch.setattr(metrics_mod, "evaluate",
                        lambda paths, **kw: calls.append(
                            ("metrics", list(paths),
                             kw["lpips_net"], kw["require_lpips"])))
    mod.main(argv)
    return calls


@pytest.mark.parametrize("flags", [
    ["-m360", "/d/360", "-tat", "/d/tat", "-db", "/d/db"],
    ["-db", "/d/db", "--cap_max", "500000", "--lpips_net", "alex",
     "--output_path", "/o", "--skip_metrics"],
])
def test_full_eval_jobs_match_jax(monkeypatch, flags):
    """The same calls in the same order, but for one repaired reference
    defect: JAX's Deep Blending render calls keep the value of the dropped
    --opacity_reg flag ("0.001"), which its own render parser refuses; the
    port's drop it. The port's trainer accepts every flag of the calls and
    refuses none as a later slice's, its renderer parses every call."""
    want = _record_full_eval("jax", monkeypatch, flags)
    got = _record_full_eval("port", monkeypatch, flags)
    assert len(got) == len(want)
    refused = []
    for g, w in zip(got, want):
        if g[0] == "render" and "/d/db" in g[1][1]:
            assert w[1] == g[1] + ["0.001"]
            refused.append(w[1])
        else:
            assert g == w
    assert len(refused) == 4
    assert len([c for c in got if c[0] == "train"]) == (
        13 if "-m360" in flags else 2)
    monkeypatch.undo()
    for argv in refused:
        with pytest.raises(SystemExit):
            jrender.main(argv)
    seen = []
    monkeypatch.setattr(ttrain, "training",
                        lambda m, o, p, args: seen.append(args))
    monkeypatch.setattr(trender, "render_sets",
                        lambda *a, **kw: seen.append(kw))
    for kind, argv, *_ in got:
        if kind == "train":
            ttrain.main(argv)
            a = seen[-1]
            # full_eval's train jobs run on one device from scratch
            assert (a.data_parallel, a.pshard, a.replay_rng,
                    a.start_checkpoint, a.profile_iterations,
                    a.checkpoint_iterations) == (1, 1, None, None, None, [])
        elif kind == "render":
            trender.main(argv)


def test_full_eval_passes_cpu_device(monkeypatch):
    calls = _record_full_eval("port", monkeypatch,
                              ["-tat", "/d/tat", "--data_device", "cpu",
                               "--skip_metrics"])
    assert all(a[-2:] == ["--data_device", "cpu"] for _, a in calls)


def test_eval_entries_need_a_card_unless_told(rendered, tmp_path):
    root, dataset, _ = rendered
    model = os.path.join(root, "model_port")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.main(["-s", dataset, "-m", model, "--cap_max", str(CAP)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tmetrics.main(["-m", model])
    with pytest.raises(RuntimeError, match="CUDA"):
        tfull.main(["-tat", str(tmp_path)])
    for flag in ("--pshard", "--tileshard"):
        with pytest.raises(RuntimeError, match="CUDA"):
            trender.main(["-s", dataset, "-m", model, "--cap_max", str(CAP),
                          flag, "2"])
    assert tconfig.ModelConfig().data_device == "cuda"


def test_eval_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'gsplat_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import gsplat_tpu_torch.eval.render\n"
            "import gsplat_tpu_torch.eval.metrics\n"
            "import gsplat_tpu_torch.eval.lpips\n"
            "import gsplat_tpu_torch.eval.full_eval\n"
            "import gsplat_tpu_torch.data.readers\n"
            "import gsplat_tpu_torch.data.convert\n"
            "import gsplat_tpu_torch.renderer\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
