"""gsplat_tpu_torch's COLMAP and Google Immersive readers and its convert
wrapper, against the JAX package on the CPU:

- ``read_colmap_scene`` and ``Scene`` on tests/test_data.py's synthetic
  COLMAP scene (binary and text models, sfm and random init, nine images
  so that llffhold 8 holds out two): the same cameras, split, points,
  colours, normalisation, points3D.ply bytes, cameras.json and loaded
  images as JAX's;
- ``read_google_immersive_scene`` on a synthetic cam.json (sfm.bin and
  random init), against JAX's;
- the binary images and points readers against JAX's, bit-equal, on
  records with tracks and 2D points; a file cut inside its count, an
  image name, an image's 2D points or a point's record raises ValueError
  naming the file;
- ``data.convert`` refusing to run without the ``colmap`` binary.
"""

import json
import os
import shutil
import struct

import numpy as np
import pytest

from gsplat_tpu.data import colmap as jcolmap
from gsplat_tpu.data import convert as jconvert
from gsplat_tpu.data import readers as jreaders
from gsplat_tpu.data.scene import Scene as JScene
from gsplat_tpu_torch.data import colmap as tcolmap
from gsplat_tpu_torch.data import convert as tconvert
from gsplat_tpu_torch.data import readers as treaders
from gsplat_tpu_torch.data.scene import Scene as TScene


def _write_png(path, h=12, w=16, seed=0):
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 255, size=(h, w, 3))
    Image.fromarray(arr.astype(np.uint8), "RGB").save(path)


def make_colmap_scene(root, text=False, n_images=9):
    """tests/test_data.py's synthetic scene (one PINHOLE camera, images
    along +z, 9 sfm points) with more images and turned cameras; binary
    or text model."""
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    os.makedirs(root / "images")
    rng = np.random.default_rng(0)
    params = np.array([20.0, 21.0, 8.0, 6.0])
    imgs = {}
    for i in range(n_images):
        q = rng.normal(size=4)
        q = q / np.linalg.norm(q)
        imgs[i + 1] = tcolmap.ColmapImage(i + 1, q, rng.normal(size=3)
                                          + [0.0, 0.0, 3.0 + i], 1,
                                          f"im_{(7 * i) % n_images}.png")
        _write_png(root / "images" / f"im_{(7 * i) % n_images}.png", seed=i)
    xyz = rng.normal(size=(9, 3))
    rgb = rng.integers(0, 256, size=(9, 3)).astype(np.uint8)
    if not text:
        cams = {1: tcolmap.ColmapCamera(1, "PINHOLE", 16, 12, params)}
        tcolmap.write_cameras_binary(str(sparse / "cameras.bin"), cams)
        tcolmap.write_images_binary(str(sparse / "images.bin"), imgs)
        tcolmap.write_points3d_binary(str(sparse / "points3D.bin"), xyz, rgb)
        return
    with open(sparse / "cameras.txt", "w") as f:
        f.write("# camera list\n1 PINHOLE 16 12 "
                + " ".join(repr(float(p)) for p in params) + "\n")
    with open(sparse / "images.txt", "w") as f:
        f.write("# image list\n")
        for im in imgs.values():
            f.write(" ".join([str(im.id)]
                             + [repr(float(v)) for v in im.qvec]
                             + [repr(float(v)) for v in im.tvec]
                             + [str(im.camera_id), im.name]) + "\n")
            f.write("1.0 2.0 -1\n")
    with open(sparse / "points3D.txt", "w") as f:
        f.write("# points\n")
        for i in range(9):
            f.write(" ".join([str(i + 1)]
                             + [repr(float(v)) for v in xyz[i]]
                             + [str(int(v)) for v in rgb[i]]
                             + ["0.5", "1", "0"]) + "\n")


def _same_cameras(jcams, tcams, root_j, root_t):
    assert len(jcams) == len(tcams)
    for j, t in zip(jcams, tcams):
        for field in ("uid", "fovx", "fovy", "image_name", "width", "height",
                      "frame", "extra_para"):
            assert getattr(j, field) == getattr(t, field), field
        np.testing.assert_array_equal(j.R, t.R)
        np.testing.assert_array_equal(j.T, t.T)
        assert (os.path.relpath(j.image_path, root_j)
                == os.path.relpath(t.image_path, root_t))


def _same_info(jinfo, tinfo, root_j, root_t):
    _same_cameras(jinfo.train_cameras, tinfo.train_cameras, root_j, root_t)
    _same_cameras(jinfo.test_cameras, tinfo.test_cameras, root_j, root_t)
    np.testing.assert_array_equal(jinfo.points, tinfo.points)
    np.testing.assert_array_equal(jinfo.colors, tinfo.colors)
    np.testing.assert_array_equal(jinfo.translate, tinfo.translate)
    assert jinfo.radius == tinfo.radius
    assert (os.path.relpath(jinfo.ply_path, root_j)
            == os.path.relpath(tinfo.ply_path, root_t))
    with open(jinfo.ply_path, "rb") as a, open(tinfo.ply_path, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("text", [False, True])
@pytest.mark.parametrize("init_type", ["sfm", "random"])
def test_read_colmap_scene_matches_jax(tmp_path, text, init_type):
    roots = []
    for name in ("jax", "port"):
        root = tmp_path / name
        make_colmap_scene(root, text=text)
        roots.append(root)
    assert treaders.detect_scene_type(str(roots[1])) == "Colmap"
    infos = []
    for mod, root in zip((jreaders, treaders), roots):
        np.random.seed(5)  # the random init draws from numpy's global RNG
        infos.append(mod.read_colmap_scene(str(root), init_type=init_type,
                                           num_pts=64))
    jinfo, tinfo = infos
    assert len(tinfo.train_cameras) == 7 and len(tinfo.test_cameras) == 2
    assert [c.image_name for c in tinfo.test_cameras] == ["im_0", "im_8"]
    _same_info(jinfo, tinfo, roots[0], roots[1])
    assert tinfo.points.shape == ((9, 3) if init_type == "sfm" else (64, 3))


def test_colmap_scene_matches_jax(tmp_path):
    """Scene on the binary scene: cameras.json, the camera lists (not
    shuffled), and each loaded camera and image."""
    scenes = []
    for name in ("jax", "port"):
        root = tmp_path / name
        make_colmap_scene(root)
        kw = dict(init_type="sfm", shuffle=False)
        if name == "port":
            scenes.append(TScene(str(root), str(root / "out"), device="cpu",
                                 **kw))
        else:
            scenes.append(JScene(str(root), str(root / "out"), **kw))
    js, ts = scenes
    with open(tmp_path / "jax" / "out" / "cameras.json") as a, \
            open(tmp_path / "port" / "out" / "cameras.json") as b:
        assert json.load(a) == json.load(b)
    assert ts.cameras_extent == js.cameras_extent
    for jl, tl in ((js.train_cameras, ts.train_cameras),
                   (js.test_cameras, ts.test_cameras)):
        assert [c.image_name for c in jl] == [c.image_name for c in tl]
        for jc, tc in zip(jl, tl):
            (jcam, jimg), (tcam, timg) = jc.load(), tc.load()
            np.testing.assert_array_equal(jimg, timg)
            assert (jcam.width, jcam.height) == (tcam.width, tcam.height)
            np.testing.assert_allclose(np.asarray(jcam.full_proj),
                                       tcam.full_proj.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_colmap_refuses_distorted_cameras(tmp_path):
    make_colmap_scene(tmp_path)
    sparse = tmp_path / "sparse" / "0"
    cams = {1: tcolmap.ColmapCamera(1, "OPENCV", 16, 12,
                                    np.array([20.0, 21.0, 8, 6, 0, 0, 0, 0]))}
    tcolmap.write_cameras_binary(str(sparse / "cameras.bin"), cams)
    with pytest.raises(ValueError, match="undistort"):
        treaders.read_colmap_scene(str(tmp_path))


def make_google_scene(root, n_cams=9):
    cam_json = {}
    rng = np.random.default_rng(2)
    for i in range(n_cams):
        q = rng.normal(size=4)
        rot = tcolmap.qvec2rotmat(q / np.linalg.norm(q))
        cam_json[f"camera_{(5 * i) % n_cams:04d}.png"] = {
            "extrinsic": {"SO3": rot.tolist(),
                          "T": (rng.normal(size=3) + [0, 0, 3]).tolist()},
            "intrinsic": {"width": 16, "height": 12,
                          "matrix": [[20.0, 0, 8.5], [0, 19.0, 5.5],
                                     [0, 0, 1]]},
        }
    with open(root / "cam.json", "w") as f:
        json.dump(cam_json, f)
    os.makedirs(root / "undistorted")
    for i, name in enumerate(cam_json):
        _write_png(root / "undistorted" / name, seed=i)
    tcolmap.write_points3d_binary(str(root / "sfm.bin"),
                                  rng.normal(size=(11, 3)),
                                  np.full((11, 3), 40, np.uint8))


@pytest.mark.parametrize("init_type", ["sfm", "random"])
def test_read_google_immersive_scene_matches_jax(tmp_path, init_type):
    roots = []
    for name in ("jax", "port"):
        root = tmp_path / name
        os.makedirs(root)
        make_google_scene(root)
        roots.append(root)
    assert treaders.detect_scene_type(str(roots[1])) == "Google"
    infos = []
    for mod, root in zip((jreaders, treaders), roots):
        np.random.seed(6)
        infos.append(mod.read_google_immersive_scene(
            str(root), init_type=init_type, num_pts=32))
    _same_info(*infos, roots[0], roots[1])
    tinfo = infos[1]
    assert len(tinfo.test_cameras) == 2
    assert tinfo.test_cameras[0].extra_para == {
        "cx": 8.5, "cy": 5.5, "focal_x": 20.0, "focal_y": 19.0}
    # loaded through the port's Scene: principal point offsets reach the
    # camera, and the image is the undistorted/ file
    scene = TScene(str(roots[1]), "", init_type=init_type, num_pts=32,
                   shuffle=False, device="cpu")
    cam, img = scene.test_cameras[0].load()
    assert img.shape == (12, 16, 3) and cam.width == 16
    assert set(treaders.SCENE_LOAD_CALLBACKS) == set(
        jreaders.SCENE_LOAD_CALLBACKS)


def _points3d_bytes(rng, n):
    """A points3D.bin with tracks of 0-5 (image, point2d) pairs."""
    out = [struct.pack("<Q", n)]
    for i in range(n):
        track = int(rng.integers(0, 6))
        out.append(struct.pack("<Q3d3Bd", i + 1, *rng.normal(size=3),
                               *rng.integers(0, 256, 3).tolist(),
                               float(rng.uniform())))
        out.append(struct.pack("<Q", track))
        out.append(rng.integers(0, 1000, 2 * track).astype("<i4").tobytes())
    return b"".join(out)


def _images_bytes(rng, n):
    """An images.bin with names of varied lengths and 0-4 2D points."""
    out = [struct.pack("<Q", n)]
    for i in range(n):
        pts = int(rng.integers(0, 5))
        out.append(struct.pack("<i4d3di", 3 * i + 1, *rng.normal(size=4),
                               *rng.normal(size=3), int(rng.integers(1, 4))))
        out.append(("img_" + "x" * i + f"_{i}.jpg").encode() + b"\x00")
        out.append(struct.pack("<Q", pts))
        out.append(b"".join(struct.pack("<ddq", *rng.normal(size=2),
                                        int(rng.integers(-1, 9)))
                            for _ in range(pts)))
    return b"".join(out)


def test_binary_readers_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts, ims = tmp_path / "points3D.bin", tmp_path / "images.bin"
    pts.write_bytes(_points3d_bytes(rng, 40))
    ims.write_bytes(_images_bytes(rng, 13))
    got = tcolmap.read_points3d_binary(str(pts))
    want = jcolmap.read_points3d_binary(str(pts))
    assert got[0].shape == (40, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got = tcolmap.read_images_binary(str(ims))
    want = jcolmap.read_images_binary(str(ims))
    assert len(got) == 13 and list(got) == list(want)
    for a, b in zip(got.values(), want.values()):
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        assert (a.id, a.camera_id, a.name) == (b.id, b.camera_id, b.name)


def _images_one(pts):
    """A one-image images.bin with ``pts`` 2D points and the offsets of
    its name and of its points."""
    head = struct.pack("<Qi4d3di", 1, 1, *np.ones(4), *np.ones(3), 1)
    name = b"frame_0001.jpg\x00"
    body = struct.pack("<Q", pts) + b"\x00" * 24 * pts
    return head + name + body, len(head), len(head) + len(name) + 8


# (file, where the cut falls): the bytes kept
CUTS = {
    "images_count": lambda: _images_one(2)[0][:5],
    "images_name": lambda: _images_one(2)[0][:_images_one(2)[1] + 6],
    "images_points": lambda: _images_one(2)[0][:_images_one(2)[2] + 30],
    "points_record": lambda: _points3d_bytes(np.random.default_rng(4),
                                             5)[:-3],
}


@pytest.mark.parametrize("cut", list(CUTS))
def test_binary_readers_refuse_truncated_input(tmp_path, cut):
    path = tmp_path / ("images.bin" if cut.startswith("images")
                       else "points3D.bin")
    path.write_bytes(CUTS[cut]())
    read = (tcolmap.read_images_binary if cut.startswith("images")
            else tcolmap.read_points3d_binary)
    with pytest.raises(ValueError, match=path.name):
        read(str(path))


def test_convert_refuses_without_colmap(tmp_path):
    missing = str(tmp_path / "no_such_colmap")
    with pytest.raises(SystemExit) as got:
        tconvert.main(["-s", str(tmp_path), "--colmap_executable", missing])
    with pytest.raises(SystemExit) as want:
        jconvert.main(["-s", str(tmp_path), "--colmap_executable", missing])
    assert str(got.value) == str(want.value)
    assert "not found on PATH" in str(got.value)
    if shutil.which("colmap") is None:
        with pytest.raises(SystemExit, match="install COLMAP"):
            tconvert.convert(str(tmp_path))
    assert not os.path.exists(tmp_path / "distorted")
