"""gsplat_tpu_torch model IO and the SIBR viewer server, on the CPU.

- PLY: the port writes byte-identical files to the JAX package, reads the
  JAX package's files, and a save/load round trip restores every leaf.
- Wire protocol: a fake SIBR client (written here) sends requests over
  loopback to ``gsplat_tpu_torch.viewer.serve.serve`` running in a thread;
  the reply bytes must equal the in-process render of the decoded camera,
  and the decoded camera must equal the one the client encoded.
"""

import json
import math
import os
import socket
import threading

import numpy as np
import pytest
import torch

from gsplat_tpu.core import camera as jcamera
from gsplat_tpu.data import ply as jply
from gsplat_tpu.model import gaussians as jgauss
from gsplat_tpu_torch.core import camera as tcamera
from gsplat_tpu_torch.data import ply as tply
from gsplat_tpu_torch.model import gaussians as tgauss
from gsplat_tpu_torch.viewer import network_gui, serve
from tests.test_torch_core import jax_state
from tests.test_torch_kernels import make_params
from tests.torch_threads import one_torch_thread  # noqa: F401

LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def test_ply_bytes_match_jax(tmp_path):
    par = make_params(p=300, cap=400, deg=2, seed=4)
    js = jax_state(par, 300, 2)
    ts = tgauss.state_from_numpy(par, 300, 2, "cpu")
    jgauss.save_ply(js, str(tmp_path / "jax.ply"))
    tgauss.save_ply(ts, str(tmp_path / "port.ply"))
    assert (tmp_path / "jax.ply").read_bytes() == \
        (tmp_path / "port.ply").read_bytes()
    for got, want in zip(tply.load_gaussian_ply(str(tmp_path / "jax.ply"), 2),
                         jply.load_gaussian_ply(str(tmp_path / "port.ply"),
                                                2)):
        np.testing.assert_array_equal(got, want)


def test_ply_round_trip(tmp_path):
    par = make_params(p=300, cap=400, deg=1, seed=5)
    ts = tgauss.state_from_numpy(par, 300, 1, "cpu")
    path = str(tmp_path / "m" / "point_cloud.ply")
    tgauss.save_ply(ts, path)
    back = tgauss.load_ply(path, capacity=500, max_sh_degree=1, device="cpu")
    assert back.n_alive == 300 and back.capacity == 500
    for key, v in back.params().items():
        np.testing.assert_array_equal(v[:300].numpy(), par[key][:300],
                                      err_msg=key)
        assert not v[300:].any(), key
    with pytest.raises(ValueError):
        tgauss.load_ply(path, capacity=500, max_sh_degree=2, device="cpu")
    with pytest.raises(ValueError):
        tgauss.load_ply(path, capacity=200, max_sh_degree=1, device="cpu")


def test_find_latest_iteration(tmp_path):
    for it in (7, 30000, 500):
        os.makedirs(tmp_path / "point_cloud" / f"iteration_{it}")
    assert serve.find_latest_iteration(str(tmp_path)) == 30000


def client_message(cam, keep_alive=True, width=None, height=None):
    """The JSON body exactly as the SIBR remote viewer builds it: row-major
    matrices in the reference's transposed (row-vector) layout with the
    Y/Z column signs flipped."""
    view = np.asarray(cam.view).T.copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    full = np.asarray(cam.full_proj).T.copy()
    full[:, 1] *= -1
    return {
        "resolution_x": cam.width if width is None else width,
        "resolution_y": cam.height if height is None else height,
        "train": False, "fov_y": 0.7, "fov_x": 0.9,
        "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": 1.0,
        "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": full.reshape(-1).tolist(),
    }


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed the connection"
        buf += chunk
    return buf


def test_request_decodes_to_the_jax_camera():
    cam = jcamera.make_camera(np.eye(3), np.array([0.1, -0.2, 3.0]), 0.9,
                              0.7, 64, 32)
    got, flags = network_gui.request_to_camera(client_message(cam), "cpu")
    np.testing.assert_allclose(got.view.numpy(), np.asarray(cam.view),
                               atol=1e-6)
    np.testing.assert_allclose(got.full_proj.numpy(),
                               np.asarray(cam.full_proj), atol=1e-6)
    np.testing.assert_allclose(got.cam_pos.numpy(), np.asarray(cam.cam_pos),
                               atol=1e-5)
    assert float(got.tan_fovx) == pytest.approx(math.tan(0.45), rel=1e-6)
    assert flags["keep_alive"] and flags["scaling_modifier"] == 1.0
    assert network_gui.request_to_camera(
        client_message(cam, width=0), "cpu") == (None, None)


def test_sibr_request_over_loopback():
    """Two keep-alive requests and a zero-resolution ping, answered by the
    server loop on the CPU over a real socket."""
    par = make_params(p=300, cap=400, deg=1, seed=6)
    state = tgauss.state_from_numpy(par, 300, 1, "cpu")
    k_dup = 8 * state.capacity
    gui = network_gui.NetworkGUI("127.0.0.1", 0)
    stop = threading.Event()
    server = threading.Thread(target=serve.serve, daemon=True, args=(
        gui, state, k_dup, "model_dir"), kwargs=dict(device="cpu", stop=stop))
    server.start()
    w, h = 160, 64   # 2 x 2 tiles of 128 x 32
    cams = [tcamera.make_camera(np.eye(3), np.array([dx, 0.0, 0.0]), 0.9,
                                0.7, w, h, device="cpu")
            for dx in (0.0, 0.3)]
    replies = []
    try:
        with socket.create_connection(("127.0.0.1", gui.port),
                                      timeout=120) as sock:
            for msg in [client_message(c) for c in cams] + [
                    client_message(cams[0], width=0, height=0)]:
                body = json.dumps(msg).encode("utf-8")
                sock.sendall(len(body).to_bytes(4, "little") + body)
                n_img = msg["resolution_x"] * msg["resolution_y"] * 3
                img = recv_exact(sock, n_img)
                n = int.from_bytes(recv_exact(sock, 4), "little")
                replies.append((img, recv_exact(sock, n).decode("ascii")))
    finally:
        stop.set()
        server.join(timeout=60)
        gui.close()
    assert not server.is_alive()
    render = serve.make_render_fn(state, k_dup, w, h, "cpu")
    for cam, (img, verify) in zip(cams, replies):
        assert verify == "model_dir"
        decoded, _ = network_gui.request_to_camera(client_message(cam), "cpu")
        want = render(decoded)
        assert want.shape == (h, w, 3) and float(want.float().mean()) > \
            0.05 * 255
        assert img == network_gui.image_to_bytes(want)
    assert replies[0][0] != replies[1][0]
    assert replies[2] == (b"", "model_dir")


def test_entry_points_refuse_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    par = make_params(p=10, cap=16, deg=0, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgauss.state_from_numpy(par, 10, 0)
    ts = tgauss.state_from_numpy(par, 10, 0, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_render_fn(ts, 64, 32, 32)
