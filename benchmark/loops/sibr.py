"""One SIBR viewer over the live-viewer server's socket, in a closed loop:
the program's ``viewer/serve.serve`` answers on a
``network_gui.NetworkGUI`` at 127.0.0.1 on an ephemeral port, in a
thread of this process; this loop is the viewer, over one kept-alive
connection. Each frame sends the request body the SIBR remote viewer
sends for the view loop's orbit camera (row-major transposed matrices,
the Y/Z column signs flipped, as ``network_gui`` decodes them), then
reads the reply: the frame's RGB bytes and the verify string. The next
request goes as soon as the last reply is in.

The state, the duplicate budget (passed to ``serve`` as its ``k_dup``),
the warm frames, the sampled frames, the check and its limits are the
view loop's; the bytes compared are those received. A request decodes to
the view loop's camera bit for bit (the same float32 matrices, the same
``math.tan`` of the same field of view, the same ``cam_pos``
computation), so the reference is the view cell's.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

from benchmark.loops import view

compare = view.compare      # the view cell's comparison of served bytes
VERIFY = "benchmark"
# a reply that takes longer means the server is gone: fail, do not hang
REPLY_TIMEOUT_S = 120.0


def request_body(m: dict, fov: float) -> bytes:
    """The length-prefixed JSON request of the SIBR remote viewer for the
    camera of ``inputs.orbit_matrices``' ``m``."""
    view_m = m["view"].T.copy()
    view_m[:, 1] *= -1
    view_m[:, 2] *= -1
    full = m["full_proj"].T.copy()
    full[:, 1] *= -1
    body = json.dumps({
        "resolution_x": m["width"], "resolution_y": m["height"],
        "train": False, "fov_y": fov, "fov_x": fov,
        "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": True, "scaling_modifier": 1.0,
        "view_matrix": view_m.reshape(-1).tolist(),
        "view_projection_matrix": full.reshape(-1).tolist(),
    }).encode("utf-8")
    return len(body).to_bytes(4, "little") + body


def recv_exact(sock, n: int) -> bytearray:
    """``n`` bytes from the blocking ``sock``, received into one buffer by
    one ``MSG_WAITALL`` receive (the viewer's side costs one system call
    and one release of the interpreter lock, not one a segment)."""
    buf = bytearray(n)
    got = memoryview(buf)
    while got:
        k = sock.recv_into(got, len(got), socket.MSG_WAITALL)
        if not k:
            raise ConnectionError("the server closed the connection")
        got = got[k:]
    return buf


class Loop(view.Loop):
    unit = "frames"

    def __init__(self, cfg, mix, device, seed, traced):
        super().__init__(cfg, mix, device, seed, traced)
        self.gui = self.server = self.sock = None
        self.stop = threading.Event()

    def setup(self):
        from gsplat_tpu_torch.model.gaussians import GaussianState
        from gsplat_tpu_torch.viewer import network_gui, serve

        cfg, mix, dev = self.cfg, self.mix, self.device
        p0 = self.prepare()
        state = GaussianState(
            xyz=p0["xyz"], features_dc=p0["f_dc"], features_rest=p0["f_rest"],
            scaling=p0["scaling"], rotation=p0["rotation"],
            opacity=p0["opacity"], n_alive=cfg["gaussians"],
            max_sh_degree=cfg["sh_degree"])
        del p0
        self.gui = network_gui.NetworkGUI("127.0.0.1", 0)
        self.server = threading.Thread(
            target=serve.serve, args=(self.gui, state, self.k_dup, VERIFY),
            kwargs=dict(device=dev, stop=self.stop), daemon=True)
        self.server.start()
        del state
        self.sock = socket.create_connection(("127.0.0.1", self.gui.port),
                                             timeout=REPLY_TIMEOUT_S)
        # blocking, so that MSG_WAITALL waits for the whole reply; the
        # kernel's receive timeout keeps a dead server from hanging it
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO,
                             struct.pack("ll", int(REPLY_TIMEOUT_S), 0))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        n_img = mix["width"] * mix["height"] * 3
        tail = 4 + len(VERIFY)
        self.sent = 0

        def frame(i):
            m = self.matrices(self.angle(i))
            with self.span("request"):
                self.sock.sendall(request_body(m, mix["fov"]))
            with self.span("reply"):
                data = recv_exact(self.sock, n_img)
                end = recv_exact(self.sock, tail)
            if end[4:].decode("ascii") != VERIFY:
                raise ValueError(f"the reply's verify string is {end!r}")
            self.keep(i, data)
            return data

        self.frame = frame
        for i in range(mix["warm_frames"]):
            frame(-1 - i)
        self.span.items.clear()     # the window's spans only

    def release(self):
        """Stops the server: its blocked receive ends when the connection
        closes."""
        self.frame = None
        self.stop.set()
        if self.sock is not None:
            self.sock.close()
            self.sock = None
        if self.server is not None:
            self.server.join(timeout=60)
            alive = self.server.is_alive()
            self.server = None
            if alive:
                raise RuntimeError("the server thread did not stop")
        if self.gui is not None:
            self.gui.close()
            self.gui = None
