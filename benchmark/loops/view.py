"""One viewer served in a closed loop: each frame is what the live-viewer
server does for a request (``viewer/serve.make_render_fn`` at the
viewer's resolution, then ``network_gui.image_to_bytes``), without the
socket; the next camera is asked for as soon as the last frame's bytes
are ready. The camera moves ``deg_per_frame`` degrees a frame along an
orbit, from an angle drawn from the seed.

The duplicate budget is probed at set-up over cameras every
``probe_every_deg`` degrees of the orbit, with headroom. After the
window the reference counts every served frame's duplicates (a frame
over the budget is a failure) and renders a sample of the frames, drawn
from the seed, to compare them byte for byte.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import sync
from benchmark.spans import Spans
from benchmark.reference import raster, train as ref_train, view as ref_view


class Loop:
    unit = "frames"

    def __init__(self, cfg, mix, device, seed, traced):
        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, seed
        self.timed = traced         # synchronised spans (the harness sets)
        self.spans = {"host_frame": [], "frame": []}
        self.span = Spans(False)    # host spans, on in a traced stretch
        self.work = None

    @property
    def host_spans(self):
        return self.span.items

    def angle(self, i):
        return self.start + math.radians(self.mix["deg_per_frame"]) * i

    def matrices(self, angle):
        m = self.mix
        return inputs.orbit_matrices(angle, m["width"], m["height"],
                                     m["radius"], m["center"], m["fov"])

    def prepare(self):
        """The inputs, without the program: the orbit's start and the
        frames sampled for the check, drawn from the seed; the state's
        leaves; the duplicate budget (the reference's count at the probe
        cameras, with headroom). Returns the leaves."""
        cfg, mix, dev = self.cfg, self.mix, self.device
        rng = np.random.default_rng(self.seed)
        self.start = float(rng.uniform(0.0, 2 * math.pi))
        self.pick = np.random.default_rng([self.seed, 1])
        self.kept = {}
        self.tile = tuple(mix["tile"])
        p0 = inputs.state_leaves(cfg, dev, self.seed)
        act = ref_train.activated(p0)[:4]
        probe = inputs.ring(int(round(360 / mix["probe_every_deg"])))
        need = max(raster.num_dup(*act, inputs.ref_camera(
            self.matrices(a), dev), *self.tile) for a in probe)
        align = mix["dup_align"]
        self.k_dup = -(-int(need * mix["dup_headroom"]) // align) * align
        return p0

    def keep(self, i, data):
        """A uniform sample of ``mix["samples"]`` of the window's frames,
        drawn from the seed as the frames come (reservoir sampling)."""
        k = self.mix["samples"]
        if i < 0:
            return
        if len(self.kept) < k:
            self.kept[i] = data
            return
        j = int(self.pick.integers(i + 1))
        if j < k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = data

    def setup(self):
        from gsplat_tpu_torch.core.camera import camera_from_matrices
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
        render = serve.make_render_fn(state, self.k_dup, mix["width"],
                                      mix["height"], device=dev)
        to_bytes = network_gui.image_to_bytes
        self.sent = 0

        def frame(i):
            m = self.matrices(self.angle(i))
            with self.span("camera"):
                cam = camera_from_matrices(
                    m["view"], m["full_proj"], m["cam_pos"], m["tan_fovx"],
                    m["tan_fovy"], m["width"], m["height"], device=dev)
            with self.span("render"):
                img = render(cam)
            timed = self.timed
            if timed:
                sync(self.device)
                t0 = time.perf_counter()
            with self.span("bytes"):
                data = to_bytes(img)
            if timed:
                self.spans["host_frame"].append(time.perf_counter() - t0)
            self.keep(i, data)
            return data

        self.frame = frame
        self.state = state
        for i in range(mix["warm_frames"]):
            frame(-1 - i)
        self.spans["host_frame"].clear()    # the window's spans only
        self.span.items.clear()

    def step(self, i):
        t0 = time.perf_counter()
        self.frame(i)
        self.spans["frame"].append(time.perf_counter() - t0)
        self.sent = i + 1

    def failures(self):
        """Frames of the window whose duplicate count (the reference's,
        counted by ``check``) exceeded the budget."""
        return self.late_failures

    def release(self):
        self.frame = None
        self.state = None

    def count_failures(self, p):
        act = ref_train.activated(p)[:4]
        bad = 0
        for i in range(self.sent):
            cam = inputs.ref_camera(self.matrices(self.angle(i)), self.device)
            bad += raster.num_dup(*act, cam, *self.tile) > self.k_dup
        return bad

    def reference_frames(self, frames, dtype=torch.float32):
        """{frame: uint8 [H, W, 3]} of ``frames``, by the reference."""
        p = inputs.state_leaves(self.cfg, self.device, self.seed)
        self.work = {}
        out = {}
        with raster.no_tf32():
            for i in frames:
                cam = inputs.ref_camera(self.matrices(self.angle(i)),
                                        self.device)
                out[i] = ref_view.frame_bytes(p, cam, self.cfg["sh_degree"],
                                              self.tile, dtype=dtype,
                                              work=self.work)
        return out

    def check(self):
        ref = self.reference_frames(sorted(self.kept))
        self.late_failures = self.count_failures(inputs.state_leaves(
            self.cfg, self.device, self.seed))
        self.details = {"k_dup": self.k_dup, "frames": sorted(self.kept),
                        "work": self.work}
        m, n = self.mix, max(len(ref), 1)
        self.work = {k: v / n for k, v in self.work.items()}
        self.work.update(pixels=m["width"] * m["height"],
                         gaussians=self.cfg["gaussians"],
                         param_floats=inputs.param_floats(
                             self.cfg["sh_degree"]))
        return compare({i: np.frombuffer(b, np.uint8) for i, b in
                        self.kept.items()},
                       {i: r.reshape(-1).cpu().numpy() for i, r in
                        ref.items()})


def compare(got: dict, want: dict):
    """The numbers the check compares over the sampled frames: the share
    of bytes that differ by more than one level, and the mean absolute
    difference in levels."""
    if not want:
        return {"bytes_off_by_2_share": math.inf, "mean_abs_levels": math.inf}
    n = off = total = 0
    for i, w in want.items():
        g = got.get(i)
        if g is None or g.shape != w.shape:
            return {"bytes_off_by_2_share": math.inf,
                    "mean_abs_levels": math.inf}
        d = np.abs(g.astype(np.int16) - w.astype(np.int16))
        n += d.size
        off += int((d > 1).sum())
        total += int(d.sum())
    return {"bytes_off_by_2_share": off / n, "mean_abs_levels": total / n}
