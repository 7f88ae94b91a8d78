"""One viewer of a SwinGS window in a closed loop: each frame is what the
live-viewer server does for a request on a SwinGS checkpoint
(``viewer/serve.make_window_render_fn`` at the viewer's resolution, then
``network_gui.image_to_bytes``), without the socket. The video time
starts at a point of the window drawn from the seed and advances
``video_frames_per_frame`` frames a rendered frame (a display faster than
the video), wrapping over the window [w, w + L); every frame moves every
row of the union to a new pose. The camera orbits as in the view loop.

Set-up loads the program first (a program without the window's render
fails here at once), makes the trainer's state at the window from the
seed (``benchmark/windows.py``), writes it as the trainer's checkpoint
with the benchmark's own writer into a temporary directory (deleted at
``release``) and loads it through the program's ``swin.load_window``.
The duplicate budget is probed at set-up over cameras every
``probe_every_deg`` degrees at video times every ``probe_every_frames``
frames of the window, with headroom. After the window the reference
(``reference/window.py``, the whole union as the benchmark made it)
counts every served frame's duplicates (a frame over the budget is a
failure) and renders a sample of the frames, drawn from the seed, to
compare them byte for byte (the view cell's ``compare``).
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from benchmark import inputs, windows
from benchmark.harness import sync
from benchmark.loops import view
from benchmark.reference import raster, window as ref_window
from benchmark.reference.train import activated

compare = view.compare      # the view cell's comparison of served bytes


class Loop(view.Loop):
    unit = "frames"

    def __init__(self, cfg, mix, device, seed, traced):
        super().__init__(cfg, mix, device, seed, traced)
        self.made = None            # the benchmark's state, when held
        self.union = None           # its union's columns, when held
        self.tmp = None

    @property
    def steps(self) -> int:
        """Video times a lap of the window shows."""
        return int(round(self.cfg["swin_size"]
                         / self.mix["video_frames_per_frame"]))

    def video_frame(self, i):
        """The video time of frame ``i``: exact in float (a multiple of a
        power-of-two step from the window's start)."""
        q = (self.step0 + i) % self.steps
        return self.cfg["window_start"] + q * self.mix[
            "video_frames_per_frame"]

    def generated(self):
        if self.made is None:
            self.made = windows.window_state(self.cfg, self.device,
                                             self.seed)
        return self.made

    def columns(self):
        if self.union is None:
            self.union = windows.union(self.generated())
        return self.union

    def dup_counts(self, pairs):
        """{(angle, video time): the reference's pair count} over
        ``pairs``, each time's live rows moved once."""
        union = self.columns()
        by_frame = defaultdict(set)
        for a, f in pairs:
            by_frame[f].add(a)
        out = {}
        with torch.no_grad(), raster.no_tf32():
            for f, angles in by_frame.items():
                act = activated(ref_window.live_rows(
                    union, f, self.cfg["deform"]))[:4]
                for a in angles:
                    cam = inputs.ref_camera(self.matrices(a), self.device)
                    out[a, f] = raster.num_dup(*act, cam, *self.tile)
        return out

    def prepare(self):
        """The inputs, without the program: the orbit's start, the video's
        start time and the frames sampled for the check, drawn from the
        seed; the union's columns; the duplicate budget (the reference's
        count at the probe cameras and times, with headroom)."""
        cfg, mix = self.cfg, self.mix
        rng = np.random.default_rng(self.seed)
        self.start = float(rng.uniform(0.0, 2 * math.pi))
        self.step0 = int(rng.integers(self.steps))
        self.pick = np.random.default_rng([self.seed, 1])
        self.kept = {}
        self.tile = tuple(mix["tile"])
        probe = inputs.ring(int(round(360 / mix["probe_every_deg"])))
        every = mix["probe_every_frames"]
        times = [cfg["window_start"] + every * k
                 for k in range(int(round(cfg["swin_size"] / every)))]
        need = max(self.dup_counts([(a, f) for a in probe
                                    for f in times]).values())
        align = mix["dup_align"]
        self.k_dup = -(-int(need * mix["dup_headroom"]) // align) * align

    def setup(self):
        from gsplat_tpu_torch.viewer.serve import make_window_render_fn
        from gsplat_tpu_torch.core.camera import camera_from_matrices
        from gsplat_tpu_torch.model.swin import load_window
        from gsplat_tpu_torch.viewer import network_gui

        cfg, mix, dev = self.cfg, self.mix, self.device
        self.prepare()
        self.tmp = tempfile.TemporaryDirectory(prefix="swin-window-")
        it = cfg["checkpoint_iteration"]
        path = os.path.join(self.tmp.name,
                            f"chkpnt_{cfg['window_start']}_{it}.npz")
        windows.write_checkpoint(self.generated(), path, cfg, it)
        self.made = self.union = None
        state, _ = load_window(path, dev)
        render = make_window_render_fn(state, self.k_dup, mix["width"],
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
                img = render(cam, self.video_frame(i))
            timed = self.timed
            if timed:
                sync(dev)
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

    def release(self):
        super().release()
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None

    def count_failures(self):
        pairs = [(self.angle(i), self.video_frame(i))
                 for i in range(self.sent)]
        counts = self.dup_counts(pairs)
        return sum(counts[p] > self.k_dup for p in pairs)

    def reference_frames(self, frames, dtype=torch.float32):
        """{frame: uint8 [H, W, 3]} of ``frames``, by the reference; the
        live rows of each frame added up under ``work["gaussians"]``."""
        union = self.columns()
        self.work = {}
        out = {}
        with raster.no_tf32():
            for i in frames:
                f = self.video_frame(i)
                cam = inputs.ref_camera(self.matrices(self.angle(i)),
                                        self.device)
                out[i] = ref_window.frame_bytes(
                    union, f, cam, self.cfg["sh_degree"], self.tile,
                    self.cfg["deform"], dtype=dtype, work=self.work)
                self.work["gaussians"] = self.work.get("gaussians", 0) + int(
                    ref_window.live_mask(union, f).sum())
        return out

    def check(self):
        ref = self.reference_frames(sorted(self.kept))
        self.late_failures = self.count_failures()
        self.made = self.union = None
        self.details = {"k_dup": self.k_dup, "frames": sorted(self.kept),
                        "video_frames": [self.video_frame(i)
                                         for i in sorted(self.kept)],
                        "work": self.work}
        m, n = self.mix, max(len(ref), 1)
        self.work = {k: v / n for k, v in self.work.items()}
        self.work.update(pixels=m["width"] * m["height"],
                         param_floats=inputs.param_floats(
                             self.cfg["sh_degree"]),
                         union_rows=self.cfg["cap_max"]
                         + self.cfg["buffer_size"])
        return compare({i: np.frombuffer(b, np.uint8) for i, b in
                        self.kept.items()},
                       {i: r.reshape(-1).cpu().numpy() for i, r in
                        ref.items()})
