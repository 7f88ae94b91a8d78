"""One viewer plays a SwinGS volumetric video in a closed loop: each frame
is what the stream player does for one camera at one video frame
(``eval/render_stream.make_stream_render_fn`` at the viewer's resolution,
then ``network_gui.image_to_bytes``, as the view loop serves one). The
video advances one frame a rendered frame from a start frame drawn from
the seed, wrapping at the configuration's ``frames``; the camera orbits
as in the view loop.

Set-up makes the stream from the seed (``benchmark/streams.py``), writes
it with the benchmark's own writer into a temporary directory (deleted at
``release``) and loads it through the program's ``load_stream_state``.
The duplicate budget is probed at set-up over cameras every
``probe_every_deg`` degrees at video frames every ``probe_every_frames``
frames, with headroom. After the window the reference counts every
played frame's duplicates (a frame over the budget is a failure) and
renders a sample of the frames, drawn from the seed, to compare them
byte for byte (the view cell's ``compare``).
"""

from __future__ import annotations

import math
import tempfile
from collections import defaultdict

import numpy as np
import torch

from benchmark import inputs, streams
from benchmark.loops import view
from benchmark.reference import playback as ref_playback, raster
from benchmark.reference.train import activated

compare = view.compare      # the view cell's comparison of served bytes


class Loop(view.Loop):
    unit = "frames"

    def __init__(self, cfg, mix, device, seed, traced):
        super().__init__(cfg, mix, device, seed, traced)
        self.stream = None          # the benchmark's columns, when held
        self.tmp = None

    def video_frame(self, i):
        return (self.frame0 + i) % self.cfg["frames"]

    def columns(self):
        if self.stream is None:
            self.stream = streams.stream_columns(self.cfg, self.device,
                                                 self.seed)
        return self.stream

    def dup_counts(self, pairs):
        """{(angle, video frame): the reference's pair count} over
        ``pairs``, each frame's live rows selected once."""
        stream = self.columns()
        by_frame = defaultdict(set)
        for a, f in pairs:
            by_frame[f].add(a)
        out = {}
        with torch.no_grad():
            for f, angles in by_frame.items():
                act = activated(ref_playback.live_rows(stream, f))[:4]
                for a in angles:
                    cam = inputs.ref_camera(self.matrices(a), self.device)
                    out[a, f] = raster.num_dup(*act, cam, *self.tile)
        return out

    def prepare(self):
        """The inputs, without the program: the orbit's start, the video's
        start frame and the frames sampled for the check, drawn from the
        seed; the stream's columns; the duplicate budget (the reference's
        count at the probe cameras and frames, with headroom)."""
        mix = self.mix
        rng = np.random.default_rng(self.seed)
        self.start = float(rng.uniform(0.0, 2 * math.pi))
        self.frame0 = int(rng.integers(self.cfg["frames"]))
        self.pick = np.random.default_rng([self.seed, 1])
        self.kept = {}
        self.tile = tuple(mix["tile"])
        probe = inputs.ring(int(round(360 / mix["probe_every_deg"])))
        frames = range(0, self.cfg["frames"], mix["probe_every_frames"])
        need = max(self.dup_counts([(a, f) for a in probe
                                    for f in frames]).values())
        align = mix["dup_align"]
        self.k_dup = -(-int(need * mix["dup_headroom"]) // align) * align

    def setup(self):
        from gsplat_tpu_torch.core.camera import camera_from_matrices
        from gsplat_tpu_torch.eval.render_stream import (
            load_stream_state, make_stream_render_fn)
        from gsplat_tpu_torch.viewer import network_gui

        cfg, mix, dev = self.cfg, self.mix, self.device
        self.prepare()
        self.tmp = tempfile.TemporaryDirectory(prefix="swin-stream-")
        streams.write_stream(self.columns(), self.tmp.name,
                             cfg["sh_degree"])
        self.stream = None
        state = load_stream_state(self.tmp.name, dev)
        render = make_stream_render_fn(state, self.k_dup, mix["width"],
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
                img = render(cam, float(self.video_frame(i)))
            with self.span("bytes"):
                data = to_bytes(img)
            self.keep(i, data)
            return data

        self.frame = frame
        self.state = state
        for i in range(mix["warm_frames"]):
            frame(-1 - i)
        self.span.items.clear()     # the window's spans only

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
        stream = self.columns()
        self.work = {}
        out = {}
        with raster.no_tf32():
            for i in frames:
                f = self.video_frame(i)
                cam = inputs.ref_camera(self.matrices(self.angle(i)),
                                        self.device)
                out[i] = ref_playback.frame_bytes(
                    stream, f, cam, self.cfg["sh_degree"], self.tile,
                    dtype=dtype, work=self.work)
                self.work["gaussians"] = self.work.get("gaussians", 0) + int(
                    ((stream["start_frame"] <= f)
                     & (stream["end_frame"] > f)).sum())
        return out

    def check(self):
        ref = self.reference_frames(sorted(self.kept))
        self.late_failures = self.count_failures()
        self.stream = None
        self.details = {"k_dup": self.k_dup, "frames": sorted(self.kept),
                        "video_frames": [self.video_frame(i)
                                         for i in sorted(self.kept)],
                        "work": self.work}
        m, n = self.mix, max(len(ref), 1)
        self.work = {k: v / n for k, v in self.work.items()}
        self.work.update(pixels=m["width"] * m["height"],
                         param_floats=inputs.param_floats(
                             self.cfg["sh_degree"]))
        return compare({i: np.frombuffer(b, np.uint8) for i, b in
                        self.kept.items()},
                       {i: r.reshape(-1).cpu().numpy() for i, r in
                        ref.items()})
