"""Static 3DGS-MCMC training at the cap, as a user's training run drives
it past the start of densification: camera ``i % n`` at iteration
``first_iteration + i``, the fused train step (render, L1 + D-SSIM,
backward, Adam, noise) every step, relocation + growth whenever the
iteration is a densification iteration.

Set-up runs the first ``check_steps`` steps through the window's own
call on the benchmark's state; the reference follows them (see
``check``). The window then carries on from the state they left.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import inputs
from benchmark.harness import sync
from benchmark.spans import Spans
from benchmark.reference import raster, train as ref_train

B1 = 0.9


class Loop:
    unit = "steps"

    def __init__(self, cfg, mix, device, seed, traced):
        self.cfg, self.mix, self.device, self.seed = cfg, mix, device, seed
        self.timed = traced         # synchronised spans (the harness sets)
        self.spans = {"densify": []}
        self.span = Spans(False)    # host spans, on in a traced stretch
        self.work = None

    # ------------------------------------------------------------ set-up --
    def prepare(self):
        """The inputs, without the program: cameras, ground truths, the
        state's leaves from the seed, the duplicate budget (the
        reference's count at the cameras, with headroom), the check's
        iterations. Returns the leaves."""
        cfg, tr, dev = self.cfg, self.cfg["train"], self.device
        self.tile = tuple(tr["tile"])
        self.mats = [inputs.orbit_matrices(a, tr["width"], tr["height"],
                                           tr["radius"], tr["center"],
                                           tr["fov"])
                     for a in inputs.ring(tr["cameras"])]
        self.ref_cams = [inputs.ref_camera(m, dev) for m in self.mats]
        self.gts = self.ground_truths()
        p0 = inputs.state_leaves(cfg, dev, self.seed)
        need = [raster.num_dup(*ref_train.activated(p0)[:4], c, *self.tile)
                for c in self.ref_cams]
        k = max(int(max(need) * tr["dup_headroom"]), tr["dup_floor"])
        self.k_dup = -(-k // tr["chunk"]) * tr["chunk"]
        self.opt = cfg["optimization"]
        first = self.mix["first_iteration"]
        self.iterations = [first + i for i in range(self.mix["check_steps"])]
        return p0

    def setup(self):
        from gsplat_tpu_torch.core.camera import camera_from_matrices
        from gsplat_tpu_torch.model import optim
        from gsplat_tpu_torch.model.gaussians import GaussianState
        from gsplat_tpu_torch.raster.rasterize import RasterizeSettings
        from gsplat_tpu_torch.train import step as step_lib
        from gsplat_tpu_torch.train.config import OptimizationConfig

        cfg, tr, dev = self.cfg, self.cfg["train"], self.device
        p0 = self.prepare()
        cams = [camera_from_matrices(
            m["view"], m["full_proj"], m["cam_pos"], m["tan_fovx"],
            m["tan_fovy"], m["width"], m["height"], device=dev)
            for m in self.mats]
        state = GaussianState(
            xyz=p0["xyz"].clone(), features_dc=p0["f_dc"].clone(),
            features_rest=p0["f_rest"].clone(), scaling=p0["scaling"].clone(),
            rotation=p0["rotation"].clone(), opacity=p0["opacity"].clone(),
            n_alive=cfg["gaussians"], max_sh_degree=cfg["sh_degree"])
        settings = RasterizeSettings(k_dup=self.k_dup, tile_x=self.tile[0],
                                     tile_y=self.tile[1], chunk=tr["chunk"])
        train_step = step_lib.make_train_step(
            OptimizationConfig(**self.opt), settings, tr["spatial_lr_scale"])
        densify_step = step_lib.make_densify_step(cfg["cap_max"])
        gen = inputs.generator(dev, self.noise_seed())
        bg = torch.zeros(3, device=dev)
        carry = {"state": state, "adam": optim.init(state.params())}
        self.losses, self.dups, self.densifies = [], [], 0
        sh, first = cfg["sh_degree"], self.mix["first_iteration"]

        def call(i):
            it = first + i
            c = i % len(cams)
            with self.span("step"):
                s, a, m = train_step(carry["state"], carry["adam"], gen,
                                     cams[c], self.gts[c], bg, float(it), sh)
            self.losses.append(m.loss)
            # a copy: num_dup is a view that would keep binning's offsets
            self.dups.append(m.num_dup.reshape(()).clone())
            if self.densify_due(it):
                self.densifies += 1
                timed = self.timed
                if timed:
                    sync(self.device)
                    t0 = time.perf_counter()
                with self.span("densify"):
                    s, a = densify_step(s, a, gen)
                if timed:
                    sync(self.device)
                    self.spans["densify"].append(time.perf_counter() - t0)
            carry["state"], carry["adam"] = s, a

        self.call, self.carry = call, carry
        # the first steps, through the window's own call, read for the check
        n = self.mix["check_steps"]
        call(0)
        self.port_grad = {k: float(torch.linalg.vector_norm(
            v.double()) / (1 - B1)) for k, v in carry["adam"].mu.items()}
        for i in range(1, n):
            call(i)
        p = carry["state"].params()
        self.port_change = {k: float(torch.linalg.vector_norm(
            (p[k] - p0[k]).double())) for k in p}
        self.port_losses = [float(x) for x in self.losses[:n]]
        del p0, p
        self.first_window_index = n
        self.losses, self.dups, self.densifies = [], [], 0
        self.spans["densify"].clear()       # the window's spans only
        self.span.items.clear()

    @property
    def host_spans(self):
        return self.span.items

    def noise_seed(self):
        return self.seed ^ 0x5EED

    def densify_due(self, it):
        o = self.opt
        return (o["densify_from_iter"] < it < o["densify_until_iter"]
                and it % o["densification_interval"] == 0)

    def ground_truths(self):
        """The configuration's ground-truth scene through the reference, at
        every training camera (seed-independent)."""
        g = self.cfg["gt"]
        leaves = inputs.gt_scene(g["gaussians"], self.device, g["seed"])
        means, scales, quats, opa, shs = ref_train.activated(leaves)
        out = []
        with raster.no_tf32(), torch.no_grad():
            for cam in self.ref_cams:
                proj = raster.preprocess(means, scales, quats, opa, shs, cam,
                                         self.cfg["sh_degree"])
                pairs = raster.bin_pairs(proj, cam.width, cam.height,
                                         *self.tile)
                out.append(raster.composite(raster.features(proj), pairs,
                                            cam.width, cam.height,
                                            *self.tile)[0].contiguous())
        return out

    # ------------------------------------------------------------ window --
    def step(self, i):
        self.call(self.first_window_index + i)

    def failures(self):
        """Steps of the window whose loss is not finite or whose duplicate
        count exceeded the budget."""
        if not self.losses:
            return 0
        loss = torch.stack(self.losses)
        dup = torch.stack(self.dups)
        return int((~torch.isfinite(loss) | (dup > self.k_dup)).sum())

    def release(self):
        self.carry.clear()
        self.call = None

    # ------------------------------------------------------------- check --
    def reference(self, dtype=torch.float32, rows=None):
        """The reference's run of the check's steps, from the seed."""
        tr = self.cfg["train"]
        n = len(self.iterations)
        p0 = {k: v.to(dtype) for k, v in inputs.state_leaves(
            self.cfg, self.device, self.seed).items()}
        idx = [i % len(self.ref_cams) for i in range(n)]
        with raster.no_tf32():
            return ref_train.run_steps(
                p0, [self.ref_cams[i] for i in idx],
                [self.gts[i].to(dtype) for i in idx], self.iterations,
                [self.densify_due(it) for it in self.iterations],
                inputs.generator(self.device, self.noise_seed()), self.opt,
                self.cfg["sh_degree"], self.tile, tr["spatial_lr_scale"],
                rows=rows), p0

    def check(self):
        ref, p0 = self.reference()
        w = ref["work"]
        tr, d = self.cfg["train"], self.cfg["sh_degree"]
        self.work = {k: sum(x[k] for x in w) / len(w)
                     for k in ("slots", "passing", "pairs")}
        self.work.update(pixels=tr["width"] * tr["height"],
                         gaussians=self.cfg["gaussians"],
                         param_floats=inputs.param_floats(d),
                         densifies=self.densifies)
        ref_change = {k: float(torch.linalg.vector_norm(
            (ref["params"][k] - p0[k]).double())) for k in p0}
        self.details = {"losses": [self.port_losses, ref["losses"]],
                        "grad_norms": [self.port_grad, ref["grad_norms"]],
                        "change_norms": [self.port_change, ref_change],
                        "relocated": ref["dead"], "k_dup": self.k_dup}
        return compare(self.port_losses, self.port_grad, self.port_change,
                       ref["losses"], ref["grad_norms"], ref_change)


def compare(losses, grads, changes, ref_losses, ref_grads, ref_changes):
    """The numbers the check compares: the largest relative gap of a
    step's loss; of the first gradient's norm, by the worst leaf; and of
    the norm of the parameters' change over the steps, by the worst leaf
    whose reference gradient is not nought to rounding (at least 1e-3 of
    the median leaf's). A leaf's gap is taken against the larger of its
    reference norm and the median leaf's."""
    def gap(a, b, scale):
        return abs(a - b) / max(abs(b), scale) if scale > 0 else math.inf

    def median(d):
        v = sorted(d.values())
        return v[len(v) // 2] if len(v) % 2 else 0.5 * (
            v[len(v) // 2 - 1] + v[len(v) // 2])

    if not all(math.isfinite(x) for x in list(losses) + list(grads.values())
               + list(changes.values())):
        return {"loss_rel": math.inf, "grad_norm_gap": math.inf,
                "change_norm_gap": math.inf}
    g_med, c_med = median(ref_grads), median(ref_changes)
    moved = [k for k in ref_grads if ref_grads[k] >= 1e-3 * g_med]
    return {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                             ref_losses)),
        "grad_norm_gap": max(gap(grads[k], ref_grads[k], g_med)
                             for k in ref_grads),
        "change_norm_gap": max(gap(changes[k], ref_changes[k], c_med)
                               for k in moved)}
