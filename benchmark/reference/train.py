"""Plain PyTorch reference of static 3DGS-MCMC training steps: the
rendered L1 + D-SSIM loss with the opacity and scale regularisers, its
gradients by autograd through ``raster`` (composited in blocks of tiles),
Adam (torch.optim.Adam's update, eps 1e-15), the opacity-gated
covariance noise, and the MCMC relocation of dead Gaussians (Kheradmand
et al. 2024, Eq. 9, with its binomial closed form).

The random draws come from a ``torch.Generator`` seeded as the program's
is, drawn in the order the algorithm needs them: a [C, 3] normal draw for
each step's noise, then, at a densification, one [C] uniform draw for the
relocation templates and one for the growth templates (none grow at the
cap, but the draw is made).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import raster

LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
DEAD_OPACITY = 0.005
N_MAX = 51


def activated(p):
    """(means, scales, unit quats, opacities [P], SH [P, K, 3])."""
    q = p["rotation"]
    q = q / torch.sqrt(torch.clamp((q * q).sum(-1, keepdim=True),
                                   min=1e-24))
    return (p["xyz"], torch.exp(p["scaling"]), q,
            torch.sigmoid(p["opacity"])[:, 0],
            torch.cat([p["f_dc"], p["f_rest"]], 1))


def ssim(img, gt, window: int = 11, sigma: float = 1.5):
    """Mean SSIM of [3, H, W] images: Gaussian window, zero padding."""
    g = torch.tensor([math.exp(-((x - window // 2) ** 2) / (2 * sigma ** 2))
                      for x in range(window)], dtype=img.dtype,
                     device=img.device)
    g = g / g.sum()
    w = (g[:, None] * g[None, :]).expand(3, 1, window, window).contiguous()

    def f(x):
        return F.conv2d(x[None], w, padding=window // 2, groups=3)[0]

    mu1, mu2 = f(img), f(gt)
    s11 = f(img * img) - mu1 * mu1
    s22 = f(gt * gt) - mu2 * mu2
    s12 = f(img * gt) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def image_loss(img, gt, lambda_dssim: float, rows=None):
    """(1 - lambda) L1 + lambda (1 - SSIM). ``rows`` (a fault of the
    check's own test) keeps only the first rows of the image."""
    if rows is not None:
        img, gt = img[:, :rows], gt[:, :rows]
    return ((1.0 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1.0 - ssim(img, gt)))


def loss_and_grads(p, cam, gt, opt, sh_degree: int, tile, work=None,
                   rows=None):
    """(loss, {leaf: gradient}, pair count) of one training view; ``work``
    receives the blend's work counts."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    means, scales, quats, opa, shs = activated(leaves)
    proj = raster.preprocess(means, scales, quats, opa, shs, cam, sh_degree)
    pairs = raster.bin_pairs(proj, cam.width, cam.height, *tile)
    table = raster.features(proj)
    img, _ = raster.composite(table.detach(), pairs, cam.width, cam.height,
                              *tile, work=work)
    img = img.requires_grad_(True)
    loss_img = image_loss(img, gt, opt["lambda_dssim"], rows)
    (d_img,) = torch.autograd.grad(loss_img, img)
    d_table = raster.composite_grad(table, pairs, d_img, *tile)
    reg = (opt["opacity_reg"] * opa.abs().mean()
           + opt["scale_reg"] * scales.abs().mean())
    torch.autograd.backward([table, reg],
                            [d_table.to(table.dtype), torch.ones_like(reg)])
    loss = loss_img.detach() + reg.detach()
    return loss, {k: leaves[k].grad for k in LEAVES}, int(pairs.gauss.shape[0])


def expon_lr(step, lr_init, lr_final, max_steps):
    """The log-linear learning-rate schedule of 3DGS (get_expon_lr_func
    without a delay, as 3DGS-MCMC configures the position's)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def learning_rates(opt, spatial_lr_scale, it):
    xyz = expon_lr(it, opt["position_lr_init"] * spatial_lr_scale,
                   opt["position_lr_final"] * spatial_lr_scale,
                   opt["position_lr_max_steps"])
    return {"xyz": xyz, "f_dc": opt["feature_lr"],
            "f_rest": opt["feature_lr"] / 20.0, "opacity": opt["opacity_lr"],
            "scaling": opt["scaling_lr"], "rotation": opt["rotation_lr"]}


def adam(p, g, m, v, count, lrs, b1=0.9, b2=0.999, eps=1e-15):
    """torch.optim.Adam's update of every leaf; returns new (p, m, v)."""
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    out_p, out_m, out_v = {}, {}, {}
    for k in LEAVES:
        out_m[k] = b1 * m[k] + (1 - b1) * g[k]
        out_v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
        denom = out_v[k].sqrt() / math.sqrt(c2) + eps
        out_p[k] = p[k] - (lrs[k] / c1) * out_m[k] / denom
    return out_p, out_m, out_v


def noise(p, gen, noise_lr, xyz_lr):
    """xyz += Sigma (n * sigmoid(100 ((1 - o) - 0.995)) * noise_lr *
    xyz_lr), n standard normal [C, 3] from ``gen``."""
    _, scales, quats, opa, _ = activated(p)
    n = torch.randn(p["xyz"].shape, generator=gen,
                    device=p["xyz"].device).to(p["xyz"].dtype)
    gate = torch.sigmoid(100.0 * ((1.0 - opa) - 0.995))[:, None]
    n = n * gate * (noise_lr * xyz_lr)
    cov = raster.covariance(scales, quats)
    return dict(p, xyz=p["xyz"] + (cov @ n[:, :, None])[:, :, 0])


def _relocated(opa, scales, n):
    """Eq. 9: opacity and scale of each of n copies of a Gaussian."""
    o = opa.double()
    n = torch.clamp(n, 1, N_MAX - 1)
    o_new = 1.0 - torch.pow(1.0 - o, 1.0 / n.double())
    denom = torch.zeros_like(o)
    for j in range(1, N_MAX):
        binom = torch.tensor([math.comb(int(k), j) for k in range(N_MAX)],
                             dtype=torch.float64, device=o.device)[n]
        denom = denom + (-1) ** (j - 1) * binom * o_new ** j / math.sqrt(j)
    s_new = (o / denom)[:, None] * scales.double()
    eps = torch.finfo(torch.float32).eps
    o_new = torch.clamp(o_new, DEAD_OPACITY, 1.0 - eps)
    return torch.log(o_new / (1 - o_new)), torch.log(s_new)


def relocate(p, m, v, gen):
    """Dead Gaussians (opacity <= 0.005) take the parameters of live ones
    sampled by opacity; a sampled Gaussian and its copies share the
    opacity and scale of Eq. 9; Adam's moments are zeroed at the sampled
    rows. Then the growth step's template draw (nothing grows at the
    cap)."""
    _, scales, _, opa, _ = activated(p)
    c = opa.shape[0]
    dead = opa <= DEAD_OPACITY
    probs = torch.where(dead, torch.zeros_like(opa), opa).double()
    cdf = torch.cumsum(probs, 0)
    u = torch.rand(c, generator=gen, device=opa.device).double()
    t = torch.clamp(torch.searchsorted(cdf, u * cdf[-1], side="left"), 0,
                    c - 1)
    torch.rand(c, generator=gen, device=opa.device)  # growth's draw
    td = t[dead]
    counts = torch.bincount(td, minlength=c)
    sampled = counts > 0
    o_raw, s_raw = _relocated(opa[td], scales[td], counts[td] + 1)
    dt = p["xyz"].dtype
    new = {k: x.clone() for k, x in p.items()}
    for k in LEAVES:
        new[k][dead] = p[k][td]
    new["opacity"][dead] = o_raw.to(dt)[:, None]
    new["scaling"][dead] = s_raw.to(dt)
    new["opacity"][td] = o_raw.to(dt)[:, None]
    new["scaling"][td] = s_raw.to(dt)
    zero = {k: torch.where(sampled.reshape((-1,) + (1,) * (x.dim() - 1)),
                           torch.zeros_like(x), x) for k, x in m.items()}
    zero_v = {k: torch.where(sampled.reshape((-1,) + (1,) * (x.dim() - 1)),
                             torch.zeros_like(x), x) for k, x in v.items()}
    return new, zero, zero_v, int(dead.sum())


def run_steps(p0, cams, gts, iterations, densify, gen, opt, sh_degree,
              tile, spatial_lr_scale, rows=None):
    """Steps ``iterations`` (camera i of ``cams`` / ``gts`` at step i) from
    the leaves ``p0``; a densification after the steps whose ``densify``
    flag is set. Returns dict(losses, grad_norms (the first step's, per
    leaf), params (after the last step), work (per step), dead (rows
    relocated))."""
    p = {k: p0[k] for k in LEAVES}
    m = {k: torch.zeros_like(x) for k, x in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, works, grad_norms, dead = [], [], None, []
    for i, it in enumerate(iterations):
        work = {}
        loss, g, pairs = loss_and_grads(p, cams[i], gts[i], opt, sh_degree,
                                        tile, work, rows)
        work["pairs"] = pairs
        works.append(work)
        losses.append(float(loss))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(g[k].double()))
                          for k in LEAVES}
        lrs = learning_rates(opt, spatial_lr_scale, it)
        with torch.no_grad():
            p, m, v = adam(p, g, m, v, i + 1, lrs)
            noise_lr = opt["noise_lr"] * float(it < opt["iterations"])
            p = noise(p, gen, noise_lr, lrs["xyz"])
            if densify[i]:
                p, m, v, n_dead = relocate(p, m, v, gen)
                dead.append(n_dead)
    return dict(losses=losses, grad_norms=grad_norms, params=p, work=works,
                dead=dead)
