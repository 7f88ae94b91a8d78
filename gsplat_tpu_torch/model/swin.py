"""Sliding-window (SwinGS) Gaussian model: lifespans, rigid motion,
mature/rollover, frame-indexed union (port of gsplat_tpu/model/swin.py).

As in the JAX package (the reference SwinGaussianModel,
scene/gaussian_model.py:37-962), every size is fixed:

- the immature pool is a ``GaussianState`` (alive prefix, capacity C)
  extended with rigid-motion parameters and lifespans;
- the matured pool is a frozen ring of ``buffer_size`` rows;
- frame-indexed access renders the union of both pools (C + B rows) with an
  activity mask (frame_start <= f < frame_end) and rigid deformation by
  age;
- per-birth-frame relocation is a loop over the window's frames with one
  masked template draw per frame.

``n_alive`` and ``m_count`` are host ints (the host decides growth and
maturing). Randomness comes from an explicit ``torch.Generator``; the tests
hold the port against JAX by feeding both the same template draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsplat_tpu_torch import get_device
from gsplat_tpu_torch.core.covariance import covariance_6
from gsplat_tpu_torch.core.quaternion import normalize, rigid_deform
from gsplat_tpu_torch.model import gaussians, mcmc, optim
from gsplat_tpu_torch.model.gaussians import GaussianState
from gsplat_tpu_torch.utils import checkpoint as ckpt_lib

RIGID_KEYS = ("rigid_v", "rigid_rotvec", "rigid_rotcen")
# the matured ring's leaves, each the copy of an immature leaf
RING_KEYS = ("m_xyz", "m_features_dc", "m_features_rest", "m_scaling",
             "m_rotation", "m_opacity", "m_rigid_v", "m_rigid_rotvec",
             "m_rigid_rotcen", "m_frame_birth", "m_frame_start",
             "m_frame_end")


@dataclasses.dataclass(frozen=True)
class SwinState:
    """Immature (trainable) + matured (frozen ring) pools, all on one
    device."""

    im: GaussianState           # immature pool, capacity C
    rigid_v: torch.Tensor       # [C, 3]
    rigid_rotvec: torch.Tensor  # [C, 3]
    rigid_rotcen: torch.Tensor  # [C, 3]
    frame_birth: torch.Tensor   # [C] f32
    frame_start: torch.Tensor   # [C] f32
    frame_end: torch.Tensor     # [C] f32

    # matured ring buffer, capacity B
    m_xyz: torch.Tensor
    m_features_dc: torch.Tensor
    m_features_rest: torch.Tensor
    m_scaling: torch.Tensor
    m_rotation: torch.Tensor
    m_opacity: torch.Tensor
    m_rigid_v: torch.Tensor
    m_rigid_rotvec: torch.Tensor
    m_rigid_rotcen: torch.Tensor
    m_frame_birth: torch.Tensor
    m_frame_start: torch.Tensor
    m_frame_end: torch.Tensor
    m_count: int                # total ever matured

    max_lifespan: int           # == swin_size
    deform: bool

    @property
    def capacity(self) -> int:
        return self.im.capacity

    @property
    def buffer_size(self) -> int:
        return self.m_xyz.shape[0]

    def params(self) -> dict[str, torch.Tensor]:
        """The trainable leaves: the reference's nine optimizer groups
        (gaussian_model.py:304-314)."""
        p = self.im.params()
        for k in RIGID_KEYS:
            p[k] = getattr(self, k)
        return p

    def replace_params(self, p: dict[str, torch.Tensor]) -> "SwinState":
        return dataclasses.replace(
            self, im=self.im.replace_params(p),
            **{k: p[k] for k in RIGID_KEYS})

    def matured_valid(self) -> torch.Tensor:
        b = self.buffer_size
        return (torch.arange(b, device=self.m_xyz.device)
                < min(self.m_count, b))


def _immature_leaves(state: SwinState) -> dict[str, torch.Tensor]:
    """The immature leaves the ring copies, keyed by their ring name."""
    im = state.im
    return {"m_xyz": im.xyz, "m_features_dc": im.features_dc,
            "m_features_rest": im.features_rest, "m_scaling": im.scaling,
            "m_rotation": im.rotation, "m_opacity": im.opacity,
            "m_rigid_v": state.rigid_v, "m_rigid_rotvec": state.rigid_rotvec,
            "m_rigid_rotcen": state.rigid_rotcen,
            "m_frame_birth": state.frame_birth,
            "m_frame_start": state.frame_start,
            "m_frame_end": state.frame_end}


def create_from_points(points, colors, capacity: int, max_sh_degree: int,
                       max_lifespan: int, buffer_size: int, deform: bool,
                       mean_sq_dist=None,
                       device: str | torch.device = "cuda") -> SwinState:
    """Init as SwinGaussianModel.create_from_pcd (gaussian_model.py:
    253-294): the static init, rigid_rotvec (1e-10, 0, 0) (non-degenerate),
    rotcen at the own position, a full first lifespan."""
    device = get_device(device)
    im = gaussians.create_from_points(points, colors, capacity,
                                      max_sh_degree,
                                      mean_sq_dist=mean_sq_dist,
                                      device=device)
    n = points.shape[0]
    c, b = capacity, buffer_size
    k = (max_sh_degree + 1) ** 2
    rotvec = np.zeros((n, 3), np.float32)
    rotvec[:, 0] = 1e-10

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    ring = {"m_xyz": zeros(b, 3), "m_features_dc": zeros(b, 1, 3),
            "m_features_rest": zeros(b, k - 1, 3), "m_scaling": zeros(b, 3),
            "m_rotation": zeros(b, 4), "m_opacity": zeros(b, 1),
            "m_rigid_v": zeros(b, 3), "m_rigid_rotvec": zeros(b, 3),
            "m_rigid_rotcen": zeros(b, 3), "m_frame_birth": zeros(b),
            "m_frame_start": zeros(b), "m_frame_end": zeros(b)}
    return SwinState(
        im=im, rigid_v=zeros(c, 3),
        rigid_rotvec=torch.as_tensor(gaussians._pad(rotvec, c),
                                     device=device),
        rigid_rotcen=im.xyz.clone(),
        frame_birth=zeros(c), frame_start=zeros(c),
        frame_end=torch.where(im.alive_mask, float(max_lifespan), 0.0),
        **ring, m_count=0, max_lifespan=max_lifespan, deform=deform)


def swin_state_from_numpy(leaves: dict[str, np.ndarray], n_alive: int,
                          m_count: int, max_sh_degree: int,
                          max_lifespan: int, deform: bool,
                          device: str | torch.device = "cuda",
                          adam: tuple | None = None):
    """SwinState from numpy leaves: a JAX SwinState's leaves as numpy,
    keyed as ``SwinState.params()`` (the nine trainable groups) plus
    ``frame_birth``/``frame_start``/``frame_end`` and every ``m_*`` ring
    leaf. With ``adam`` = (mu, nu, count), the nine-group moments as numpy
    dicts and the step count, returns (state, ``optim.AdamState``)."""
    device = get_device(device)
    im = gaussians.state_from_numpy(leaves, n_alive, max_sh_degree, device)
    t = {k: torch.as_tensor(np.ascontiguousarray(leaves[k], np.float32),
                            device=device)
         for k in RIGID_KEYS + ("frame_birth", "frame_start", "frame_end")
         + RING_KEYS}
    state = SwinState(im=im, **t, m_count=int(m_count),
                      max_lifespan=max_lifespan, deform=deform)
    if adam is None:
        return state
    mu, nu, count = adam

    def group(tree):
        return {k: torch.as_tensor(np.ascontiguousarray(tree[k], np.float32),
                                   device=device)
                for k in gaussians.PARAM_KEYS + RIGID_KEYS}

    return state, optim.AdamState(mu=group(mu), nu=group(nu),
                                  count=int(count))


def union_params_at(state: SwinState, frame: float) -> dict:
    """Deformed, activated parameters of the immature + matured union at
    ``frame`` (the fixed-size form of get_basic_para_at,
    gaussian_model.py:597-649): keyword arguments for rasterize()."""
    im = state.im
    cat = torch.cat
    xyz = cat([im.xyz, state.m_xyz])
    rot = cat([im.rotation, state.m_rotation])
    v = cat([state.rigid_v, state.m_rigid_v])
    rotvec = cat([state.rigid_rotvec, state.m_rigid_rotvec])
    rotcen = cat([state.rigid_rotcen, state.m_rigid_rotcen])
    start = cat([state.frame_start, state.m_frame_start])
    end = cat([state.frame_end, state.m_frame_end])
    valid = cat([im.alive_mask, state.matured_valid()])

    active = valid & (start <= frame) & (end > frame)
    age = frame - start
    mode = "screw" if state.deform else "skip"
    xyz_d, rot_d = rigid_deform(xyz, rot, v, rotvec, rotcen, age, mode=mode)

    scaling = torch.exp(cat([im.scaling, state.m_scaling]))
    opacity = torch.sigmoid(cat([im.opacity, state.m_opacity])[:, 0])
    shs = cat([cat([im.features_dc, im.features_rest], dim=1),
               cat([state.m_features_dc, state.m_features_rest], dim=1)])
    return dict(means3d=xyz_d, scales=scaling, quats=normalize(rot_d),
                opacities=opacity, shs=shs, alive=active)


class WindowUnion:
    """The union of a ``SwinState`` in a forward-only form for drawing its
    window's frames: ``union_params_at``'s values with the columns that
    no frame changes built once.

    At construction: the union's raw positions and rotations, rigid
    parameters, ``start`` / ``end``, the valid mask, the activated scales
    (exp), opacities (sigmoid) and SH; on the host, the sorted starts and
    ends of the rows that can live (valid, start < end), so ``live_rows``
    counts the rows live at a frame without reading the device. Each
    frame (``rows``): the age, the rigid motion (screw with ``deform``,
    none without), the unit quaternion and the live mask."""

    def __init__(self, state: SwinState):
        im = state.im
        cat = torch.cat
        self.deform = state.deform
        self.sh_degree = im.max_sh_degree
        self.xyz = cat([im.xyz, state.m_xyz])
        self.rotation = cat([im.rotation, state.m_rotation])
        self.rigid = tuple(cat([getattr(state, k), getattr(state, "m_" + k)])
                           for k in RIGID_KEYS)
        self.start = cat([state.frame_start, state.m_frame_start])
        self.end = cat([state.frame_end, state.m_frame_end])
        self.valid = cat([im.alive_mask, state.matured_valid()])
        self.scales = torch.exp(cat([im.scaling, state.m_scaling]))
        self.opacities = torch.sigmoid(cat([im.opacity,
                                            state.m_opacity])[:, 0])
        self.shs = cat([cat([im.features_dc, im.features_rest], dim=1),
                        cat([state.m_features_dc, state.m_features_rest],
                            dim=1)])
        start = self.start.cpu().numpy()
        end = self.end.cpu().numpy()
        can = self.valid.cpu().numpy() & (start < end)
        self._starts = np.sort(start[can])
        self._ends = np.sort(end[can])

    @property
    def n_rows(self) -> int:
        return self.xyz.shape[0]

    def rows(self, frame):
        """(means3d, scales, quats, opacities, shs, alive) at ``frame``, a
        float or a 0-d float32 tensor on the union's device: the values
        of ``union_params_at`` (``render_frame``'s row arguments)."""
        age = frame - self.start
        mode = "screw" if self.deform else "skip"
        xyz, rot = rigid_deform(self.xyz, self.rotation, *self.rigid, age,
                                mode=mode)
        alive = self.valid & (self.start <= frame) & (self.end > frame)
        return xyz, self.scales, normalize(rot), self.opacities, self.shs, \
            alive

    def live_rows(self, frame: float) -> int:
        """How many rows are live at ``frame`` (valid, start <= frame <
        end), compared in float32 as on the device; host only."""
        f = np.float32(frame)
        return int(np.searchsorted(self._starts, f, side="right")
                   - np.searchsorted(self._ends, f, side="right"))


def load_window(path: str, device: str | torch.device = "cuda"):
    """(SwinState, window) from the trainer's checkpoint
    ``chkpnt_<frame_start>_<it>.npz`` (``utils/checkpoint.save_pytree`` of
    {"state", "adam"}), without a scene: the state's leaves on ``device``,
    Adam's left unread. The static fields come from the file: the SH
    degree from ``features_rest``'s width, ``max_lifespan`` from the
    window, ``deform`` (the trainer's ``--deform``) from the meta.
    ``window`` is the trainer's window record (``frame_start``,
    ``frame_end``, ``max_frame``, ...)."""
    device = get_device(device)

    def empty():
        return torch.empty(0, device=device)

    im = GaussianState(**{f: empty() for f in ckpt_lib.STATE_LEAVES},
                       n_alive=0, max_sh_degree=0)
    fields = [f.name for f in dataclasses.fields(SwinState)
              if f.name not in ("im", "m_count", "max_lifespan", "deform")]
    template = SwinState(im=im, **{f: empty() for f in fields}, m_count=0,
                         max_lifespan=0, deform=False)
    tree, meta = ckpt_lib.load_pytree(path, {"state": template})
    if "deform" not in meta:
        raise ValueError(f"{path}: the checkpoint does not record whether "
                         "it was trained with --deform")
    state, window = tree["state"], meta["swin"]
    k = state.im.features_rest.shape[1] + 1
    sh = int(round(k ** 0.5)) - 1
    if (sh + 1) ** 2 != k:
        raise ValueError(f"{path}: features_rest holds {k - 1} bands, not "
                         f"(sh + 1)^2 - 1 for any SH degree")
    return dataclasses.replace(
        state, im=dataclasses.replace(state.im, max_sh_degree=sh),
        max_lifespan=int(window["frame_end"] - window["frame_start"]),
        deform=bool(meta["deform"])), window


def active_immature_mask(state: SwinState, frame: float) -> torch.Tensor:
    return (state.im.alive_mask & (state.frame_start <= frame)
            & (state.frame_end > frame))


@torch.no_grad()
def decay_genesis(state: SwinState) -> SwinState:
    """Stagger the first lifespans by opacity rank (gaussian_model.py:
    439-455): sorted by opacity, descending, group i of max_lifespan groups
    gets frame_end -= i. The sort is stable, as jnp.argsort is, so ties
    (the padding rows at -inf among them) keep their row order."""
    c = state.capacity
    alive = state.im.alive_mask
    n = state.im.n_alive
    opa = torch.where(alive, state.im.opacity[:, 0],
                      torch.full_like(state.im.opacity[:, 0], -np.inf))
    order = torch.argsort(-opa, stable=True)   # descending; padding last
    rank = torch.empty(c, dtype=torch.int64, device=opa.device)
    rank[order] = torch.arange(c, device=opa.device)
    group = (rank * state.max_lifespan) // max(n, 1)
    new_end = state.frame_end - torch.where(
        alive, group.to(torch.float32), torch.zeros_like(state.frame_end))
    return dataclasses.replace(state, frame_end=new_end)


def mature_mask(state: SwinState, window_end: float) -> torch.Tensor:
    """Immature rows that cannot fill the next window (evolve,
    gaussian_model.py:539)."""
    return state.im.alive_mask & (state.frame_end < window_end)


def extract_rows_host(state: SwinState, mask) -> dict:
    """Host copies of the masked immature rows, for stream_dump (the CPU
    copy of _mature, gaussian_model.py:497-503)."""
    idx = torch.nonzero(torch.as_tensor(mask, device=state.im.device)
                        )[:, 0]

    def host(t):
        return t.index_select(0, idx).detach().cpu().numpy()

    im = state.im
    return {"start_frame": host(state.frame_start),
            "end_frame": host(state.frame_end),
            "birth_frame": host(state.frame_birth), "xyz": host(im.xyz),
            "f_dc": host(im.features_dc), "f_rest": host(im.features_rest),
            "scaling": host(im.scaling), "rotation": host(im.rotation),
            "opacity": host(im.opacity)}


@torch.no_grad()
def mature_and_rollover(state: SwinState, adam: optim.AdamState, mask):
    """The device half of evolve (gaussian_model.py:474-528):

    1. copy the masked immature rows into the matured ring, the i-th masked
       row to ring position (m_count + i) % B;
    2. roll the same rows over in place: with ``deform``, xyz and rotation
       move to their end-of-life pose and both Adam moments are zeroed at
       the rolled rows (the replace_tensors call, :524); the lifespan
       becomes [end, end + max_lifespan).

    JAX scatters every row with ``mode="drop"`` for the unmasked ones;
    here only the masked rows are indexed. When more than B rows mature at
    once, the last B of them stay in the ring, as with JAX's in-order
    writes."""
    b = state.buffer_size
    idx = torch.nonzero(mask)[:, 0]
    n_new = int(idx.shape[0])
    keep = idx[max(n_new - b, 0):]
    pos = (state.m_count + torch.arange(max(n_new - b, 0), n_new,
                                        device=idx.device)) % b
    ring = {}
    for key, leaf in _immature_leaves(state).items():
        r = getattr(state, key).clone()
        r[pos] = leaf.index_select(0, keep)
        ring[key] = r

    im = state.im
    new_xyz, new_rot = im.xyz, im.rotation
    if state.deform:
        lifespan = state.frame_end - state.frame_start + 1.0
        xyz_d, rot_d = rigid_deform(im.xyz, im.rotation, state.rigid_v,
                                    state.rigid_rotvec, state.rigid_rotcen,
                                    lifespan, mode="screw")
        new_xyz = torch.where(mask[:, None], xyz_d, im.xyz)
        new_rot = torch.where(mask[:, None], rot_d, im.rotation)
        adam = optim.zero_moments_at(adam, mask)

    new_state = dataclasses.replace(
        state, im=dataclasses.replace(im, xyz=new_xyz, rotation=new_rot),
        frame_birth=torch.where(mask, state.frame_end, state.frame_birth),
        frame_start=torch.where(mask, state.frame_end, state.frame_start),
        frame_end=torch.where(mask, state.frame_end + state.max_lifespan,
                              state.frame_end),
        m_count=state.m_count + n_new, **ring)
    return new_state, adam


def _take_rows(leaf, row_mask, src, t):
    """``leaf`` with the rows of ``row_mask`` replaced by ``src[t]``."""
    m = row_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(m, src[t], leaf)


@torch.no_grad()
def relocate_immature(state: SwinState, adam: optim.AdamState,
                      gen: torch.Generator | None, window_start: float, *,
                      window_size: int, dead_opacity: float = 0.005):
    """Per-birth-frame relocation (relocate_gs_immuture,
    gaussian_model.py:911-962): for each frame f of the window, the dead
    rows born at f teleport onto opacity-sampled templates born at >= f
    and inherit the template's rigid parameters and frame_start. One
    masked template draw per frame (``mcmc._sample_templates``); no host
    synchronisation."""
    im = state.im
    c = state.capacity
    alive = im.alive_mask
    opa = im.get_opacity()[:, 0]
    zero = torch.zeros_like(opa)

    tmpl = torch.zeros(c, dtype=torch.int64, device=opa.device)
    dead_any = torch.zeros(c, dtype=torch.bool, device=opa.device)
    for k in range(window_size):
        f = window_start + float(k)
        dead_f = alive & (opa <= dead_opacity) & (state.frame_birth == f)
        src_f = alive & (opa > dead_opacity) & (state.frame_birth >= f)
        probs = torch.where(src_f, opa, zero)
        any_src = (probs > 0).any()
        safe_probs = torch.where(any_src, probs, alive.to(opa.dtype))
        t_f = mcmc._sample_templates(gen, safe_probs, c).long()
        use = dead_f & any_src
        tmpl = torch.where(use, t_f, tmpl)
        dead_any = dead_any | use

    counts = torch.zeros(c, dtype=torch.int64, device=opa.device).index_add_(
        0, tmpl, dead_any.long())
    o_raw, s_raw = mcmc._relocated_raw(im, tmpl, counts[tmpl] + 1)
    new_im, template_mask = mcmc._clone_rows(im, dead_any, tmpl, o_raw,
                                             s_raw)
    new_state = dataclasses.replace(
        state, im=new_im,
        **{k: _take_rows(getattr(state, k), dead_any, getattr(state, k),
                         tmpl) for k in RIGID_KEYS},
        frame_start=torch.where(dead_any, state.frame_start[tmpl],
                                state.frame_start))
    return new_state, optim.zero_moments_at(adam, template_mask)


@torch.no_grad()
def add_new_gs(state: SwinState, adam: optim.AdamState,
               gen: torch.Generator | None, cap_max: int | None = None,
               growth: float = 1.05):
    """Genesis-only +5% growth (gaussian_model.py:854-909): the new rows
    clone opacity-sampled templates (opacity > 0.005) with their rigid
    parameters and lifespans."""
    im = state.im
    c = state.capacity
    cap = c if cap_max is None else min(cap_max, c)
    n = im.n_alive
    target = max(min(cap, int(np.float32(growth) * np.float32(n))), n)
    rows = torch.arange(c, device=im.device)
    new_mask = (rows >= n) & (rows < target)

    opa = im.get_opacity()[:, 0]
    probs = torch.where(im.alive_mask & (opa > 0.005), opa,
                        torch.zeros_like(opa))
    probs = torch.where((probs > 0).any(), probs,
                        im.alive_mask.to(opa.dtype))
    t = mcmc._sample_templates(gen, probs, c).long()
    counts = torch.zeros(c, dtype=torch.int64, device=im.device).index_add_(
        0, t, new_mask.long())
    o_raw, s_raw = mcmc._relocated_raw(im, t, counts[t] + 1)
    new_im, template_mask = mcmc._clone_rows(im, new_mask, t, o_raw, s_raw)
    new_im = dataclasses.replace(new_im, n_alive=target)
    copied = RIGID_KEYS + ("frame_birth", "frame_start", "frame_end")
    new_state = dataclasses.replace(
        state, im=new_im,
        **{k: _take_rows(getattr(state, k), new_mask, getattr(state, k), t)
           for k in copied})
    return new_state, optim.zero_moments_at(adam, template_mask | new_mask)


@torch.no_grad()
def inject_noise_active(state: SwinState, gen: torch.Generator | None,
                        noise_lr: float, xyz_lr: float, frame: float,
                        raw_noise=None) -> SwinState:
    """Covariance-shaped, opacity-gated noise on the ACTIVE immature rows
    only (train_swin.py:244-261). ``raw_noise`` ([C, 3] standard normal)
    replaces the generator's draw."""
    im = state.im
    active = active_immature_mask(state, frame)
    opa = im.get_opacity()
    gate = torch.sigmoid(100.0 * ((1.0 - opa) - 0.995))
    raw = (torch.randn(im.xyz.shape, generator=gen, device=im.device)
           if raw_noise is None else raw_noise)
    noise = raw * gate * noise_lr * xyz_lr
    xx, xy, xz, yy, yz, zz = covariance_6(im.get_scaling(),
                                          im.get_rotation()).unbind(-1)
    nx, ny, nz = noise.unbind(-1)
    noise = torch.stack([xx * nx + xy * ny + xz * nz,
                         xy * nx + yy * ny + yz * nz,
                         xz * nx + yz * ny + zz * nz], dim=-1)
    noise = torch.where(active[:, None], noise, torch.zeros_like(noise))
    return dataclasses.replace(state, im=dataclasses.replace(
        im, xyz=im.xyz + noise))
