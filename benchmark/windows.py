"""A SwinGS model at one window, made from the seed as the sliding-window
trainer holds it there with ``--deform``, and the benchmark's own writer
of the trainer's checkpoint. Plain NumPy and PyTorch; the program under
test reads the file, the reference takes the union's columns.

The trainer (NeutrinoLiu/3dgs-mcmc ``train_swin.py``,
``scene/gaussian_model.py``) keeps ``cap`` immature rows and a ring of
the last ``buffer_size`` matured ones. After the genesis window every
row has the lifespan [0, L), L = ``swin_size``, its end staggered by
opacity rank (``decay_genesis``: group i of L, descending opacity, ends
at L - i). At each later window end W (from L + 1) the rows whose end is
below W mature: they are copied into the ring, the i-th of them to slot
(m_count + i) % B, then roll over to [end, end + L), moved to their
end-of-life pose by the rigid motion over end - start + 1 frames
(``mature_and_rollover``: the screw motion of ``reference/window.py``;
the rigid parameters themselves do not change). The matured rows come
in the order of ``streams.emit_order``. At window [w, w + L), after its
maturation, a row's immature generation ends in [w + L, w + 2L) and, for
w >= L, the ring holds each row's generation before it, so exactly
``cap`` rows live at every frame of the window, each identity once.

Here a row keeps its drawn leaves (``inputs.state_leaves``: positions,
colours, opacities and scales, identity rotations) in every generation,
apart from the pose the rollovers move. Its rigid parameters are drawn
from the seed: ``rigid_v`` N(0, v_std^2) and ``rigid_rotvec`` N(0,
rotvec_std^2) a coordinate (a frame's worth), ``rigid_rotcen`` its
position plus N(0, rotcen_std^2).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import inputs, streams
from benchmark.reference import window as ref_window

# the immature pool's leaves and the ring's, in the trainer's checkpoint
# (the JAX keystr of each leaf of {"adam": AdamState, "state": SwinState},
# as utils/checkpoint.flatten_with_keys writes them)
IM_LEAVES = {"xyz": "im.xyz", "f_dc": "im.features_dc",
             "f_rest": "im.features_rest", "scaling": "im.scaling",
             "rotation": "im.rotation", "opacity": "im.opacity"}
RIGID = ("rigid_v", "rigid_rotvec", "rigid_rotcen")
LIFE = ("frame_birth", "frame_start", "frame_end")
ADAM_GROUPS = ("f_dc", "f_rest", "opacity", "rigid_rotcen", "rigid_rotvec",
               "rigid_v", "rotation", "scaling", "xyz")


def _normal(device, seed, sub, shape, std):
    s = int(np.random.SeedSequence([int(seed), sub]).generate_state(
        1, np.uint64)[0])
    return std * torch.randn(shape, device=device,
                             generator=inputs.generator(device, s))


def genesis(cfg: dict, device, seed: int):
    """(leaves, rigid, end0): each row's drawn leaves (``inputs.state_leaves``
    at ``cap_max`` rows), its rigid parameters keyed by ``RIGID``, and its
    genesis end in 1..L by opacity rank (``decay_genesis``)."""
    cap, life, rig = cfg["cap_max"], cfg["swin_size"], cfg["rigid"]
    p = inputs.state_leaves(dict(cfg, gaussians=cap), device, seed)
    rigid = {"rigid_v": _normal(device, seed, 3, (cap, 3), rig["v_std"]),
             "rigid_rotvec": _normal(device, seed, 4, (cap, 3),
                                     rig["rotvec_std"])}
    rigid["rigid_rotcen"] = p["xyz"] + _normal(device, seed, 5, (cap, 3),
                                               rig["rotcen_std"])
    # by opacity, descending (stable), group i ends at L - i
    order = torch.argsort(-p["opacity"][:, 0], stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(cap, device=order.device)
    return p, rigid, life - (rank * life) // cap


def window_state(cfg: dict, device, seed: int) -> dict:
    """The trainer's state at window [w, w + L), w = ``window_start`` >= 1:
    ``im`` and ``ring``, each a dict of columns keyed by ``LEAVES``,
    ``RIGID``, ``frame_birth`` / ``frame_start`` / ``frame_end`` (float32)
    and ``identity`` (the row, int64); ``m_count``, the rows ever
    matured."""
    cap, life, w = cfg["cap_max"], cfg["swin_size"], cfg["window_start"]
    b = cfg["buffer_size"]
    if w < 1:
        raise ValueError(f"window_start ({w}) must follow the genesis "
                         "window")
    p, rigid, end0 = genesis(cfg, device, seed)
    # every row matured up to window end w + L, in order; the ring keeps
    # the last b, the i-th matured row at slot i % b
    j, g = streams.emit_order(end0, life, w + life)
    j, g = j[:-cap], g[:-cap]           # not the final mature_rest
    m_count = int(j.shape[0])
    if m_count < b:
        raise ValueError(f"buffer_size ({b}) exceeds the {m_count} rows "
                         "matured by the window")
    keep = torch.arange(m_count - b, m_count, device=j.device)
    slot = keep % b
    ring_row = torch.empty(b, dtype=torch.long, device=j.device)
    ring_gen = torch.empty(b, dtype=torch.long, device=j.device)
    ring_row[slot], ring_gen[slot] = j[keep], g[keep]
    # the immature generation: the first whose end reaches w + L
    im_gen = torch.div(w + life - end0 + life - 1, life,
                       rounding_mode="floor")

    def lifespan(row, gen):
        end = end0.index_select(0, row) + life * gen
        start = torch.where(gen > 0, end - life, torch.zeros_like(end))
        return start.float(), end.float()

    rows = torch.arange(cap, device=end0.device)
    im = {"identity": rows, **{k: v.clone() for k, v in p.items()},
          **rigid}
    ring = {"identity": ring_row,
            **{k: v.index_select(0, ring_row) for k, v in p.items()},
            **{k: v.index_select(0, ring_row) for k, v in rigid.items()}}
    # the poses: generation 0 drawn, each rollover moves a row on
    xyz, rot = p["xyz"], p["rotation"]
    for gen in range(int(max(im_gen.max(), ring_gen.max())) + 1):
        at = im_gen == gen
        im["xyz"][at], im["rotation"][at] = xyz[at], rot[at]
        at = ring_gen == gen
        ring["xyz"][at] = xyz.index_select(0, ring_row[at])
        ring["rotation"][at] = rot.index_select(0, ring_row[at])
        if cfg["deform"]:
            span = (end0 if gen == 0 else torch.full_like(end0, life))
            xyz, rot = ref_window.screw(xyz, rot, *(rigid[k] for k in RIGID),
                                        span.float() + 1.0)
    for part, row, gen in ((im, rows, im_gen), (ring, ring_row, ring_gen)):
        start, end = lifespan(row, gen)
        part.update(frame_birth=start, frame_start=start, frame_end=end)
    return {"im": im, "ring": ring, "m_count": m_count}


def union(state: dict) -> dict:
    """The union's columns (immature rows first, then the ring's slots),
    as ``reference/window.py`` takes them: the raw leaves, ``RIGID``,
    ``start``, ``end``, ``valid`` (every row: the pool is full and the
    ring written through) and ``identity``."""
    im, ring = state["im"], state["ring"]
    out = {k: torch.cat([im[k], ring[k]]) for k in
           ref_window.LEAVES + RIGID + ("identity",)}
    out["start"] = torch.cat([im["frame_start"], ring["frame_start"]])
    out["end"] = torch.cat([im["frame_end"], ring["frame_end"]])
    out["valid"] = torch.ones_like(out["start"], dtype=torch.bool)
    return out


def write_checkpoint(state: dict, path: str, cfg: dict,
                     iteration: int) -> None:
    """The trainer's ``chkpnt_<w>_<iteration>.npz`` of ``state``: every
    leaf of {"adam", "state"} under its keystr (Adam's moments zero, its
    count ``iteration``), the host ints as int32, and the ``__meta__``
    JSON with the iteration, the window record and ``deform``, written
    with NumPy."""
    im, ring = state["im"], state["ring"]
    cap = im["xyz"].shape[0]

    def host(t):
        return t.detach().cpu().numpy()

    arrays = {}
    shapes = {"f_dc": im["f_dc"].shape, "f_rest": im["f_rest"].shape,
              "opacity": (cap, 1), "rotation": (cap, 4)}
    for moment in ("mu", "nu"):
        for g in ADAM_GROUPS:
            arrays[f"['adam'].{moment}[{g!r}]"] = np.zeros(
                shapes.get(g, (cap, 3)), np.float32)
    arrays["['adam'].count"] = np.asarray(iteration, np.int32)
    for k, leaf in IM_LEAVES.items():
        arrays[f"['state'].{leaf}"] = host(im[k])
    arrays["['state'].im.n_alive"] = np.asarray(cap, np.int32)
    for k in RIGID + LIFE:
        arrays[f"['state'].{k}"] = host(im[k])
    for k, leaf in IM_LEAVES.items():
        arrays[f"['state'].m_{leaf[3:]}"] = host(ring[k])
    for k in RIGID + LIFE:
        arrays[f"['state'].m_{k}"] = host(ring[k])
    arrays["['state'].m_count"] = np.asarray(state["m_count"], np.int32)
    w, life = cfg["window_start"], cfg["swin_size"]
    meta = {"iteration": iteration, "deform": bool(cfg["deform"]),
            "swin": {"frame_start": w, "frame_end": w + life,
                     "max_frame": cfg["frames"], "_sampled_frames": None}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **arrays)
