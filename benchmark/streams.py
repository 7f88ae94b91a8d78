"""A SwinGS stream (``streamable.dat``) made from the seed, as the
sliding-window trainer writes one, and the benchmark's own writer of the
record format. Plain NumPy and PyTorch; the program under test reads the
file, the reference takes the columns.

The trainer (NeutrinoLiu/3dgs-mcmc ``train_swin.py``,
``scene/gaussian_model.py``) keeps ``cap`` rows alive. After the genesis
window every row has the lifespan [0, L), L = ``swin_size``, and
``decay_genesis`` staggers the ends by opacity rank: group i of L
(descending opacity) ends at L - i. Each later window ending at frame W
matures the rows whose end is below W: they are appended to the stream,
then roll over to [end, end + L). The first of these (W = L + 1)
matures every genesis row; each later one the cap / L rows whose end is
W - 1. After the last window (W = frames), ``mature_rest`` appends every
row still alive. So a stream of F frames holds cap / L x (F + L - 1)
records, and each row is live in exactly one record at every frame.

Here a row keeps its drawn leaves (``inputs.state_leaves``) in every
record, its position moved by a per-row drift drawn from the seed each
time it rolls over.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import inputs


def record_dtype(sh_degree: int) -> np.dtype:
    """One record (``utils/stream_utils.py:11-82`` of the trainer):
    network-endian start_frame u32, end_frame u32, xyz 3f, f_dc 3f, f_rest
    3f x ((sh + 1)^2 - 1), scaling 3f, rotation 4f, opacity f."""
    k_rest = (sh_degree + 1) ** 2 - 1
    return np.dtype([("start_frame", ">u4"), ("end_frame", ">u4"),
                     ("xyz", ">f4", (3,)), ("f_dc", ">f4", (3,)),
                     ("f_rest", ">f4", (3 * k_rest,)),
                     ("scaling", ">f4", (3,)), ("rotation", ">f4", (4,)),
                     ("opacity", ">f4")])


def format_json(sh_degree: int) -> dict:
    """The ``format.json`` sidecar: each field's struct codes."""
    return {"start_frame": "I", "end_frame": "I", "xyz": "fff",
            "f_dc": "fff", "f_rest": "fff" * ((sh_degree + 1) ** 2 - 1),
            "scaling": "fff", "rotation": "ffff", "opacity": "f",
            "ENDIAN": "!"}


def emit_order(end0: torch.Tensor, life: int, frames: int):
    """(row, generation) of every record in the order the trainer appends
    them, from the genesis ends ``end0`` [cap] in 1..L."""
    if frames <= life:
        raise ValueError(f"frames ({frames}) must exceed swin_size ({life})")
    cap, dev = end0.shape[0], end0.device
    rows = torch.arange(cap, device=dev)
    group = [torch.nonzero(end0 == e)[:, 0] for e in range(1, life + 1)]
    idx, gen = [rows], [torch.zeros(cap, dtype=torch.long, device=dev)]
    for end in range(life + 1, frames):      # matured at window end + 1
        e0 = (end - 1) % life + 1
        j = group[e0 - 1]
        idx.append(j)
        gen.append(torch.full_like(j, (end - e0) // life))
    idx.append(rows)                         # mature_rest: ends >= frames
    gen.append(torch.div(frames - end0 + life - 1, life,
                         rounding_mode="floor"))
    return torch.cat(idx), torch.cat(gen)


def stream_columns(cfg: dict, device, seed: int) -> dict:
    """The stream's records in append order, as columns on ``device``:
    ``start_frame`` / ``end_frame`` (int64) and the raw leaves keyed as
    ``inputs.state_leaves`` keys them."""
    cap, life, frames = cfg["cap_max"], cfg["swin_size"], cfg["frames"]
    p = inputs.state_leaves(dict(cfg, gaussians=cap), device, seed)
    sub = int(np.random.SeedSequence([int(seed), 2]).generate_state(
        1, np.uint64)[0])
    drift = cfg["drift"] * torch.randn(cap, 3, device=device,
                                       generator=inputs.generator(device,
                                                                  sub))
    # decay_genesis: by opacity, descending (stable), group i ends at L - i
    order = torch.argsort(-p["opacity"][:, 0], stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(cap, device=order.device)
    end0 = life - (rank * life) // cap
    j, g = emit_order(end0, life, frames)
    out = {k: v.index_select(0, j) for k, v in p.items()}
    out["xyz"] = out["xyz"] + g[:, None].float() * drift.index_select(0, j)
    end = end0.index_select(0, j) + life * g
    out["start_frame"] = torch.where(g > 0, end - life,
                                     torch.zeros_like(end))
    out["end_frame"] = end
    return out


def write_stream(cols: dict, directory: str, sh_degree: int) -> None:
    """``streamable.dat`` and ``format.json`` of ``cols`` in
    ``directory``, written with NumPy from the record format."""
    n = cols["xyz"].shape[0]
    rec = np.empty(n, dtype=record_dtype(sh_degree))
    for key in rec.dtype.names:
        rec[key] = cols[key].detach().cpu().numpy().reshape(
            rec[key].shape)
    with open(os.path.join(directory, "format.json"), "w") as f:
        json.dump(format_json(sh_degree), f, indent=4)
    rec.tofile(os.path.join(directory, "streamable.dat"))
