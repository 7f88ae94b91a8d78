"""Mean squared distance to the 3 nearest neighbours, for the scale
initialisation, and exact k-NN indices for the ARAP regulariser (port of
gsplat_tpu/model/knn.py).

Exact at every P, like the reference's simple-knn
(submodules/simple-knn/simple_knn.cu:185-221):

- up to ``EXACT_KNN_MAX`` points, a distance matrix blocked on both axes
  (the cross term a ``torch.matmul`` in float32), top-3 carried across the
  column blocks;
- beyond that, a Morton-window pass: points sorted by 30-bit Morton code,
  each sorted block compared with its 3-block neighbourhood, every answer
  certified by the AABB lower bound of each out-of-window block, and the
  certificate's violators rescanned exactly against all points.

``knn_indices`` is the blocked distance matrix at every P (as JAX's), with
the neighbour ids carried through the top-k merge.

These are plain torch ops: the JAX package leaves them to XLA, not Pallas.
"""

from __future__ import annotations

import torch

# Above this many points the dense O(P^2) pass is replaced by the
# Morton-window pass (also exact).
EXACT_KNN_MAX = 1 << 18


def _pad(points: torch.Tensor, block: int, value: float = 0.0):
    pad = (-points.shape[0]) % block
    if not pad:
        return points
    return torch.cat([points, torch.full((pad, 3), value,
                                         dtype=points.dtype,
                                         device=points.device)])


def _topk_rows_vs_all(row_pts, row_ids, points, block: int, k: int = 3):
    """Exact top-k of ``row_pts`` [V, 3] (global ids ``row_ids`` excluded
    as self) against all ``points``, streamed over column blocks: ([V, k]
    ascending squared distances, [V, k] int64 neighbour ids)."""
    p = points.shape[0]
    row_sq = (row_pts * row_pts).sum(dim=1)
    best_d = torch.full((row_pts.shape[0], k), float("inf"),
                        device=points.device)
    best_i = torch.zeros((row_pts.shape[0], k), dtype=torch.int64,
                         device=points.device)
    for start in range(0, p, block):
        col = points[start:start + block]
        col_sq = (col * col).sum(dim=1)
        d2 = row_sq[:, None] + col_sq[None, :] - 2.0 * (row_pts @ col.t())
        col_ids = torch.arange(start, start + col.shape[0],
                               device=points.device)
        d2 = torch.where(col_ids[None, :] == row_ids[:, None],
                         torch.full_like(d2, float("inf")),
                         torch.clamp(d2, min=0.0))
        merged_d = torch.cat([best_d, d2], dim=1)
        merged_i = torch.cat([best_i, col_ids[None, :].expand(
            row_pts.shape[0], -1)], dim=1)
        best_d, j = torch.topk(merged_d, k, dim=1, largest=False)
        best_i = torch.gather(merged_i, 1, j)
    return best_d, best_i


@torch.no_grad()
def knn_indices(points: torch.Tensor, k: int = 20, block: int = 4096):
    """Exact k nearest neighbours (self excluded) of each of ``points``
    [P, 3]: (squared distances [P, k] ascending, ids [P, k] int64). The
    replacement for the open3d KDTree the reference's ARAP regulariser
    builds its graph with (utils/loss_utils.py:71-101)."""
    points = points.float()
    p = points.shape[0]
    ids = torch.arange(p, device=points.device)
    parts = [_topk_rows_vs_all(points[s:s + block], ids[s:s + block],
                               points, block, k)
             for s in range(0, p, block)]
    return (torch.cat([d for d, _ in parts]),
            torch.cat([i for _, i in parts]))


def _mean_sq_dist_3nn_exact(points: torch.Tensor, block: int):
    p = points.shape[0]
    ids = torch.arange(p, device=points.device)
    out = [_topk_rows_vs_all(points[s:s + block], ids[s:s + block], points,
                             block)[0].mean(dim=1)
           for s in range(0, p, block)]
    return torch.cat(out) if out else points.new_zeros(0)


def _spread_bits(x):
    """10-bit int -> bits spread 3 apart (Morton interleave component)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _windowed_3nn(points: torch.Tensor, block: int):
    """Morton-window 3-NN candidates + exactness certificate. Returns
    (mean3 [P], violator [P] bool) in the original point order."""
    p = points.shape[0]
    dev = points.device
    # far-away sentinels pad the last block: sorted last, never neighbours
    pts = _pad(points, block, 3e8)
    n = pts.shape[0]
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    q = (pts - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0
    q = torch.clamp(q, 0, 1023).to(torch.int32)
    code = ((_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1)
            | _spread_bits(q[:, 2]))
    order = torch.argsort(code, stable=True)
    pts_s = pts[order]
    sq_s = (pts_s * pts_s).sum(dim=1)
    nb = n // block
    blocks = pts_s.view(nb, block, 3)
    inf = float("inf")
    # AABBs over real points only (the sentinels would inflate the last)
    valid = (order < p).view(nb, block, 1)
    box_lo = torch.where(valid, blocks, torch.full_like(blocks, inf)
                         ).min(dim=1).values
    box_hi = torch.where(valid, blocks, torch.full_like(blocks, -inf)
                         ).max(dim=1).values
    blk_idx = torch.arange(nb, device=dev)
    out_s = torch.empty(n, device=dev)
    viol_s = torch.empty(n, dtype=torch.bool, device=dev)
    win = min(3 * block, n)
    for r in range(nb):
        row = blocks[r]
        row_sq = sq_s[r * block:(r + 1) * block]
        row_ids = torch.arange(r * block, (r + 1) * block, device=dev)
        start = min(max(r - 1, 0), max(nb - 3, 0))
        w_pts = pts_s[start * block:start * block + win]
        w_sq = sq_s[start * block:start * block + win]
        w_ids = torch.arange(start * block, start * block + win, device=dev)
        d2 = row_sq[:, None] + w_sq[None, :] - 2.0 * (row @ w_pts.t())
        d2 = torch.where(w_ids[None, :] == row_ids[:, None],
                         torch.full_like(d2, inf), torch.clamp(d2, min=0.0))
        top3 = torch.topk(d2, 3, dim=1, largest=False).values
        d3 = top3[:, 2]
        # lower bound of the squared distance to each out-of-window box
        gap = torch.maximum(box_lo[None] - row[:, None],
                            row[:, None] - box_hi[None])
        bound = (torch.clamp(gap, min=0.0) ** 2).sum(dim=-1)
        in_win = (blk_idx >= start) & (blk_idx < start + 3)
        bound = torch.where(in_win[None, :], torch.full_like(bound, inf),
                            bound)
        out_s[r * block:(r + 1) * block] = top3.mean(dim=1)
        viol_s[r * block:(r + 1) * block] = (
            bound <= d3[:, None] * (1.0 + 1e-5)).any(dim=1)
    out = torch.empty_like(out_s)
    out[order] = out_s
    viol = torch.empty_like(viol_s)
    viol[order] = viol_s
    return out[:p], viol[:p]


def _mean_sq_dist_3nn_large(points: torch.Tensor, block: int):
    mean3, viol = _windowed_3nn(points, block)
    idx = torch.nonzero(viol).flatten()
    if idx.numel():
        fixed = torch.cat([
            _topk_rows_vs_all(points[idx[s:s + 4096]], idx[s:s + 4096],
                              points, block)[0].mean(dim=1)
            for s in range(0, idx.numel(), 4096)])
        mean3 = mean3.clone()
        mean3[idx] = fixed
    return mean3


@torch.no_grad()
def mean_sq_dist_3nn(points: torch.Tensor, block: int = 2048):
    """points [P, 3] -> [P] mean squared distance to the 3 nearest
    neighbours (self excluded), exact at every P."""
    points = points.float()
    if points.shape[0] <= EXACT_KNN_MAX:
        return _mean_sq_dist_3nn_exact(points, block)
    return _mean_sq_dist_3nn_large(points, block)
