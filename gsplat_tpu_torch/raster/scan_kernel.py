"""Scan kernels (port of gsplat_tpu/raster/scan_kernel.py): the
owner-expansion kernels of binning, ``expand_scan`` and ``merge_expand``,
the compensated ``multi_cumsum`` of the gradient reduction, and
``multi_cummax``; the densification's template CDF
(``mcmc._template_cdf``) takes one ``multi_cumsum`` and one
``multi_cummax``.

Each public function is a wrapper: a CUDA tensor launches the hand-written
Hopper kernel in ``csrc/scan_kernels.cu`` (and adds one to the wrapper's
``launches`` count), a CPU tensor takes the plain PyTorch version beside
it. The source notes in the .cu file give each kernel's bound and design.

- ``expand_scan`` replaces ``scan_kernel._expand_kernel``: one pass over
  the slots computing the latest nonzero mark, the running max of
  ``base_in`` (floored at 0, as the TPU carry starts at 0) and the 1-based
  running count of nonzero marks. The kernel is a single-pass chained
  scan; its look-back state lives in a buffer kept per kernel, device and
  stream (``_lookback_state``), zero-filled once. The kernel keeps the
  call's epoch in the buffer and advances it itself, so a call launches
  the one kernel and nothing else, and a launch captured in a CUDA graph
  is right on every replay.
- ``merge_expand`` replaces ``scan_kernel._merge_kernel``: slot d's owner
  is the last g with ``starts[g] <= d`` (``starts`` ascending); returns
  ``pack[g]``, ``starts[g]`` and ``g + 1`` (all 0 where no start is <= d).
  Slots at or past the duplicate count are dead: callers mask them. The
  kernel merges the starts with the slot indices (a merge-path search a
  block), so runs of equal starts (empty ranges) cost no more than others.
- ``multi_cumsum`` replaces ``scan_kernel._cumsum_kernel``: the inclusive
  float32 cumsum of each row of an [n, K] array, with a compensated carry
  between 16384-element blocks so each element's error stays at
  within-block scale. The kernel is a single-pass chained scan like
  ``expand_scan``'s, with a state buffer of its own; it folds the carry in
  block order, so two launches on the same input give the same bits.
- ``multi_cummax`` replaces ``scan_kernel._kernel``: the inclusive int32
  cummax of each row of an [n, K] array. The kernel is ``multi_cumsum``'s
  single pass with max, one packed status word a tile, and a state buffer
  of its own. The template sampler runs it over the bit patterns of its
  non-negative CDF (the JAX package calls it nowhere).
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.raster import cuda_ext


def _check_i32(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def expand_scan_plain(marks: torch.Tensor, base_in: torch.Tensor):
    """Plain PyTorch version of ``expand_scan``."""
    k = marks.shape[0]
    nz = marks != 0
    idx = torch.arange(k, dtype=torch.int64, device=marks.device)
    last = torch.cummax(torch.where(nz, idx, torch.full_like(idx, -1)),
                        dim=0).values
    pack = torch.where(last >= 0, marks[last.clamp(min=0)],
                       torch.zeros_like(marks))
    if k:
        base = torch.clamp(torch.cummax(base_in, dim=0).values, min=0)
    else:
        base = base_in.clone()
    rank = torch.cumsum(nz.to(torch.int32), dim=0, dtype=torch.int32)
    return pack, base, rank


# (kernel, device index, stream id) -> int64 state buffer
_LOOKBACK: dict = {}
# the buffers _LOOKBACK has outgrown: a launch captured in a CUDA graph
# keeps reading the buffer it was given
_OUTGROWN: list = []


def _lookback_state(kernel: str, device: torch.device, words: int):
    """The look-back state buffer of ``kernel`` on ``device``'s current
    stream, at least ``words`` int64 long; a new or larger one is
    zero-filled, and every buffer handed out is kept. Calls of one kernel
    on one stream never overlap, so they can share it. Each kernel has its
    own buffer: they lay their tiles' states out differently."""
    key = (kernel, device.index,
           torch.cuda.current_stream(device).cuda_stream)
    state = _LOOKBACK.get(key)
    if state is None or state.numel() < words:
        if state is not None:
            _OUTGROWN.append(state)
        state = _LOOKBACK[key] = torch.zeros(words, dtype=torch.int64,
                                             device=device)
    return state


def expand_scan(marks: torch.Tensor, base_in: torch.Tensor):
    """(pack, base, rank) int32 [K] — see the module docstring."""
    device = marks.device
    _check_i32("marks", marks, device)
    _check_i32("base_in", base_in, device)
    if base_in.shape != marks.shape:
        raise ValueError(f"shape mismatch {marks.shape} vs {base_in.shape}")
    if device.type == "cpu":
        return expand_scan_plain(marks, base_in)
    ext = cuda_ext.load()
    k = marks.shape[0]
    state = _lookback_state("expand_scan", device,
                            ext.expand_scan_state_words(k))
    outs = [torch.empty_like(marks) for _ in range(3)]
    ext.expand_scan(marks, base_in, state, *outs)
    expand_scan.launches += 1
    return tuple(outs)


expand_scan.launches = 0


def merge_expand_plain(starts: torch.Tensor, pack: torch.Tensor, k: int):
    """Plain PyTorch version of ``merge_expand``."""
    d = torch.arange(k, dtype=torch.int32, device=starts.device)
    g = torch.searchsorted(starts, d, right=True).to(torch.int32) - 1
    has = g >= 0
    gc = g.clamp(min=0).long()
    zero = torch.zeros(k, dtype=torch.int32, device=starts.device)
    if starts.shape[0] == 0:
        return zero, zero.clone(), g + 1
    return (torch.where(has, pack[gc], zero),
            torch.where(has, starts[gc], zero), g + 1)


def merge_expand(starts: torch.Tensor, pack: torch.Tensor, k: int):
    """(pack_d, base_of_d, rank_d) int32 [k] — see the module docstring."""
    device = starts.device
    _check_i32("starts", starts, device)
    _check_i32("pack", pack, device)
    if pack.shape != starts.shape:
        raise ValueError(f"shape mismatch {starts.shape} vs {pack.shape}")
    if k >= 2**31 or starts.shape[0] >= 2**31:
        raise ValueError("merge_expand indexes with int32")
    if device.type == "cpu":
        return merge_expand_plain(starts, pack, k)
    ext = cuda_ext.load()
    outs = [torch.empty(k, dtype=torch.int32, device=device)
            for _ in range(3)]
    ext.merge_expand(starts, pack, *outs)
    merge_expand.launches += 1
    return tuple(outs)


merge_expand.launches = 0


CUMSUM_BLOCK = 16384  # elements per tile of the kernel's compensated carry


def multi_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``multi_cumsum``: the same blocks, each
    scanned on its own, plus the exclusive sum of the block totals carried
    in float64 (at least as exact as the kernel's compensated carry)."""
    n, k = x.shape
    nb = -(-k // CUMSUM_BLOCK)
    xp = torch.zeros(n, nb * CUMSUM_BLOCK, dtype=torch.float32,
                     device=x.device)
    xp[:, :k] = x
    scanned = torch.cumsum(xp.view(n, nb, CUMSUM_BLOCK), dim=2)
    tot = scanned[:, :, -1].double()
    carry = (torch.cumsum(tot, dim=1) - tot).float()        # exclusive
    return (scanned + carry[:, :, None]).reshape(n, -1)[:, :k]


def multi_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive compensated cumsum of each row of ``x`` [n, K] float32."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous [n, K] float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return multi_cumsum_plain(x)
    out = torch.empty_like(x)
    if x.numel():
        ext = cuda_ext.load()
        n, k = x.shape
        state = _lookback_state("multi_cumsum", x.device,
                                ext.multi_cumsum_state_words(n, k))
        ext.multi_cumsum(x, state, out)
        multi_cumsum.launches += 1
    return out


multi_cumsum.launches = 0


def multi_cummax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``multi_cummax``."""
    return torch.cummax(x, dim=1).values


def multi_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cummax of each row of ``x`` [n, K] int32."""
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous [n, K] int32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return multi_cummax_plain(x)
    out = torch.empty_like(x)
    if x.numel():
        ext = cuda_ext.load()
        n, k = x.shape
        state = _lookback_state("multi_cummax", x.device,
                                ext.multi_cummax_state_words(n, k))
        ext.multi_cummax(x, state, out)
        multi_cummax.launches += 1
    return out


multi_cummax.launches = 0
