"""Process groups in place of device meshes (port of
gsplat_tpu/parallel/mesh.py).

A ``Mesh`` names the axes of a ``torch.distributed`` job: one process
(rank) per mesh position, each with an explicit device. ``make_mesh``
spans every rank of the job on one axis; ``make_mesh_2d`` lays
n_dp x n_ps ranks out with the ps axis minor (ranks r * n_ps ...
r * n_ps + n_ps - 1 form dp row r), as the JAX mesh puts the ps axis on
adjacent devices.

The collectives the parallel steps use live here, the same calls on
every backend: NCCL when each rank has its own card, gloo on the CPU and
when several ranks share one card (NCCL refuses two ranks on one GPU).
The all-gather is ``all_gather_into_tensor`` and its transpose, the
reduce-scatter (SUM), is ``reduce_scatter_tensor``; gloo takes both on
CUDA tensors (scripts/torch_gloo_probe.py: torch 2.11+cu128, two ranks
on one H100). The collectives are not the port's hand kernels and stay
library calls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    group: object        # the torch.distributed ProcessGroup of this axis
    size: int
    index: int           # this rank's position along the axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the job: its device and its axes."""

    axes: Dict[str, Axis]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {k: a.size for k, a in self.axes.items()}

    def axis_index(self, name: str) -> int:
        return self.axes[name].index

    def group(self, name: str):
        return self.axes[name].group


def init(rank: int, world: int, init_method: str, backend: str,
         device: str | torch.device) -> torch.device:
    """Join the job; returns this rank's device. ``backend`` is named by
    the caller: "nccl" (one card per rank) or "gloo" (CPU ranks, or ranks
    sharing a card)."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              device: str | torch.device | None = None) -> Mesh:
    """1-D mesh over the job's first ``n_devices`` ranks (default: all)."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"need {n} ranks, the job has {world}")
    return Mesh({axis_name: Axis(dist.group.WORLD, n, dist.get_rank())},
                _device(device))


def make_mesh_2d(n_dp: int, n_ps: int, dp_axis: str = "dp",
                 ps_axis: str = "ps",
                 device: str | torch.device | None = None) -> Mesh:
    """2-D (camera-batch dp x Gaussian-shard ps) mesh, ps minor. Every rank
    creates every subgroup, in the same order, as torch.distributed
    requires."""
    world = dist.get_world_size()
    if world != n_dp * n_ps:
        raise ValueError(f"need {n_dp * n_ps} ranks, the job has {world}")
    rank = dist.get_rank()
    row, col = divmod(rank, n_ps)
    ps_groups = [dist.new_group([r * n_ps + c for c in range(n_ps)])
                 for r in range(n_dp)]
    dp_groups = [dist.new_group([r * n_ps + c for r in range(n_dp)])
                 for c in range(n_ps)]
    return Mesh({dp_axis: Axis(dp_groups[col], n_dp, row),
                 ps_axis: Axis(ps_groups[row], n_ps, col)}, _device(device))


def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---- collectives -------------------------------------------------------

def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` (a new tensor; ``x`` is left alone)."""
    out = x.detach().clone()
    if mesh.axes[axis].size > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return out


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / mesh.axes[axis].size


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    out = x.detach().clone()
    if mesh.axes[axis].size > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(axis))
    return out


def in_turn(fn):
    """``fn()`` on every rank of the job, one rank after another (rank 0
    first), e.g. a dataset reader that may write a file beside the data;
    returns this rank's result."""
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
        dist.barrier()
    return out


def sync_replicas(mesh: Mesh, axes, *trees) -> None:
    """In place: every tensor leaf of ``trees`` (states, Adam states,
    dicts) takes the value of the rank at index 0 of each of ``axes`` in
    turn. The trainers call it once, on the initial state, which each
    process draws from its own numpy stream. Later steps keep replicas
    equal by themselves (same draws, deterministic kernels and
    reductions, collectives that give every rank the same bits). One
    broadcast per dtype and axis, the leaves packed."""
    from gsplat_tpu_torch.utils.checkpoint import flatten_with_keys

    leaves = [v for tree in trees for _, v in flatten_with_keys(tree)
              if isinstance(v, torch.Tensor)]
    for name in axes:
        a = mesh.axes[name]
        if a.size == 1:
            continue
        src = dist.get_global_rank(a.group, 0)
        for dtype in dict.fromkeys(v.dtype for v in leaves):
            group = [v for v in leaves if v.dtype == dtype]
            flat = torch.cat([v.reshape(-1) for v in group])
            dist.broadcast(flat, src=src, group=a.group)
            at = 0
            for v in group:
                v.copy_(flat[at:at + v.numel()].view_as(v))
                at += v.numel()


def _gather_blocks(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[n * rows, ...]: every rank's ``x`` in axis order."""
    a = mesh.axes[axis]
    if a.size == 1:
        return x.clone()
    x = x.contiguous()
    full = torch.empty((a.size * x.shape[0],) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(full, x, group=a.group)
    return full


def _reduce_scatter(g: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's block of rows of the sum over ``axis`` of ``g``."""
    a = mesh.axes[axis]
    if a.size == 1:
        return g.clone()
    g = g.contiguous()
    out = torch.empty((g.shape[0] // a.size,) + tuple(g.shape[1:]),
                      dtype=g.dtype, device=g.device)
    dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=a.group)
    return out


def _own_block(full: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    a = mesh.axes[axis]
    rows = full.shape[0] // a.size
    return full[a.index * rows:(a.index + 1) * rows]


class _AllGather(torch.autograd.Function):
    """Row all-gather whose backward is the reduce-scatter (SUM) of the
    cotangent, the transpose JAX takes for ``lax.all_gather``."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather_blocks(x.detach(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis), None, None


class _PSum(torch.autograd.Function):
    """``psum`` whose backward is the psum of the cotangent (JAX's
    transpose of psum inside shard_map)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable all-gather along dim 0: [n * rows, ...], blocks in
    axis order. A stacked [n, ...] view is ``.view(n, *x.shape)``."""
    return _AllGather.apply(x, mesh, axis)


def psum_grad(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Differentiable psum (see ``_PSum``)."""
    return _PSum.apply(x, mesh, axis)


def gather_rows(tensors: Dict[str, torch.Tensor], mesh: Mesh,
                axis: str) -> Dict[str, torch.Tensor]:
    """Not differentiable: each leaf's row shards gathered along ``axis``
    in one collective (the leaves packed side by side)."""
    keys = list(tensors)
    rows = tensors[keys[0]].shape[0]
    flat = [tensors[k].detach().reshape(rows, -1).float() for k in keys]
    full = _gather_blocks(torch.cat(flat, dim=1), mesh, axis)
    out, col = {}, 0
    for k, f in zip(keys, flat):
        w = f.shape[1]
        out[k] = full[:, col:col + w].reshape(
            (full.shape[0],) + tuple(tensors[k].shape[1:])).to(
            tensors[k].dtype)
        col += w
    return out


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's block of rows of a replicated ``x``."""
    return _own_block(x, mesh, axis).contiguous()
