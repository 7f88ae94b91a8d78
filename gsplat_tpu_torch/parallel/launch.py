"""Start the ranks of a parallel job with one command.

``run(fn, world, device, args)`` calls ``fn(*args)`` on ``world`` ranks,
each in a process group, and returns rank 0's result:

- under ``torchrun`` (RANK / WORLD_SIZE / LOCAL_RANK in the environment)
  this process is one rank; it joins with ``env://`` and runs ``fn``;
- otherwise it spawns ``world`` processes with ``torch.multiprocessing``
  (the spawn start method), joined through a file in a fresh temporary
  directory; rank 0 saves its return value there (``torch.save``) and
  this process loads it after the ranks have ended.

The backend follows the device unless the caller names it: NCCL for
"cuda" (one card per rank: rank r uses card r, and the job is refused
when there are fewer cards than ranks), gloo for "cpu". ``backend="gloo"``
with "cuda" runs ranks that share the cards (rank r on card r % count),
the only way to run several ranks on one card.

``fn`` must be importable (a module-level function). Spawned ranks
other than 0 run with their standard output discarded; only rank 0
writes files. A module the caller made unimportable
(``sys.modules[name] = None``) is unimportable in the spawned ranks
too.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gsplat_tpu_torch.parallel import mesh as mesh_lib


def rank_device(device: str, rank: int, backend: str) -> torch.device:
    """The device of ``rank``: the CPU, or a card as the module docstring
    says."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    return torch.device("cuda", rank % count if backend == "gloo" else rank)


def check_devices(world: int, device: str, backend: str | None) -> str:
    """The backend to use; refuses a one-card-per-rank job with fewer
    cards than ranks."""
    is_cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if is_cuda else "gloo")
    if is_cuda:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            raise RuntimeError(
                "gsplat_tpu_torch: a CUDA device was requested but none is "
                "present; pass --data_device cpu to run the ranks on the CPU")
        if backend == "nccl" and have < world:
            raise ValueError(f"need {world} devices (one card per rank), "
                             f"have {have}")
    return backend


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def _rank_entry(rank, fn, world, init_method, backend, device, args,
                result_path, blocked):
    for name in blocked:
        sys.modules[name] = None
    dev = rank_device(device, rank, backend)
    if dev.type == "cpu":
        # the ranks share the host's cores (torchrun sets one thread)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh_lib.init(rank, world, init_method, backend, dev)
    sink = open(os.devnull, "w") if rank else None
    try:
        with contextlib.redirect_stdout(sink) if sink else \
                contextlib.nullcontext():
            out = fn(*args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        if sink:
            sink.close()
        dist.destroy_process_group()


def run(fn, world: int, device: str, args: tuple = (),
        backend: str | None = None):
    """fn(*args) on ``world`` ranks; rank 0's return value."""
    backend = check_devices(world, device, backend)
    if _torchrun_env():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"the job needs {world} ranks, torchrun started "
                             f"{os.environ['WORLD_SIZE']}")
        rank = int(os.environ["RANK"])
        dev = rank_device(device, int(os.environ["LOCAL_RANK"]), backend)
        mesh_lib.init(rank, world, "env://", backend, dev)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        result_path = os.path.join(tmp, "result.pt")
        blocked = [k for k, v in sys.modules.items() if v is None]
        sys.stdout.flush()
        mp.start_processes(_rank_entry, nprocs=world, join=True,
                           start_method="spawn",
                           args=(fn, world, init_method, backend, device,
                                 args, result_path, blocked))
        return torch.load(result_path, weights_only=False)
