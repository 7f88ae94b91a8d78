"""Which gloo collectives take CUDA tensors, and what the pshard gather
costs in each formulation.

Two ranks share card 0 over gloo (as chip_smoke.py's ``parallel`` phase
runs them). Each rank tries ``all_gather_into_tensor`` and
``reduce_scatter_tensor`` (SUM) on CUDA tensors and checks the result,
then times, at the pshard gather's size (1M rows of 59 packed floats,
half per rank), the dedicated collective against the all_reduce form
(a zero-padded n x buffer summed, or the whole cotangent summed and
sliced). Prints one JSON line (rank 0). Needs a card:

    python3 scripts/torch_gloo_probe.py [--rows 1000000] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def _rank(rank, world, init, rows, reps, out_path):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    res = {}
    x = torch.full((4, 3), float(rank + 1), device=dev)
    try:
        full = torch.empty((4 * world, 3), device=dev)
        dist.all_gather_into_tensor(full, x)
        want = torch.cat([torch.full((4, 3), float(r + 1), device=dev)
                          for r in range(world)])
        res["all_gather_into_tensor"] = bool(torch.equal(full, want))
    except Exception as e:  # the probe's result, not a fallback
        res["all_gather_into_tensor"] = f"{type(e).__name__}: {e}"
    try:
        g = torch.arange(4 * world * 3, dtype=torch.float32,
                         device=dev).reshape(4 * world, 3) * (rank + 1)
        part = torch.empty((4, 3), device=dev)
        dist.reduce_scatter_tensor(part, g, op=dist.ReduceOp.SUM)
        base = torch.arange(4 * world * 3, dtype=torch.float32,
                            device=dev).reshape(4 * world, 3)
        want = base[rank * 4:(rank + 1) * 4] * sum(range(1, world + 1))
        res["reduce_scatter_tensor"] = bool(torch.equal(part, want))
    except Exception as e:  # the probe's result, not a fallback
        res["reduce_scatter_tensor"] = f"{type(e).__name__}: {e}"

    n = rows // world
    shard = torch.randn((n, 59), device=dev)
    full = torch.empty((n * world, 59), device=dev)
    cot = torch.randn((n * world, 59), device=dev)
    part = torch.empty((n, 59), device=dev)

    def ar_gather():
        buf = torch.zeros((n * world, 59), device=dev)
        buf[rank * n:(rank + 1) * n] = shard
        dist.all_reduce(buf)

    def ar_scatter():
        buf = cot.clone()
        dist.all_reduce(buf)
        part.copy_(buf[rank * n:(rank + 1) * n])

    timing = {"all_reduce_gather_ms": _timed(ar_gather, reps),
              "all_reduce_scatter_ms": _timed(ar_scatter, reps)}
    if res["all_gather_into_tensor"] is True:
        timing["all_gather_into_tensor_ms"] = _timed(
            lambda: dist.all_gather_into_tensor(full, shard), reps)
    if res["reduce_scatter_tensor"] is True:
        timing["reduce_scatter_tensor_ms"] = _timed(
            lambda: dist.reduce_scatter_tensor(part, cot), reps)
    res.update(timing)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.json")
        mp.start_processes(_rank, nprocs=2, join=True, start_method="spawn",
                           args=(2, "file://" + os.path.join(tmp, "rdv"),
                                 args.rows, args.reps, out))
        with open(out) as f:
            res = json.load(f)
    res.update(card=card.strip().splitlines()[0], torch=torch.__version__,
               rows=args.rows, ranks=2, backend="gloo")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
