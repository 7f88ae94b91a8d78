#!/usr/bin/env python3
"""The check's control and planted faults, read at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the reference, put in the program's place, computed one
precision step below the configuration's (bfloat16 for float32), and,
for a training cell, the reference with half of each image left out of
the loss (the mean taken over the rest), each compared with the
float32 reference by the cell's own comparison. Prints one JSON line a
seed and reading. The benchmark's runs never run this; its readings set
the upper end of each limit (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(loop, cmp, dtype):
    """{name: numbers} for the control and the half-batch fault."""
    import torch

    loop.prepare()
    ref, p0 = loop.reference()
    change = {k: float(torch.linalg.vector_norm(
        (ref["params"][k] - p0[k]).double())) for k in p0}

    def read(run):
        got, q0 = run
        ch = {k: float(torch.linalg.vector_norm(
            (got["params"][k].double() - q0[k].double()))) for k in q0}
        return cmp(got["losses"], got["grad_norms"], ch, ref["losses"],
                   ref["grad_norms"], change)

    h = loop.cfg["train"]["height"]
    return {"control_bf16": read(loop.reference(dtype=dtype)),
            "half_batch": read(loop.reference(rows=h // 2))}


def view_readings(loop, cmp, dtype, frames):
    import numpy as np

    loop.prepare()
    for i in range(frames):
        loop.keep(i, None)
    chosen = sorted(loop.kept)
    want = loop.reference_frames(chosen)
    got = loop.reference_frames(chosen, dtype=dtype)
    return {"control_bf16": cmp(
        {i: g.reshape(-1).cpu().numpy() for i, g in got.items()},
        {i: w.reshape(-1).cpu().numpy().astype(np.uint8)
         for i, w in want.items()})}


def readings(cell, seed, device, frames=600):
    import torch

    mod = cell["loop"]
    loop = mod.Loop(cell["cfg"], cell["mix"], device, seed, False)
    if mod.Loop.unit == "steps":
        return train_readings(loop, mod.compare, torch.bfloat16)
    return view_readings(loop, mod.compare, torch.bfloat16, frames)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=600,
                    help="frames a view window serves (sets the sample)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    limits = cell["mix"]["check"]
    for seed in args.seeds:
        for name, nums in readings(cell, seed, "cuda", args.frames).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "numbers": nums,
                              "fails": sorted(k for k in limits
                                              if not nums[k] <= limits[k])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
