"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to a cell is found by name:

- ``configs/<config>.json`` (the ``file`` of the configuration entry);
- ``traffic/<traffic>.json``, whose ``loop`` key names the generator
  ``loops/<loop>.py`` that drives the program with the mix's parameters;
- ``metrics/<metric>.py`` for every metric, a ``read(ctx)`` that returns
  the number or None (then the metric is left out of the line); a metric
  split by cell kind (``idle_share.train``) falls back to the reader of
  its name without the last suffix (``metrics/idle_share.py``).

A run: set-up (inputs from the seed, the program's build from its cache,
warm-up and the first steps that the check reads), the measured window of
``--seconds``, then the check against the plain reference once the
window has closed and the program's state is freed. With ``--trace 0``
the line carries the end-to-end metrics. With ``--trace 1`` it carries
the per-layer ones, from two stretches of at most ``TRACE_SECONDS``
each: an untraced one, whose wall time a step and synchronised spans
the rates and host times read, then one under ``torch.profiler``, whose
trace the device metrics read (the profiler slows the host's dispatch,
so its wall time is not a step's).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")
# A traced run measures two stretches of at most this many seconds: the
# profiler keeps every device operation (~2,500 a training step), so a
# longer trace costs gigabytes of host memory and minutes to reduce.
TRACE_SECONDS = 10.0


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, bench=None) -> dict:
    """The cell ``name`` with its configuration, traffic mix, loop module
    and metric entries, all found by name."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json")) \
            as f:
        mix = json.load(f)
    loop = load_module(os.path.join(BENCH_DIR, "loops", mix["loop"] + ".py"),
                       "bench_loop_" + mix["loop"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m["workloads"] or ("workloads" not in m
                                           and m["moves"] in reported)]
    return dict(cell=cell, cfg=cfg, mix=mix, loop=loop, end_to_end=e2e,
                per_layer=layer)


def reader_path(metric: str) -> str:
    """``metrics/<metric>.py``, else the file of the name without its last
    suffix (one reader for ``idle_share.train`` and ``idle_share.view``)."""
    path = os.path.join(BENCH_DIR, "metrics", metric + ".py")
    if not os.path.exists(path) and "." in metric:
        path = os.path.join(BENCH_DIR, "metrics",
                            metric.rsplit(".", 1)[0] + ".py")
    return path


def reader(metric: str):
    return load_module(reader_path(metric),
                       "bench_metric_" + metric.replace(".", "_").replace(
                           "-", "_"))


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one the benchmark must never
    load (compared whole)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)}
                  & set(FORBIDDEN))


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(loop, seconds: float, device, trace: bool, start: int = 0):
    """Calls ``loop.step(start + i)`` until ``seconds`` have passed on the
    host clock, then waits for the device. Returns (units, wall seconds,
    trace summary or None)."""
    import torch

    from benchmark import trace as trace_lib

    sync(device)
    prof = None
    if trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        marker = torch.zeros(1, device=device)
        sync(device)
        marker_ns = time.time_ns()
        marker.add_(1.0)             # the window's first device operation
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        loop.step(start + n)
        n += 1
    sync(device)
    wall = time.perf_counter() - t0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = trace_lib.Summary(prof.profiler.kineto_results.events(),
                                    loop.host_spans, marker_ns, wall)
        del prof
    return n, wall, summary


def measure(cell: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """One run of ``cell`` (from ``load_cell``); returns the result line
    as a dict. ``device`` is "cuda" on the chip ("cpu" only in the
    benchmark's own tests)."""
    import torch

    loop = cell["loop"].Loop(cell["cfg"], cell["mix"], device, seed, trace)
    loop.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    summary, t_units = None, 0
    if not trace:
        units, wall, _ = run_window(loop, seconds, device, False)
    else:
        stretch = min(seconds, TRACE_SECONDS)
        loop.timed = True               # synchronised spans, no profiler
        units, wall, _ = run_window(loop, stretch, device, False)
        loop.timed, loop.span.on = False, True
        t_units, t_wall, summary = run_window(loop, stretch, device, True,
                                              start=units)
        print(f"untraced {wall * 1e3 / max(units, 1):.4f} ms, traced "
              f"{t_wall * 1e3 / max(t_units, 1):.4f} ms a {loop.unit[:-1]}",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = loop.check()
    failed = loop.failures()
    if getattr(loop, "details", None):
        print("details " + json.dumps(loop.details), file=sys.stderr)
    print(f"set-up {setup_s:.3f} s, window {wall:.3f} s ({units} "
          f"{loop.unit}), check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    attempted = units + t_units
    limits = cell["mix"]["check"]
    check = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in check.values())
    ctx = dict(loop=loop, units=units, wall_s=wall, setup_s=setup_s,
               trace=summary, trace_units=t_units, work=loop.work,
               peak_bytes=peak, cfg=cell["cfg"], mix=cell["mix"])
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in entries:
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": device_block(device, peak, summary)}
    if summary is not None:
        out["breakdown"] = summary.breakdown()
    out["check"] = check
    return out


def device_block(device, peak, summary):
    import torch

    if torch.device(device).type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": 1, "memory_peak_bytes": int(peak)}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 0,
                 "memory_peak_bytes": 0}
    if summary is not None:
        block["busy_s"] = summary.busy_s
        block["window_s"] = summary.window_s
    return block
