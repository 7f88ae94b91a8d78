#!/usr/bin/env python3
"""Compare two trained-scene statistics files (scripts/soak_30k.py's and
scripts/torch_soak_30k.py's ``_dump_stats`` layout): the largest
difference over the opacity quantiles and over the per-Gaussian sorted
log-scale quantiles (also without the grid's two ends, the minimum and
the maximum), and each file's median opacity and alive count.

    python3 scripts/torch_trained_stats_diff.py A.npz [B.npz]

B defaults to the committed tests/fixtures/trained_stats.npz. Prints one
JSON line. Host only: numpy, no torch.
"""

import argparse
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "trained_stats.npz")


def compare(a_path: str, b_path: str) -> dict:
    with np.load(a_path) as a, np.load(b_path) as b:
        def median_opacity(st):
            q = st["opacity_quantiles"]
            return float(np.interp(0.5, np.linspace(0, 1, len(q)), q))

        # per grid point, the largest of the three sorted axes; the inner
        # points leave out the minimum and the maximum (q = 0 and 1)
        ls = np.abs(a["logscale_sorted_quantiles"]
                    - b["logscale_sorted_quantiles"]).max(axis=1)
        return {
            "a": a_path, "b": b_path,
            "a_source": str(a["source"].astype(str)),
            "b_source": str(b["source"].astype(str)),
            "opacity_quantiles_max_abs_diff": float(np.abs(
                a["opacity_quantiles"] - b["opacity_quantiles"]).max()),
            "logscale_sorted_quantiles_max_abs_diff": float(ls.max()),
            "logscale_sorted_quantiles_max_abs_diff_inner": float(
                ls[1:-1].max()),
            "median_opacity": [median_opacity(a), median_opacity(b)],
            "n_alive": [int(a["n_alive"]), int(b["n_alive"])],
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a")
    ap.add_argument("b", nargs="?", default=FIXTURE)
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.a, args.b)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
