"""Device kernels launched per frame in the traced stretch, in any cell
that renders frames: the reader of ``launches_per_frame.view``."""

from benchmark.harness import reader

read = reader("launches_per_frame.view").read
