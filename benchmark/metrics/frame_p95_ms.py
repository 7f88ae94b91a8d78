"""95th percentile of the frames' times, in any cell whose loop times
its ``frame`` spans: the reader of ``frame_p95_ms.view``."""

from benchmark.harness import reader

read = reader("frame_p95_ms.view").read
