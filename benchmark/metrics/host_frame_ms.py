"""Mean host time per frame from the image's readiness on the device to
its bytes, in any cell whose loop times its ``host_frame`` spans: the
reader of ``host_frame_ms.view``."""

from benchmark.harness import reader

read = reader("host_frame_ms.view").read
