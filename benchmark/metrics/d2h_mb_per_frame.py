"""Bytes a served frame copies from the device to the host, in any cell
whose frames go through ``network_gui.image_to_bytes``: the reader of
``d2h_mb_per_frame.view`` (the ``serve.d2h_bytes`` counter over the
``serve.bytes`` spans, in MB)."""

from benchmark.harness import reader

read = reader("d2h_mb_per_frame.view").read
