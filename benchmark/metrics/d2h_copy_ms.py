"""Mean host time a served frame spends copying its image from the
device, in any cell whose frames go through
``network_gui.image_to_bytes``: the reader of ``d2h_copy_ms.view`` (the
``serve.copy`` spans over the ``serve.bytes`` spans)."""

from benchmark.harness import reader

read = reader("d2h_copy_ms.view").read
