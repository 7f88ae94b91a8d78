"""Mean host time a served frame spends turning the copied image into
the viewer's bytes, in any cell whose frames go through
``network_gui.image_to_bytes``: the reader of ``encode_ms.view`` (the
``serve.encode`` spans over the ``serve.bytes`` spans)."""

from benchmark.harness import reader

read = reader("encode_ms.view").read
