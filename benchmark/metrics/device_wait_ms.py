"""Mean host time a served frame waits for the device before its image
is copied, in any cell whose frames go through
``network_gui.image_to_bytes``: the reader of ``device_wait_ms.view``
(the ``serve.wait`` spans over the ``serve.bytes`` spans)."""

from benchmark.harness import reader

read = reader("device_wait_ms.view").read
