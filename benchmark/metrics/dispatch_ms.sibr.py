"""Mean host time a frame served over the socket spends in the
program's ``serve.render`` span (``viewer/serve.make_render_fn``'s
render, called by ``serve.serve`` in the server's thread), over the
traced stretch, in ms: the reader of ``dispatch_ms.view``. None where
the program records no such span."""

from benchmark.harness import reader

read = reader("dispatch_ms.view").read
