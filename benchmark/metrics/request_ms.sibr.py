"""Mean host time of one answered socket request in the program's server
(``viewer/serve.serve``'s ``serve.request`` span, recorded in the server's
thread: the request's receive, the render, the bytes and the send), over
the requests of the traced stretch whose reply was sent (a ``serve.send``
span under the same root), in ms. None where the program records no such
span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    sent = {s[4] for s in spans if s[0] == "serve.send"}
    d = [s[2] - s[1] for s in spans
         if s[0] == "serve.request" and s[4] in sent]
    return 1e-6 * sum(d) / len(d) if d else None
