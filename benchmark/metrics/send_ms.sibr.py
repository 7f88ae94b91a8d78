"""Mean host time the program's server spends sending one reply over the
socket (``viewer/serve.serve``'s ``serve.send`` span: the frame's RGB
bytes and the verify string), over the traced stretch, in ms. None where
the program records no such span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    d = [s[2] - s[1] for s in spans if s[0] == "serve.send"]
    return 1e-6 * sum(d) / len(d) if d else None
