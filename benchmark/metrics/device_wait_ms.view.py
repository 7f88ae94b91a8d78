"""Mean host time a served frame waits for the device before its image
is copied (the program's ``serve.wait`` span in
``network_gui.image_to_bytes``: the device's work not hidden behind the
dispatch), over the ``serve.bytes`` spans of the traced stretch, in ms.
None where the program records no such span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    frames = sum(s[0] == "serve.bytes" for s in spans)
    d = [s[2] - s[1] for s in spans if s[0] == "serve.wait"]
    return 1e-6 * sum(d) / frames if frames and d else None
