"""Bytes a served frame copies from the device to the host (the
program's ``serve.d2h_bytes`` counter in ``network_gui.image_to_bytes``)
over the ``serve.bytes`` spans of the traced stretch, in MB (1e6 bytes).
None where the program records no such counter."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    frames = sum(s[0] == "serve.bytes" for s in spans)
    n = getattr(profiling, "counters", dict)().get("serve.d2h_bytes")
    return n / frames / 1e6 if frames and n else None
