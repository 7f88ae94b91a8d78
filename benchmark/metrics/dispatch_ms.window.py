"""Mean host time a window frame spends in the program's ``swin.render``
span (``viewer/serve.make_window_render_fn``'s render: the frame
number's staging, the camera's, ``cudaGraphLaunch`` and the output's
copy, and any wait inside), over the traced stretch, in ms. None where
the program records no such span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    d = [s[2] - s[1] for s in spans if s[0] == "swin.render"]
    return 1e-6 * sum(d) / len(d) if d else None
