"""Mean host time a played frame spends in the program's ``stream.render``
span (``eval/render_stream.make_stream_render_fn``'s render: the slice
selection, preprocess, binning, gather, render kernel and encode
dispatched, and any wait inside), over the traced stretch, in ms. None
where the program records no such span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    d = [s[2] - s[1] for s in spans if s[0] == "stream.render"]
    return 1e-6 * sum(d) / len(d) if d else None
