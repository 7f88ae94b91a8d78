"""Mean host time a served frame spends in the program's ``serve.render``
span (``viewer/serve.make_render_fn``'s render: preprocess, binning,
gather, render kernel and assembly dispatched, and any wait inside),
over the traced stretch, in ms; from the span buffer of
``gsplat_tpu_torch.utils.profiling``, which records while the profiler
runs. None where the program records no such span."""

from gsplat_tpu_torch.utils import profiling


def read(ctx):
    spans = getattr(profiling, "spans", list)()
    d = [s[2] - s[1] for s in spans if s[0] == "serve.render"]
    return 1e-6 * sum(d) / len(d) if d else None
