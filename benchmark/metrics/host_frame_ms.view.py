"""Mean host time per frame from the image's readiness on the device to
its bytes (the device-to-host copy and the uint8 conversion of
network_gui.image_to_bytes), over the untraced stretch of a traced
run."""


def read(ctx):
    t = ctx["loop"].spans.get("host_frame") or []
    return 1e3 * sum(t) / len(t) if t else None
