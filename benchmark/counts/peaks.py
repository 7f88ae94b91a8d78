"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit), and the least time of a piece of work."""

MEM_BPS = 3.35e12      # HBM3 bytes/s
FP32_OPS = 67e12       # float32 outside the tensor cores, op/s


def least_s(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the bytes over
    the bandwidth and the operations over the float32 rate."""
    return max(nbytes / MEM_BPS, ops / FP32_OPS)


def share(bound_s: float, device_s: float):
    """A roofline share in percent, or None where nothing ran."""
    if not device_s or device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
