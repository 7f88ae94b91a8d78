"""Work of one training blend forward (the port's blend_forward_kernel),
counted from the reference's inputs: each slot that any pixel of its tile
still needs read once (9 float32 features), each pixel's colour and final
T written once (16 B), 27 float operations a (pixel, slot) pair that
passes alpha >= 1/255 while the pixel is live (quadratic form, exp,
opacity scale, clamp, tests, the T product, weight, 3 colour FMAs)."""

from benchmark.counts import peaks

OPS_PER_PAIR = 27


def nbytes(work) -> float:
    return work["slots"] * 36 + work["pixels"] * 16


def ops(work) -> float:
    return work["passing"] * OPS_PER_PAIR


def least_s(work) -> float:
    return peaks.least_s(nbytes(work), ops(work))
