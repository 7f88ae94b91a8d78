"""Work of one inference render (render_kernel): each needed slot's 9
bfloat16 features read once (18 B), each pixel's bfloat16 RGB written
once (6 B), 25 float operations a (pixel, slot) pair that passes
alpha >= 1/255 while the pixel's T is above 1e-4."""

from benchmark.counts import peaks

OPS_PER_PAIR = 25


def nbytes(work) -> float:
    return work["slots"] * 18 + work["pixels"] * 6


def ops(work) -> float:
    return work["passing"] * OPS_PER_PAIR


def least_s(work) -> float:
    return peaks.least_s(nbytes(work), ops(work))
