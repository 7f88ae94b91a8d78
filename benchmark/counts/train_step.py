"""Least work of one static training step at P Gaussians of F floats of
parameters (59 at SH degree 3): preprocess reads the parameters and writes
the 9-float feature table, its backward reads the table's gradient and
writes the parameters' gradient; Adam reads parameter, gradient and both
moments and writes parameter and moments (7 floats a parameter); the noise
reads position, scale, rotation and opacity (11 floats) and writes the
position; the blends as their own counts say; the per-Gaussian reduction
reads each pair's 9 gradients once (36 B a pair). Operations: the blends' (the per-Gaussian arithmetic is below 1% of
them and is left out)."""

from benchmark.counts import blend_backward, blend_forward, peaks


def nbytes(work) -> float:
    p, f = work["gaussians"], work["param_floats"]
    per_row = (f + 9) * 4 + (9 + f) * 4 + 7 * f * 4 + 14 * 4
    return (p * per_row + blend_forward.nbytes(work)
            + blend_backward.nbytes(work) + work["pairs"] * 36)


def ops(work) -> float:
    return blend_forward.ops(work) + blend_backward.ops(work)


def least_s(work) -> float:
    return peaks.least_s(nbytes(work), ops(work))
