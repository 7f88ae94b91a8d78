"""Work of one training blend backward (blend_backward_kernel): the
needed slots' 9 features read and their 9 gradients written (72 B a
slot), each pixel's colour gradient and total downstream dot read
(16 B), 62 float operations a passing (pixel, slot) pair (the forward
recomputed, the suffix sum, dalpha and the nine feature gradients)."""

from benchmark.counts import peaks

OPS_PER_PAIR = 62


def nbytes(work) -> float:
    return work["slots"] * 72 + work["pixels"] * 16


def ops(work) -> float:
    return work["passing"] * OPS_PER_PAIR


def least_s(work) -> float:
    return peaks.least_s(nbytes(work), ops(work))
