"""Least work of one served frame at P Gaussians of F parameter floats:
preprocess reads the parameters (F floats a row) and writes the 9
bfloat16 features (18 B a row), the render as its own count says, and the
frame's uint8 RGB bytes reach the host (3 B a pixel). Operations: the
render's."""

from benchmark.counts import peaks, render


def nbytes(work) -> float:
    p, f = work["gaussians"], work["param_floats"]
    return p * (f * 4 + 18) + render.nbytes(work) + work["pixels"] * 3


def least_s(work) -> float:
    return peaks.least_s(nbytes(work), render.ops(work))
