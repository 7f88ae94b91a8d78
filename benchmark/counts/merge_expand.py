"""Work of merge_expand, the owner expansion by merge: the starts and
packs of P Gaussians read (8 B each) and three int32 written for each of
the K pairs (12 B a pair): 8P + 12K bytes."""

from benchmark.counts import peaks


def least_s(work) -> float:
    return peaks.least_s(8 * work["gaussians"] + 12 * work["pairs"], 0)
