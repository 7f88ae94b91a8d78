"""merge_expand's share of its roofline, in any cell whose budget takes
it (2K < 7P): the reader of ``merge_expand_roofline.view``
(counts/merge_expand.py over merge_expand_kernel's device time)."""

from benchmark.harness import reader

read = reader("merge_expand_roofline.view").read
