"""The inference render's share of its roofline, in any cell that renders
frames: the reader of ``render_roofline.view`` (the reference's work a
sampled frame by counts/render.py over render_kernel's device time)."""

from benchmark.harness import reader

read = reader("render_roofline.view").read
