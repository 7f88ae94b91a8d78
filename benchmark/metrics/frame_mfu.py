"""The whole frame's share of the chip's peak, in any cell that renders
frames: the reader of ``frame_mfu.view`` (counts/view_frame.py over the
``work`` the loop reports, whose ``gaussians`` are the rows a frame
draws)."""

from benchmark.harness import reader

read = reader("frame_mfu.view").read
