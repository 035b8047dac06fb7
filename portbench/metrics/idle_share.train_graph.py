"""The share of the profiled slice in which the card was idle, as
``idle_share.train`` reads it, in the cells whose calls replay a CUDA graph.
Moves ``train_img_s.graph``."""

from portbench import harness

MOVES = "train_img_s.graph"
read = harness.reader("idle_share.train").read
