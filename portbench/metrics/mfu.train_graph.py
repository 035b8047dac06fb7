"""The whole DA step's share of the card's peak, as ``mfu.train`` reads it, in
the cells whose calls replay a CUDA graph. Moves ``train_img_s.graph``."""

from portbench import harness

MOVES = "train_img_s.graph"
read = harness.reader("mfu.train").read
