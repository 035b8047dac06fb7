"""The pseudo-label kernel's share of its roofline, as
``pseudo_labels_roofline`` reads it, in the cells whose calls replay a CUDA
graph. Moves ``train_img_s.graph``."""

from portbench import harness

MOVES = "train_img_s.graph"
read = harness.reader("pseudo_labels_roofline").read
