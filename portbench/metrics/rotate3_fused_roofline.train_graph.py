"""The uint8 rotation kernel's share of its roofline, as
``rotate3_fused_roofline`` reads it, in the cells whose calls replay a CUDA
graph. Moves ``train_img_s.graph``."""

from portbench import harness

MOVES = "train_img_s.graph"
read = harness.reader("rotate3_fused_roofline").read
