"""Device milliseconds of batch-norm kernels a DA iteration, as
``bn_ms_per_iter.train`` reads it, in the cells whose calls replay a CUDA
graph. Moves ``train_img_s.graph``."""

from portbench import harness

MOVES = "train_img_s.graph"
read = harness.reader("bn_ms_per_iter.train").read
