"""Host milliseconds to dispatch one call, as ``dispatch_ms_per_call.train``
reads it, in the cells whose calls replay a CUDA graph. Moves
``train_img_s.graph``."""

from portbench import harness

MOVES = "train_img_s.graph"
read = harness.reader("dispatch_ms_per_call.train").read
