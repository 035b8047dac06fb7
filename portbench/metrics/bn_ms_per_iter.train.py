"""Device milliseconds of batch-norm kernels a DA iteration, in the profiled
slice (the yardstick's kernel kinds). Moves ``train_img_s``."""

MOVES = "train_img_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["kinds_s"].get("batch_norm"):
        return None
    return 1e3 * tr["kinds_s"]["batch_norm"] / tr["iters"]
