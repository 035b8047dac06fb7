"""Host milliseconds to dispatch one call of the fused iteration, with no
synchronise: the mean over the window's calls outside the profiled slice
(timed in ``--trace 1`` runs only). Moves ``train_img_s``."""

MOVES = "train_img_s"


def read(ctx):
    times = ctx["window"]["dispatch_s"]
    return 1e3 * sum(times) / len(times) if times else None
