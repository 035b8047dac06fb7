"""The whole DA step's share of the card's peak: the FLOPs of the window's
iterations (the yardstick's count of one iteration's convolutions, forward
and backward) over the window's wall time and the configuration's dtype
peak, in %. Moves ``train_img_s``."""

from portbench import yardstick

MOVES = "train_img_s"


def read(ctx):
    win, cfg = ctx["window"], ctx["config"]
    if not win["iters"]:
        return None
    flops = yardstick.flops_per_da_iteration(cfg, ctx["traffic"]["batch"]) * win["iters"]
    return 100.0 * flops / win["seconds"] / yardstick.peak_ops(cfg["dtype"])
