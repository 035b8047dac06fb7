"""The share of the profiled slice's wall time in which no operation ran
on the card, %. Moves ``train_img_s``."""

MOVES = "train_img_s"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["wall_s"])
