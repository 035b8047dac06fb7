"""The uint8 rotation kernel's share of its roofline in the profiled slice,
%: the yardstick's least time of one launch (a batch of stored crops, 3
channels) times the launches, over the kernel's device time. Moves
``train_img_s``."""

from portbench import yardstick

MOVES = "train_img_s"


def read(ctx):
    tr, cfg = ctx["trace"], ctx["config"]
    if tr is None:
        return None
    seconds = sum(s for name, s in tr["names_s"].items() if "rotate3_fused_kernel" in name)
    launches = tr["launches"]["rotate3_fused_kernel"]
    if not seconds or not launches:
        return None
    bound_ms, _ = yardstick.rotation_bound_ms(ctx["traffic"]["batch"], cfg["raw_size"], 3)
    return 100.0 * bound_ms * launches / 1e3 / seconds
