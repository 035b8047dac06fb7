"""The pseudo-label kernel's share of its roofline in the profiled slice, %:
the least time of Step B's three label builds (the yardstick's byte
bounds), times the builds the slice launched, over the kernel's device
time there. Moves ``train_img_s``."""

from portbench import yardstick

MOVES = "train_img_s"


def read(ctx):
    tr, cfg = ctx["trace"], ctx["config"]
    if tr is None:
        return None
    seconds = sum(s for name, s in tr["names_s"].items() if "pseudo_labels" in name)
    launches = tr["launches"]["pseudo_labels"]
    if not seconds or not launches:
        return None
    per_three = yardstick.da_labels_bound_ms(ctx["traffic"]["batch"], cfg["heatmap_size"],
                                             cfg["num_keypoints"])
    return 100.0 * per_three * (launches / 3) / 1e3 / seconds
