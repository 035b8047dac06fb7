"""Core math: heatmap targets and pseudo-labels, decoding, PCK metrics and
losses."""

from dahpe_tpu_torch.core.decode import get_max_preds, upsample_bilinear
from dahpe_tpu_torch.core.heatmap import (
    fuse_and_normalize_gf,
    gaussian_window_reach,
    generate_target,
    gf_inverse,
    gf_union_minus,
    gf_union_others,
    peaks_from_heatmap,
    pseudo_label_gt,
    render_gaussian,
)
from dahpe_tpu_torch.core.layout import from_bkhw, to_bkhw
from dahpe_tpu_torch.core.losses import joints_kl_loss, joints_mse_loss
from dahpe_tpu_torch.core.metrics import (
    calc_dists,
    dist_acc,
    group_accuracy,
    pck_accuracy,
)

__all__ = [
    "calc_dists",
    "dist_acc",
    "from_bkhw",
    "fuse_and_normalize_gf",
    "gaussian_window_reach",
    "generate_target",
    "get_max_preds",
    "gf_inverse",
    "gf_union_minus",
    "gf_union_others",
    "group_accuracy",
    "joints_kl_loss",
    "joints_mse_loss",
    "pck_accuracy",
    "peaks_from_heatmap",
    "pseudo_label_gt",
    "render_gaussian",
    "to_bkhw",
    "upsample_bilinear",
]
