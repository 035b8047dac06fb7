"""Core math: heatmap targets, decoding, PCK metrics and losses."""

from dahpe_tpu_torch.core.decode import get_max_preds
from dahpe_tpu_torch.core.heatmap import (
    gaussian_window_reach,
    generate_target,
    peaks_from_heatmap,
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
    "gaussian_window_reach",
    "generate_target",
    "get_max_preds",
    "group_accuracy",
    "joints_kl_loss",
    "joints_mse_loss",
    "pck_accuracy",
    "peaks_from_heatmap",
    "render_gaussian",
    "to_bkhw",
]
