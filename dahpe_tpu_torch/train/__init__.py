"""Training: partitioned SGD, disparity losses, the DA minimax step, the
pretrain step and the fused producer + step iterations."""

from dahpe_tpu_torch.train import disparity, optim
from dahpe_tpu_torch.train.da import (
    DATrainState,
    create_da_state,
    make_da_train_step,
)
from dahpe_tpu_torch.train.ema import ema_update
from dahpe_tpu_torch.train.fused import (
    make_fused_da_iteration,
    make_fused_pretrain_iteration,
)
from dahpe_tpu_torch.train.pretrain import (
    PretrainState,
    create_pretrain_state,
    make_pretrain_step,
)

__all__ = [
    "disparity",
    "optim",
    "DATrainState",
    "create_da_state",
    "make_da_train_step",
    "ema_update",
    "make_fused_da_iteration",
    "make_fused_pretrain_iteration",
    "PretrainState",
    "create_pretrain_state",
    "make_pretrain_step",
]
