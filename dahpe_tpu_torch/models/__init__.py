"""Model zoo + registry (port of ``dahpe_tpu/models/__init__.py``)."""

from dahpe_tpu_torch.models.batch_norm import BatchNorm2d
from dahpe_tpu_torch.models.heads import DownsampleStage, FusionHead, PlainHead
from dahpe_tpu_torch.models.pose_resnet import MultiHeadPoseResNet, PoseResNet
from dahpe_tpu_torch.models.regda_baseline import RegDAPoseResNet
from dahpe_tpu_torch.models.resnet import (
    BasicBlock,
    Bottleneck,
    Conv2d,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    wide_resnet50_2,
    wide_resnet101_2,
)
from dahpe_tpu_torch.models.upsampling import ConvTranspose2dTorch, Upsampling

BACKBONES = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnext50_32x4d": resnext50_32x4d,
    "resnext101_32x8d": resnext101_32x8d,
    "wide_resnet50_2": wide_resnet50_2,
    "wide_resnet101_2": wide_resnet101_2,
}


def get_backbone(name: str, dtype=None):
    """Build the backbone named ``name`` (the ``-a/--arch`` flag) with the
    compute dtype ``dtype`` (``None``: float32; ``torch.bfloat16`` for
    ``--bf16``)."""
    try:
        ctor = BACKBONES[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; choices: {sorted(BACKBONES)}"
        ) from None
    return ctor(dtype=dtype)


__all__ = [
    "BACKBONES",
    "get_backbone",
    "BasicBlock",
    "BatchNorm2d",
    "Bottleneck",
    "Conv2d",
    "DownsampleStage",
    "FusionHead",
    "PlainHead",
    "MultiHeadPoseResNet",
    "PoseResNet",
    "RegDAPoseResNet",
    "ResNet",
    "ConvTranspose2dTorch",
    "Upsampling",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "resnext50_32x4d",
    "resnext101_32x8d",
    "wide_resnet50_2",
    "wide_resnet101_2",
]
