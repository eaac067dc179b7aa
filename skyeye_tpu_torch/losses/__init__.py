"""Detection losses of the port: YOLOv5-convention ComputeLoss and the aerial loss."""
from .detection import (
    AerialDetectionLoss,
    ComputeLoss,
    bce_with_logits,
    build_targets_level,
    focal_loss,
    masked_mean,
    modulated_bce,
    smooth_bce,
)

__all__ = ["AerialDetectionLoss", "ComputeLoss", "bce_with_logits", "build_targets_level",
           "focal_loss", "masked_mean", "modulated_bce", "smooth_bce"]
