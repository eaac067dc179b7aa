"""Data of the port: image files (``imageio``), host augmentation (``augment``),
the YOLO-format dataset and its batch loader (``dataset``), and the copy of
batches to the card (``prefetch``)."""
from .augment import (
    AerialAugmentation,
    AerialAugmentor,
    augment_hsv,
    box_candidates,
    cutout,
    flip_lr,
    flip_ud,
    mixup,
    random_perspective,
)

__all__ = [
    "AerialAugmentation",
    "AerialAugmentor",
    "augment_hsv",
    "box_candidates",
    "cutout",
    "flip_lr",
    "flip_ud",
    "mixup",
    "random_perspective",
]
