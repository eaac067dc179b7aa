"""Small helpers shared by the port: device resolution and image-size rounding."""
from __future__ import annotations

import logging
import math
from typing import Union

import torch

LOGGER = logging.getLogger("skyeye_tpu_torch")


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device the caller asked for; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def make_divisible(x: float, divisor: int) -> int:
    """Smallest multiple of ``divisor`` that is >= x."""
    return math.ceil(x / divisor) * divisor


def check_img_size(imgsz: int, s: int = 32) -> int:
    """Round an image size up to a multiple of the stride."""
    new = make_divisible(imgsz, int(s))
    if new != imgsz:
        LOGGER.warning("img size %s must be a multiple of %d, using %s", imgsz, s, new)
    return new
