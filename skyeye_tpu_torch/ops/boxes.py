"""Box coordinate utilities and pairwise IoU on torch tensors.

Port of ``skyeye_tpu/ops/boxes.py`` (``xywh2xyxy``, ``xyxy2xywh``,
``clip_boxes``, ``scale_boxes``, ``box_iou``, ``bbox_iou``); each function
works on the last axis and keeps the reference's order of operations.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) on the last axis."""
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) on the last axis."""
    x1, y1, x2, y2 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def clip_boxes(boxes: torch.Tensor, shape: Tuple[float, float]) -> torch.Tensor:
    """Clip xyxy boxes to image bounds. ``shape`` is (height, width)."""
    h, w = shape
    return torch.stack(
        [
            boxes[..., 0].clamp(0, w),
            boxes[..., 1].clamp(0, h),
            boxes[..., 2].clamp(0, w),
            boxes[..., 3].clamp(0, h),
        ],
        dim=-1,
    )


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None) -> torch.Tensor:
    """Rescale xyxy boxes from a letterboxed ``img1_shape`` back to ``img0_shape``."""
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad = (
            (img1_shape[1] - img0_shape[1] * gain) / 2,
            (img1_shape[0] - img0_shape[0] * gain) / 2,
        )
    else:
        gain = ratio_pad[0][0]
        pad = ratio_pad[1]
    boxes = torch.stack(
        [
            (boxes[..., 0] - pad[0]) / gain,
            (boxes[..., 1] - pad[1]) / gain,
            (boxes[..., 2] - pad[0]) / gain,
            (boxes[..., 3] - pad[1]) / gain,
        ],
        dim=-1,
    )
    return clip_boxes(boxes, img0_shape)


def box_iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU between two xyxy box sets: (N, 4) x (M, 4) -> (N, M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:]
    inter = (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp(min=0).prod(-1)
    area1 = (a2 - a1).clamp(min=0).prod(-1)
    area2 = (b2 - b1).clamp(min=0).prod(-1)
    return inter / (area1 + area2 - inter + eps)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, format: str = "xyxy",
             iou_type: str = "standard", eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU family between broadcast-compatible boxes, ``iou_type`` in
    {"standard", "giou", "diou", "ciou"}, with JAX's numerics: ``+eps`` on the
    heights only, and the CIoU ``alpha`` outside the gradient (JAX's
    ``stop_gradient``)."""
    if format == "xywh":
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1[..., 0], box1[..., 1], box1[..., 2], box1[..., 3]
    b2_x1, b2_y1, b2_x2, b2_y2 = box2[..., 0], box2[..., 1], box2[..., 2], box2[..., 3]

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if iou_type == "standard":
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if iou_type == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    if iou_type in ("diou", "ciou"):
        c2 = cw ** 2 + ch ** 2 + eps
        rho2 = ((b1_x1 + b1_x2 - b2_x1 - b2_x2) ** 2 + (b1_y1 + b1_y2 - b2_y1 - b2_y2) ** 2) / 4
        if iou_type == "diou":
            return iou - rho2 / c2
        v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        with torch.no_grad():
            alpha = v / (v - iou + (1 + eps))
        return iou - (rho2 / c2 + v * alpha)
    return iou
