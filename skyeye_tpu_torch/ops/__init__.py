"""Tensor ops of the port: boxes, device letterbox, NMS and the Hopper kernels'
wrappers (``nms_kernel``, ``attention_kernel``, ``csp_kernel``, ``fused_csp``)."""
from .boxes import box_iou, clip_boxes, scale_boxes, xywh2xyxy, xyxy2xywh
from .letterbox import letterbox_batch, letterbox_params
from .nms import (
    EVAL_MAX_NMS,
    SERVING_MAX_NMS,
    greedy_nms,
    greedy_nms_batched,
    nms_batched,
    nms_single,
    non_max_suppression,
    serving_max_nms,
    suppress_candidates,
    suppress_candidates_batched,
)

__all__ = [
    "box_iou", "clip_boxes", "scale_boxes", "xywh2xyxy", "xyxy2xywh",
    "letterbox_batch", "letterbox_params",
    "EVAL_MAX_NMS", "SERVING_MAX_NMS", "greedy_nms", "greedy_nms_batched", "nms_batched",
    "nms_single", "non_max_suppression", "serving_max_nms", "suppress_candidates",
    "suppress_candidates_batched",
]
