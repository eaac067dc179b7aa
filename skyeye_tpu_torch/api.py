"""Serving API: ``SkyEyeDetector`` facade and ``Results`` container.

Port of the serving part of ``skyeye_tpu/api.py``: uint8 frames -> device
letterbox and /255 -> detector -> decode -> exact candidate cut -> greedy NMS
(one launch of the hand-written kernel per batch) -> boxes rescaled to each
frame. Frames are grouped by shape and run in power-of-two batch buckets.
Everything runs on the device the detector was built for; CUDA is the default.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import ModelConfig
from .models.detector import create_detector
from .models.head import decode_predictions
from .ops.letterbox import letterbox_batch, letterbox_params
from .ops.nms import nms_batched, serving_max_nms
from .utils.general import LOGGER, check_img_size, resolve_device


class Results:
    """Detections for a batch of images: per image (n, 6) [x1, y1, x2, y2, conf, cls]."""

    def __init__(self, detections: List[np.ndarray], images: List[np.ndarray],
                 paths: List[str], names: Sequence[str], times: Dict[str, float]):
        self.detections = detections
        self.images = images  # original BGR frames
        self.paths = paths
        self.names = list(names)
        self.times = times    # ms per image

    def __len__(self) -> int:
        return len(self.detections)

    @property
    def xyxy(self) -> List[np.ndarray]:
        return self.detections

    @property
    def xywh(self) -> List[np.ndarray]:
        out = []
        for det in self.detections:
            d = det.copy()
            if len(d):
                d[:, 0] = (det[:, 0] + det[:, 2]) / 2
                d[:, 1] = (det[:, 1] + det[:, 3]) / 2
                d[:, 2] = det[:, 2] - det[:, 0]
                d[:, 3] = det[:, 3] - det[:, 1]
            out.append(d)
        return out

    def print(self) -> None:
        for i, det in enumerate(self.detections):
            counts: Dict[int, int] = {}
            for c in det[:, 5].astype(int) if len(det) else []:
                counts[c] = counts.get(c, 0) + 1
            s = ", ".join(
                f"{n} {self.names[c] if c < len(self.names) else c}{'s' if n > 1 else ''}"
                for c, n in counts.items()
            )
            LOGGER.info("image %d/%d: %s", i + 1, len(self.detections), s or "no detections")


class SkyEyeDetector:
    """User-facing detector: build from a config with seeded weights, or load a
    ``state_dict`` (e.g. from ``utils.checkpoint.from_jax_variables``), and call
    it on HWC BGR uint8 frames."""

    def __init__(self, cfg: Union[str, dict, ModelConfig] = "skyeye_s",
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 num_classes: Optional[int] = None, img_size: int = 640,
                 conf_thres: float = 0.25, iou_thres: float = 0.45, max_det: int = 300,
                 names: Optional[Sequence[str]] = None,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        self.device = resolve_device(device)
        self.model = create_detector(cfg, num_classes=num_classes, device=self.device,
                                     seed=seed)
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.config = self.model.config
        self.stride = int(max(self.config.strides))
        self.img_size = check_img_size(img_size, self.stride)
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        self.max_det = max_det
        self.names = list(names) if names else [str(i) for i in range(self.config.nc)]
        # Called with each stage's name as the stage is issued (host_prep,
        # host_to_device, letterbox, model, decode, nms, device_to_host, rescale);
        # a caller that synchronizes in it can time the stages of a real request.
        self.on_stage: Optional[Callable[[str], None]] = None

    def _stage(self, name: str) -> None:
        if self.on_stage is not None:
            self.on_stage(name)

    @torch.inference_mode()
    def infer(self, frames: torch.Tensor, out_shape: Tuple[int, int], multi_label: bool = False,
              agnostic: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8 RGB frames on the detector's device ->
        ((B, max_det, 6) detections in letterboxed pixels, (B,) counts)."""
        x = letterbox_batch(frames, out_shape) / 255.0
        self._stage("letterbox")
        outs = self.model(x.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
        self._stage("model")
        dec = decode_predictions(outs, self.config.anchors, out_shape, anchor_major=False)
        self._stage("decode")
        out = nms_batched(dec, conf_thres=self.conf_thres, iou_thres=self.iou_thres,
                          multi_label=multi_label, agnostic=agnostic, max_det=self.max_det,
                          max_nms=serving_max_nms(self.conf_thres))
        self._stage("nms")
        return out

    @staticmethod
    def _batch_buckets(n: int, cap: int = 16) -> List[int]:
        """Split n items into power-of-two batch sizes up to cap."""
        sizes = []
        while n >= cap:
            sizes.append(cap)
            n -= cap
        b = 1
        while n > 0:
            if n & b:
                sizes.append(b)
                n -= b
            b <<= 1
        return sorted(sizes, reverse=True)

    def __call__(self, source, size: Optional[int] = None, multi_label: bool = False,
                 agnostic: bool = False) -> Results:
        """Detect on one HWC BGR uint8 frame or a list of them."""
        imgs = list(source) if isinstance(source, (list, tuple)) else [source]
        for im in imgs:
            if not isinstance(im, np.ndarray):
                raise TypeError("SkyEyeDetector takes HWC BGR uint8 numpy frames; "
                                f"got {type(im).__name__}")
        paths = [f"array{i}.jpg" for i in range(len(imgs))]
        out_size = check_img_size(size or self.img_size, self.stride)

        t0 = time.perf_counter()
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, im in enumerate(imgs):
            groups.setdefault(im.shape[:2], []).append(i)

        detections: List[Optional[np.ndarray]] = [None] * len(imgs)
        t_infer = 0.0
        for shape, idxs in groups.items():
            gain, dw, dh = letterbox_params(shape, (out_size, out_size))
            pos = 0
            for bs in self._batch_buckets(len(idxs)):
                chunk = idxs[pos : pos + bs]
                pos += bs
                batch = np.ascontiguousarray(np.stack([imgs[i][:, :, ::-1] for i in chunk]))
                self._stage("host_prep")
                t1 = time.perf_counter()
                x = torch.from_numpy(batch).to(self.device)
                self._stage("host_to_device")
                det, n = self.infer(x, (out_size, out_size), multi_label, agnostic)
                det, n = det.cpu().numpy(), n.cpu().numpy()
                self._stage("device_to_host")
                t_infer += time.perf_counter() - t1
                for k, i in enumerate(chunk):
                    detections[i] = _rescale(det[k, : n[k]].copy(), gain, dw, dh, shape)
                self._stage("rescale")
        total = time.perf_counter() - t0
        times = {
            "inference_ms": t_infer / max(len(imgs), 1) * 1000,
            "total_ms": total / max(len(imgs), 1) * 1000,
        }
        return Results(detections, imgs, paths, self.names, times)


def _rescale(d: np.ndarray, gain: float, dw: float, dh: float, shape) -> np.ndarray:
    """Letterboxed xyxy -> the frame's pixels, clipped to the frame."""
    if len(d):
        d[:, [0, 2]] = np.clip((d[:, [0, 2]] - dw) / gain, 0, shape[1])
        d[:, [1, 3]] = np.clip((d[:, [1, 3]] - dh) / gain, 0, shape[0])
    return d
