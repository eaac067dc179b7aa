"""Inference sources: ``LoadImages`` over image files, folders and globs.

Port of ``skyeye_tpu/data/loaders.py:41-119``. Each iteration yields
``(path, img, img0, vid_cap, s)``: ``img0`` the frame as read (BGR, through
``data.imageio.imread``, which reads PNG, BMP and JPEG as ``cv2.imread``
does), ``img`` its host letterbox (``ops.letterbox.letterbox``, equal to
JAX's cv2 letterbox) in RGB, contiguous. JAX opens videos, webcams and
streams with ``cv2.VideoCapture``; the port has no video decoder, so a
video file in the source, ``LoadWebcam`` and ``LoadStreams`` raise
NotImplementedError (ROADMAP.md, Queue 1 item 14).
"""
from __future__ import annotations

import glob
import os
from pathlib import Path

import numpy as np

from ..ops.letterbox import letterbox
from .dataset import IMG_FORMATS, VID_FORMATS
from .imageio import imread

VIDEO_NOT_PORTED = ("video files, webcams and streams are not in the port yet: it has no "
                    "video decoder (ROADMAP.md, Queue 1 item 14)")


def _prep(img0: np.ndarray, img_size, stride: int, auto: bool) -> np.ndarray:
    img = letterbox(img0, img_size, stride=stride, auto=auto)[0]
    return np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB


class LoadImages:
    """Iterate image files, directories and globs, in JAX's order."""

    def __init__(self, path, img_size=640, stride: int = 32, auto: bool = False):
        p = str(Path(path).resolve())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif os.path.isdir(p):
            files = sorted(glob.glob(os.path.join(p, "*.*")))
        elif os.path.isfile(p):
            files = [p]
        else:
            raise FileNotFoundError(f"{p} does not exist")

        images = [f for f in files if f.split(".")[-1].lower() in IMG_FORMATS]
        videos = [f for f in files if f.split(".")[-1].lower() in VID_FORMATS]
        if videos:
            raise NotImplementedError(f"{videos[0]}: {VIDEO_NOT_PORTED}")
        self.img_size = img_size
        self.stride = stride
        self.auto = auto
        self.files = images
        self.nf = len(self.files)
        self.mode = "image"
        self.frame = 0
        self.cap = None
        if self.nf == 0:
            raise FileNotFoundError(
                f"no images or videos found in {p} (supported: {IMG_FORMATS} {VID_FORMATS})")

    def __iter__(self):
        self.count = 0
        return self

    def __next__(self):
        if self.count == self.nf:
            raise StopIteration
        path = self.files[self.count]
        self.count += 1
        img0 = imread(path)
        s = f"image {self.count}/{self.nf} {path}: "
        return path, _prep(img0, self.img_size, self.stride, self.auto), img0, self.cap, s

    def __len__(self):
        return self.nf


class LoadWebcam:
    """JAX's single-webcam loader; the port cannot open a camera."""

    def __init__(self, pipe="0", img_size=640, stride: int = 32):
        raise NotImplementedError(VIDEO_NOT_PORTED)


class LoadStreams:
    """JAX's multi-stream loader; the port cannot open a stream."""

    def __init__(self, sources="streams.txt", img_size=640, stride: int = 32,
                 auto: bool = True, vid_stride: int = 1):
        raise NotImplementedError(VIDEO_NOT_PORTED)
