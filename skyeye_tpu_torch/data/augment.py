"""Host image augmentation for the training loader, in numpy, without OpenCV.

Port of ``skyeye_tpu/data/augment.py``: ``augment_hsv`` (HSV jitter through
lookup tables), ``build_affine_matrix`` and ``random_perspective`` (the
T·S·R·P·C warp with its box transform and candidate filter), ``flip_lr`` /
``flip_ud``, ``mixup`` (Beta(8, 8) blend), ``cutout`` and the
``AerialAugmentor`` facade. Every draw comes from the ``random.Random`` and
``np.random.Generator`` the caller passes, in JAX's order, so a seed gives
JAX's draws.

JAX reaches OpenCV for the pixel work. Its arithmetic is reproduced here, so
the pixels are OpenCV 5.0.0's bit for bit:

  * ``_bgr_to_hsv``: ``cvtColor(COLOR_BGR2HSV)`` on uint8, the classic integer
    version (12-bit fixed point, division tables rounded from double);
  * ``_hsv_to_bgr``: ``cvtColor(COLOR_HSV2BGR)`` on uint8, in float32: s and v
    scaled by the float32 1/255, hue by 6/180, the two sector terms
    ``v * fma(-s, t, 1)`` fused, and the result truncated (not rounded) after
    ``* 255``, except in the last ``width % 32`` pixels of a row, which
    OpenCV's scalar loop rounds to nearest;
  * ``_warp_affine`` / ``_warp_perspective``: ``warpAffine`` /
    ``warpPerspective`` with ``INTER_LINEAR`` and ``BORDER_CONSTANT``. M is
    inverted in double (the affine closed form; the 3x3 adjugate over the
    determinant), cast to float32; a row's offset ``y * m1 + m2`` is a float32
    product and sum, and each pixel's source coordinate is ``fma(m0, x,
    offset)`` (divided by ``fma(m6, x, y * m7 + m8)`` for a perspective); the
    last ``width % 16`` columns of a row take OpenCV's scalar order,
    ``fma(x, m0, y * m1) + m2``. The bilinear value is three float32 fused
    lerps, ``fma(a, p1 - p0, p0)`` along x on both rows, then along y, rounded
    to nearest even; a tap outside the image reads the border value;
  * ``_rotation_matrix``: ``getRotationMatrix2D`` about (0, 0), the angle
    times ``CV_PI / 180`` and ``cos``/``sin`` in double.

``_fma32`` is a float32 fused multiply-add, computed in float64 and rounded
once (round to odd, then to float32).
"""
from __future__ import annotations

import math
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..config import DEFAULT_HYP

BORDER_VALUE = 114
_F32 = np.float32
_SCALAR_TAIL = 16  # columns per vector step of OpenCV's warp (AVX2: 2 x 8 floats)
_HSV_VECTOR = 32  # pixels per vector step of OpenCV's HSV2BGR (AVX2: 4 x 8 floats)


# -- OpenCV's arithmetic ------------------------------------------------------------


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add gives it.

    The float64 product of two float32 is exact; where the float64 sum is not
    (its two-sum error is not 0), it is made round-to-odd, so that rounding it
    to float32 rounds the exact value once."""
    p = np.multiply(np.asarray(a, _F32), np.asarray(b, _F32), dtype=np.float64)
    c = np.asarray(c, _F32).astype(np.float64)
    s = p + c
    t = s - p
    err = np.subtract(p, s - t)
    err += np.subtract(c, t, out=t)
    inexact = np.flatnonzero(err)
    if inexact.size:
        bits = s.reshape(-1).view(np.int64)
        b, e, v = bits[inexact], err.reshape(-1)[inexact], s.reshape(-1)[inexact]
        bits[inexact] = b + ((b & 1) == 0) * np.where((e > 0) == (v > 0), 1, -1)
    return s.astype(_F32)


_HSV_SHIFT = 12
_SDIV = np.array([0] + [round((255 << _HSV_SHIFT) / i) for i in range(1, 256)], np.int32)
_HDIV = np.array([0] + [round((180 << _HSV_SHIFT) / (6.0 * i)) for i in range(1, 256)],
                 np.int32)
# tab index of (b, g, r) for each hue sector: tab = (v, v(1-s), v(1-s t), v(1-s(1-t)))
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def _bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` for uint8 BGR: hue in [0, 180)."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))  # products < 2**31
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def _hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` for uint8 HSV with hue in [0, 180)."""
    one = _F32(1)
    h = hsv[..., 0].astype(_F32) * (_F32(6.0) / _F32(180))
    s = hsv[..., 1].astype(_F32) * _F32(1.0 / 255.0)
    v = hsv[..., 2].astype(_F32) * _F32(1.0 / 255.0)
    sector = np.trunc(h)
    t = h - sector
    tab = np.stack([v, v * (one - s), v * _fma32(-s, t, one), v * _fma32(-s, one - t, one)])
    sector = (sector - np.trunc(sector * _F32(1.0 / 6.0)) * 6).astype(np.intp)
    pix = np.arange(sector.size).reshape(sector.shape)
    bgr = np.stack([tab.reshape(-1)[_SECTOR[sector, c] * sector.size + pix] for c in range(3)],
                   -1) * _F32(255)
    vec = hsv.shape[1] - hsv.shape[1] % _HSV_VECTOR  # a row's scalar tail rounds
    bgr = np.concatenate([np.trunc(bgr[:, :vec]), np.rint(bgr[:, vec:])], 1)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def _rotation_matrix(angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center=(0, 0), angle, scale)``: (2, 3) float64."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, 0.0], [-beta, alpha, 0.0]])


def _invert_affine(m: np.ndarray) -> list:
    """The inverse of a (2, 3) affine map, as ``warpAffine`` computes it (double)."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)[:6]]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _invert_3x3(m: np.ndarray) -> list:
    """``cv::invert(DECOMP_LU)`` of a 3x3 double matrix: adjugate / determinant."""
    s = [[float(v) for v in row] for row in np.asarray(m, np.float64)]
    det = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
           - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
           + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if det == 0:
        return [0.0] * 9
    d = 1.0 / det
    return [(s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d,
            (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
            (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d,
            (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
            (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d,
            (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
            (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d,
            (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
            (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d]


def _source_coords(m: Sequence[float], width: int, height: int) -> Tuple[np.ndarray, ...]:
    """Float32 source x and y of every destination pixel, in OpenCV's order;
    ``m`` is the inverse map, 6 (affine) or 9 (perspective) numbers."""
    m = [_F32(v) for v in m]
    x = np.arange(width, dtype=_F32)[None, :]
    y = np.arange(height, dtype=_F32)[:, None]
    vec = width - width % _SCALAR_TAIL
    xv, xt = x[:, :vec], x[:, vec:]

    def row(i):  # vector columns, then the scalar tail
        return np.concatenate([_fma32(m[i], xv, y * m[i + 1] + m[i + 2]),
                               _fma32(xt, m[i], y * m[i + 1]) + m[i + 2]], 1)

    sx, sy = row(0), row(3)
    if len(m) == 9:
        w = row(6)
        with np.errstate(divide="ignore", invalid="ignore"):
            sx, sy = sx / w, sy / w
    return sx, sy


def _lerp(a: np.ndarray, p0: np.ndarray, p1: np.ndarray, exact_sum: bool) -> np.ndarray:
    """float32 ``fma(a, p1 - p0, p0)`` for integer taps p0, p1 in [0, 255].

    ``exact_sum``: every nonzero ``a`` is the fraction of a coordinate of at
    least 2**-21, so ``a`` is a multiple of 2**-44 and the float64 sum, below
    2**9, is exact: one rounding to float32 is the fused result."""
    d = p1 - p0
    if not exact_sum:
        return _fma32(a, d, p0)
    s = np.multiply(a, d, dtype=np.float64)
    s += p0
    return s.astype(_F32)


def _bilinear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
              border_value: float) -> np.ndarray:
    """OpenCV 5's float32 bilinear sampling of an (h, w, c) uint8 image at (sx, sy)."""
    h, w = img.shape[:2]
    fin = np.isfinite(sx) & np.isfinite(sy)
    sx = np.where(fin, sx, _F32(-2))
    sy = np.where(fin, sy, _F32(-2))
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix = np.clip(fx, -2, w).astype(np.intp)  # out there, both taps are border
    iy = np.clip(fy, -2, h).astype(np.intp)
    pad = np.full((h + 4, w + 4) + img.shape[2:], border_value, np.uint8)
    pad[2:h + 2, 2:w + 2] = img
    pad = pad.reshape((h + 4) * (w + 4), -1)
    base = (iy + 2) * (w + 4) + (ix + 2)
    p00, p01 = pad[base].astype(_F32), pad[base + 1].astype(_F32)
    p10, p11 = pad[base + w + 4].astype(_F32), pad[base + w + 5].astype(_F32)
    exact_sum = not ((sx != 0) & (np.abs(sx) < 2.0 ** -21)).any()
    top = _lerp(ax, p00, p01, exact_sum)
    bottom = _lerp(ax, p10, p11, exact_sum)
    out = np.clip(np.rint(_fma32(ay, bottom - top, top)), 0, 255).astype(np.uint8)
    return out.reshape(sx.shape + img.shape[2:])


def _warp_affine(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                 border_value: float = BORDER_VALUE) -> np.ndarray:
    """``cv2.warpAffine(img, m, dsize, borderValue=(v, v, v))``, INTER_LINEAR."""
    sx, sy = _source_coords(_invert_affine(m), dsize[0], dsize[1])
    return _bilinear(img, sx, sy, border_value)


def _warp_perspective(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int],
                      border_value: float = BORDER_VALUE) -> np.ndarray:
    """``cv2.warpPerspective(img, m, dsize, borderValue=(v, v, v))``, INTER_LINEAR."""
    sx, sy = _source_coords(_invert_3x3(m), dsize[0], dsize[1])
    return _bilinear(img, sx, sy, border_value)


# -- augmentations ------------------------------------------------------------------------


def hsv_gains(hgain: float = 0.015, sgain: float = 0.7, vgain: float = 0.4,
              rng: Optional[random.Random] = None) -> Optional[np.ndarray]:
    """``augment_hsv``'s draws: the three gains (None, and no draw, when all are 0)."""
    if not (hgain or sgain or vgain):
        return None
    rng = rng or random
    return np.array([rng.uniform(-1, 1) for _ in range(3)]) * [hgain, sgain, vgain] + 1


def apply_hsv(img: np.ndarray, r: Optional[np.ndarray]) -> np.ndarray:
    """``augment_hsv``'s pixels for the gains ``r``: lookup tables on H, S and V."""
    if r is None:
        return img
    hsv = _bgr_to_hsv(img)
    x = np.arange(0, 256, dtype=r.dtype)
    lut_h = ((x * r[0]) % 180).astype(img.dtype)
    lut_s = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_v = np.clip(x * r[2], 0, 255).astype(img.dtype)
    hsv = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]], lut_v[hsv[..., 2]]], -1)
    return _hsv_to_bgr(hsv)


def augment_hsv(img: np.ndarray, hgain: float = 0.015, sgain: float = 0.7,
                vgain: float = 0.4, rng: Optional[random.Random] = None) -> np.ndarray:
    """Random HSV jitter through channel lookup tables (BGR uint8 in and out)."""
    return apply_hsv(img, hsv_gains(hgain, sgain, vgain, rng))


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2.0,
                   ar_thr: float = 20.0, area_thr: float = 0.1,
                   eps: float = 1e-16) -> np.ndarray:
    """Keep warped boxes of some size, aspect ratio and retained area."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def build_affine_matrix(
    width: int,
    height: int,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, float]:
    """The T·S·R·P·C warp matrix and its scale: (3x3 matrix, s)."""
    rng = rng or random

    C = np.eye(3)
    C[0, 2] = -width / 2
    C[1, 2] = -height / 2

    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)

    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R[:2] = _rotation_matrix(a, s)

    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    T = np.eye(3)
    out_w = width + border[1] * 2
    out_h = height + border[0] * 2
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * out_w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * out_h

    M = T @ S @ R @ P @ C
    return M, s


def warp_with_matrix(img: np.ndarray, targets: Optional[np.ndarray], M: np.ndarray, s: float,
                     perspective: float = 0.0,
                     border: Tuple[int, int] = (0, 0)) -> Tuple[np.ndarray, np.ndarray]:
    """``random_perspective``'s pixels and boxes for a drawn matrix ``M`` of scale ``s``."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    targets = np.zeros((0, 5), np.float32) if targets is None else targets
    if not (np.allclose(M, np.eye(3)) and border == (0, 0)):
        if perspective:
            img = _warp_perspective(img, M, (width, height))
        else:
            img = _warp_affine(img, M[:2], (width, height))

    n = len(targets)
    if n:
        pts = np.ones((n * 4, 3))
        pts[:, :2] = targets[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
        pts = pts @ M.T
        pts = (pts[:, :2] / pts[:, 2:3] if perspective else pts[:, :2]).reshape(n, 8)

        x = pts[:, [0, 2, 4, 6]]
        y = pts[:, [1, 3, 5, 7]]
        new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)

        keep = box_candidates(box1=targets[:, 1:5].T * s, box2=new.T, area_thr=0.10)
        targets = targets[keep]
        targets[:, 1:5] = new[keep]
    return img, targets


def random_perspective(
    img: np.ndarray,
    targets: Optional[np.ndarray] = None,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
    rng: Optional[random.Random] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Affine/perspective warp of an image and its xyxy targets [cls, x1, y1, x2, y2]."""
    M, s = build_affine_matrix(img.shape[1], img.shape[0], degrees, translate, scale, shear,
                               perspective, border, rng)
    return warp_with_matrix(img, targets, M, s, perspective, border)


def flip_lr(img: np.ndarray, labels_xywhn: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip; labels are [cls, x, y, w, h] normalized."""
    img = np.ascontiguousarray(img[:, ::-1])
    if len(labels_xywhn):
        labels_xywhn = labels_xywhn.copy()
        labels_xywhn[:, 1] = 1.0 - labels_xywhn[:, 1]
    return img, labels_xywhn


def flip_ud(img: np.ndarray, labels_xywhn: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vertical flip; labels are [cls, x, y, w, h] normalized."""
    img = np.ascontiguousarray(img[::-1])
    if len(labels_xywhn):
        labels_xywhn = labels_xywhn.copy()
        labels_xywhn[:, 2] = 1.0 - labels_xywhn[:, 2]
    return img, labels_xywhn


def blend(im1: np.ndarray, im2: np.ndarray, r: float) -> np.ndarray:
    """``mixup``'s pixels for a drawn ratio ``r``."""
    return (im1 * r + im2 * (1 - r)).astype(im1.dtype)


def mixup(im1: np.ndarray, labels1: np.ndarray, im2: np.ndarray,
          labels2: np.ndarray, rng=None) -> Tuple[np.ndarray, np.ndarray]:
    """Beta(8, 8) image blend; the labels are concatenated."""
    r = (rng or np.random).beta(8.0, 8.0)
    return blend(im1, im2, r), np.concatenate([labels1, labels2], 0)


def cutout(img: np.ndarray, labels: np.ndarray, p: float = 0.5,
           rng: Optional[random.Random] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Random occlusion squares with a random colour fill (YOLOv5's convention);
    labels [cls, x, y, w, h] normalized lose boxes more than 60% covered."""
    rng = rng or random
    if rng.random() >= p:
        return img, labels
    h, w = img.shape[:2]
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16
    img = img.copy()
    for s in scales:
        mask_h = rng.randint(1, max(int(h * s), 1))
        mask_w = rng.randint(1, max(int(w * s), 1))
        xmin = max(0, rng.randint(0, w) - mask_w // 2)
        ymin = max(0, rng.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        img[ymin:ymax, xmin:xmax] = [rng.randint(64, 191) for _ in range(3)]
        if len(labels):
            box = np.array([[xmin, ymin, xmax, ymax]], np.float32)
            l_xyxy = np.stack(
                [
                    w * (labels[:, 1] - labels[:, 3] / 2),
                    h * (labels[:, 2] - labels[:, 4] / 2),
                    w * (labels[:, 1] + labels[:, 3] / 2),
                    h * (labels[:, 2] + labels[:, 4] / 2),
                ],
                1,
            )
            inter_w = np.minimum(l_xyxy[:, 2], box[0, 2]) - np.maximum(l_xyxy[:, 0], box[0, 0])
            inter_h = np.minimum(l_xyxy[:, 3], box[0, 3]) - np.maximum(l_xyxy[:, 1], box[0, 1])
            inter = np.clip(inter_w, 0, None) * np.clip(inter_h, 0, None)
            area = (l_xyxy[:, 2] - l_xyxy[:, 0]) * (l_xyxy[:, 3] - l_xyxy[:, 1]) + 1e-9
            labels = labels[inter / area < 0.6]
    return img, labels


def xywhn_to_xyxy(labels: np.ndarray, w: float, h: float, padw: float = 0.0,
                  padh: float = 0.0) -> np.ndarray:
    """[cls, x, y, w, h] normalized -> [cls, x1, y1, x2, y2] pixels (+ offsets),
    in JAX's order of operations (``w`` may be a product: ``ratio * w``)."""
    return np.stack(
        [
            labels[:, 0],
            w * (labels[:, 1] - labels[:, 3] / 2) + padw,
            h * (labels[:, 2] - labels[:, 4] / 2) + padh,
            w * (labels[:, 1] + labels[:, 3] / 2) + padw,
            h * (labels[:, 2] + labels[:, 4] / 2) + padh,
        ],
        1,
    )


def xyxy_to_xywhn(labels: np.ndarray, w: float, h: float) -> np.ndarray:
    """[cls, x1, y1, x2, y2] pixels -> [cls, x, y, w, h] normalized, float32."""
    if not len(labels):
        return np.zeros((0, 5), np.float32)
    return np.stack(
        [
            labels[:, 0],
            (labels[:, 1] + labels[:, 3]) / 2 / w,
            (labels[:, 2] + labels[:, 4]) / 2 / h,
            (labels[:, 3] - labels[:, 1]) / w,
            (labels[:, 4] - labels[:, 2]) / h,
        ],
        1,
    ).astype(np.float32)


class AerialAugmentor:
    """The single-image augmentation suite: affine, then HSV, then the flips
    (the reference's ``AerialAugmentation``), with its own seeded draws."""

    def __init__(self, hyp: Optional[Dict[str, float]] = None, seed: Optional[int] = None):
        self.hyp = dict(DEFAULT_HYP)
        if hyp:
            self.hyp.update(hyp)
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

    def __call__(self, img: np.ndarray, labels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """labels [cls, x, y, w, h] normalized, in and out."""
        h0, w0 = img.shape[:2]
        xyxy = (xywhn_to_xyxy(labels, w0, h0).astype(np.float32) if len(labels)
                else np.zeros((0, 5), np.float32))
        hyp = self.hyp
        img, xyxy = random_perspective(
            img, xyxy, degrees=hyp["degrees"], translate=hyp["translate"],
            scale=hyp["scale"], shear=hyp["shear"], perspective=hyp["perspective"],
            rng=self.rng,
        )
        img = augment_hsv(img, hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"], rng=self.rng)
        h, w = img.shape[:2]
        labels = xyxy_to_xywhn(xyxy, w, h)
        if self.rng.random() < hyp["flipud"]:
            img, labels = flip_ud(img, labels)
        if self.rng.random() < hyp["fliplr"]:
            img, labels = flip_lr(img, labels)
        return img, labels


AerialAugmentation = AerialAugmentor  # the reference's class name


class AlbumentationsWrapper:
    """The identity. JAX's wrapper runs an albumentations pipeline (blur, median
    blur, to-gray, CLAHE, ...) where that package is installed and is the
    identity where it is not; neither the machines this port runs on nor the
    ones its tests run on have it, so the port keeps only the identity."""

    def __init__(self, p: float = 1.0):
        self.p = p
        self.transform = None

    def __call__(self, img: np.ndarray, labels: np.ndarray):
        return img, labels
