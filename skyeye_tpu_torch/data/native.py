"""JAX's native host prep: decode, letterbox and 4x4 pack of a batch of files.

Port of ``skyeye_tpu/data/native.py`` over ``native/skyeye_prep.cc``, JAX's C++
thread pool that decodes JPEG (libjpeg) and PNG (libpng) files and letterboxes
them straight into one NHWC uint8 batch, or into the 4x4 space-to-depth layout
of the packed stem:

  ``prep_batch``       (n, out_h, out_w, 3) RGB uint8, pad 114, and meta
                       (n, 3) float32 ``[gain, dw, dh]``, and the count decoded
  ``prep_batch_s2d4``  (n, S/4, S/4, 48), channel ``(dy * 4 + dx) * 3 + c``
  ``decode_shape``     (h, w) of a file JAX's library decodes, else None

A file decodes as libjpeg and libpng read it for JAX's library, with the
port's own codecs: ``.png`` (any case) as PNG, with libpng's expand,
strip_16, strip_alpha and gray_to_rgb (``imageio.png_rgb``; an ancillary
chunk with a bad CRC dropped, a palette index past PLTE black), Adam7
included; anything else as JPEG (``jpeg.decode_coefficients(lenient=True)``:
baseline or progressive, damaged data read as libjpeg reads it, gray
repeated to RGB, no EXIF orientation). A frame that does not decode (missing,
corrupt, a kind the port does not read) is zeroed with ``meta[0] == 0`` and
not counted.

The letterbox is JAX's own geometry, not OpenCV's: ``r = min(oh / h, ow / w)``
in float32, ``lround`` sizes and offsets, half-pixel centres, a float32
bilinear blend, ``+ 0.5`` and truncation. JAX's library was built with FMA
contraction (``-O3 -march=native``): the sample positions ``(y + 0.5) * s - 0.5``,
both horizontal lerps and the vertical blend are fused multiply-adds, so both
versions here compute them as such (``fmaf`` in C, ``augment._fma32`` here).

Where CUDA is available (the card's machine) a batch runs in host C,
``csrc/prep.cu``: Python reads each file and inflates each PNG's data (zlib
lets go of the GIL) on ``n_threads`` threads, then one C call decodes, unfilters,
letterboxes and packs every frame on a ``std::thread`` pool of
``max(1, min(n_threads or 8, n))`` workers. Elsewhere the numpy version here
(``prep_batch_plain``) gives the same bytes. A failed build raises; there is
no quiet fall-back.

``ENABLED`` is the switch JAX's callers read through ``native_available()``:
set it to False to take JAX's Python path (``BatchLoader`` decodes with
``imageio.imread`` and resizes with INTER_AREA, ``predict_files`` is
``__call__``), as JAX does where its library does not load.
"""
from __future__ import annotations

import ctypes
import functools
import platform
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import imageio, jpeg
from .augment import _fma32
from .imageio import ImageFormatError

ENABLED = True
PAD = 114
SUFFIXES = ("jpg", "jpeg", "png")  # what JAX's loader sends to the native path
_F32 = np.float32
_DECODE_ERRORS = (ImageFormatError, NotImplementedError, struct.error, IndexError, OSError)


# -- decode ------------------------------------------------------------------------

def _is_png(path) -> bool:
    return str(path).lower().endswith(".png")


def decode_rgb_plain(path) -> Optional[np.ndarray]:
    """The (H, W, 3) uint8 RGB image JAX's library decodes from ``path``, or None
    where it fails (module doc)."""
    try:
        data = Path(path).read_bytes()
        if _is_png(path):
            png = imageio.png_parse(data, strict=False)
            img = imageio.png_rgb(png, imageio.png_samples(png, native=False), strict=False)
        else:
            bgr = jpeg.reconstruct(*jpeg.decode_coefficients(data, lenient=True))
            img = bgr[:, :, ::-1]
    except _DECODE_ERRORS:
        return None
    return np.ascontiguousarray(img)


# -- letterbox ---------------------------------------------------------------------

def _round_half_away(x) -> np.ndarray:
    """``std::lround`` of float32 values."""
    x = np.asarray(x, np.float64)
    return (np.sign(x) * np.floor(np.abs(x) + 0.5)).astype(np.int64)


def letterbox_params(h: int, w: int, out_h: int, out_w: int):
    """JAX's native geometry: (r, new_h, new_w, dh, dw, y0, x0), r/dh/dw float32."""
    r = min(_F32(out_h) / _F32(h), _F32(out_w) / _F32(w))
    new_w = int(_round_half_away(_F32(w) * r))
    new_h = int(_round_half_away(_F32(h) * r))
    dw, dh = _F32(out_w - new_w) / _F32(2), _F32(out_h - new_h) / _F32(2)
    x0 = int(_round_half_away(dw - _F32(0.1)))
    y0 = int(_round_half_away(dh - _F32(0.1)))
    return r, new_h, new_w, dh, dw, y0, x0


def _taps(size: int, new: int):
    """(first tap, second tap, weight) of each output position along one axis:
    ``f = fma(i + 0.5, size / new, -0.5)`` truncated and clamped."""
    scale = _F32(size) / _F32(new)
    f = _fma32(np.arange(new, dtype=_F32) + _F32(0.5), scale, _F32(-0.5))
    i0 = np.clip(np.trunc(f).astype(np.int64), 0, size - 1)
    i1 = np.minimum(i0 + 1, size - 1)
    wgt = np.clip(f - i0.astype(_F32), _F32(0), _F32(1)).astype(_F32)
    return i0, i1, wgt


def letterbox_plain(img: np.ndarray, out_h: int, out_w: int,
                    out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """``letterbox_into``: (H, W, 3) uint8 -> (out_h, out_w, 3) uint8 at pad 114
    and meta ``[gain, dw, dh]`` float32."""
    h, w = img.shape[:2]
    r, new_h, new_w, dh, dw, y0, x0 = letterbox_params(h, w, out_h, out_w)
    if out is None:
        out = np.empty((out_h, out_w, 3), np.uint8)
    out[...] = PAD
    iy0, iy1, wy = _taps(h, new_h)
    ix0, ix1, wx = _taps(w, new_w)
    wx = wx[None, :, None]
    row0, row1 = img[iy0].astype(np.int32), img[iy1].astype(np.int32)
    top = _fma32(wx, (row0[:, ix1] - row0[:, ix0]).astype(_F32), row0[:, ix0].astype(_F32))
    bot = _fma32(wx, (row1[:, ix1] - row1[:, ix0]).astype(_F32), row1[:, ix0].astype(_F32))
    val = _fma32(wy[:, None, None], bot - top, top) + _F32(0.5)
    out[y0: y0 + new_h, x0: x0 + new_w] = val.astype(np.int32).astype(np.uint8)
    return out, np.array([r, dw, dh], _F32)


def s2d4_pack(frames: np.ndarray) -> np.ndarray:
    """(..., S, S, 3) -> (..., S/4, S/4, 48), channel (dy * 4 + dx) * 3 + c."""
    *lead, s, _, c = frames.shape
    y = frames.reshape(*lead, s // 4, 4, s // 4, 4, c)
    return np.ascontiguousarray(np.moveaxis(y, -4, -3).reshape(*lead, s // 4, s // 4, 16 * c))


def prep_batch_plain(paths: Sequence, out_h: int, out_w: int,
                     out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """``prep_batch`` in numpy, one frame after another."""
    n = len(paths)
    out = _check_out(out, (n, out_h, out_w, 3))
    meta = np.zeros((n, 3), _F32)
    n_ok = 0
    for i, path in enumerate(paths):
        img = decode_rgb_plain(path)
        if img is None or img.size == 0:
            out[i] = 0
            continue
        _, meta[i] = letterbox_plain(img, out_h, out_w, out[i])
        n_ok += 1
    return out, meta, n_ok


# -- the host C version ------------------------------------------------------------

class _Source(ctypes.Structure):
    """One frame for ``csrc/prep.cu``: a JPEG file's bytes, or a PNG's header,
    palette and inflated image data; kind 0 where Python already failed."""

    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_int64),
                ("kind", ctypes.c_int32), ("width", ctypes.c_int32),
                ("height", ctypes.c_int32), ("depth", ctypes.c_int32),
                ("color_type", ctypes.c_int32), ("interlace", ctypes.c_int32),
                ("palette", ctypes.c_void_p), ("palette_size", ctypes.c_int32)]


KIND_FAILED, KIND_JPEG, KIND_PNG = 0, 1, 2


def host_flags() -> Tuple[str, ...]:
    """``prep.cu``'s own flags: its fused multiply-adds are written as ``fmaf``
    and nothing else may be contracted (``-ffp-contract=off``); on x86-64,
    ``-mfma`` makes ``fmaf`` one instruction rather than a call."""
    flags = ("-Xcompiler", "-ffp-contract=off")
    if platform.machine() in ("x86_64", "AMD64"):
        flags += ("-Xcompiler", "-mfma")
    return flags


@functools.cache
def prep_library():
    """Build (at first use) and bind ``csrc/prep.cu``, once per process."""
    from ..ops.cuda_build import load_library

    built = load_library("prep.cu", extra_flags=host_flags())
    src, ptr, i32 = ctypes.POINTER(_Source), ctypes.c_void_p, ctypes.c_int
    built.lib.skyeye_prep_batch.argtypes = [src, i32, ptr, i32, i32, i32, ptr, i32]
    built.lib.skyeye_prep_batch.restype = i32
    built.lib.skyeye_decode_shape.argtypes = [src, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    built.lib.skyeye_decode_shape.restype = i32
    return built


def _read_source(path) -> Tuple[_Source, tuple]:
    """A ``_Source`` for ``path`` and the buffers it points into (kept alive by
    the caller). PNG chunks are walked and IDAT inflated here."""
    try:
        data = Path(path).read_bytes()
        if not _is_png(path):
            buf = np.frombuffer(data, np.uint8)
            return _Source(buf.ctypes.data, len(buf), KIND_JPEG), (buf,)
        png = imageio.png_parse(data, strict=False)
    except _DECODE_ERRORS:
        return _Source(None, 0, KIND_FAILED), ()
    raw = np.frombuffer(png.raw, np.uint8)
    pal = (np.ascontiguousarray(png.palette) if png.palette is not None
           else np.zeros((0, 3), np.uint8))
    src = _Source(raw.ctypes.data if len(raw) else None, len(raw), KIND_PNG, png.width,
                  png.height, png.depth, png.color_type, png.interlace,
                  pal.ctypes.data if len(pal) else None, len(pal))
    return src, (raw, pal)


def _sources(paths: Sequence, n_threads: int):
    workers = max(1, min(n_threads if n_threads > 0 else 8, len(paths)))
    if workers == 1:
        read = [_read_source(p) for p in paths]
    else:
        with ThreadPoolExecutor(workers) as ex:
            read = list(ex.map(_read_source, paths))
    arr = (_Source * len(paths))(*(s for s, _ in read))
    return arr, [keep for _, keep in read]


def _prep_native(paths: Sequence, out: np.ndarray, out_h: int, out_w: int, n_threads: int,
                 s2d4: bool) -> Tuple[np.ndarray, np.ndarray, int]:
    n = len(paths)
    meta = np.zeros((n, 3), _F32)
    if n == 0:
        return out, meta, 0
    arr, keep = _sources(paths, n_threads)
    n_ok = prep_library().lib.skyeye_prep_batch(arr, n, out.ctypes.data, out_h, out_w,
                                                n_threads, meta.ctypes.data, int(s2d4))
    del keep
    return out, meta, int(n_ok)


# -- JAX's API -----------------------------------------------------------------------

def _use_native(native: Optional[bool]) -> bool:
    return torch.cuda.is_available() if native is None else native


def _check_out(out: Optional[np.ndarray], shape) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.uint8)
    if out.shape != tuple(shape) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape {tuple(shape)}, "
                         f"got {out.dtype} {out.shape}")
    return out


def prep_batch(paths: List[str], out_h: int, out_w: int, n_threads: int = 8,
               out: Optional[np.ndarray] = None, native: Optional[bool] = None
               ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Decode + letterbox a batch of image files. Returns (batch (n, out_h,
    out_w, 3) RGB uint8, meta (n, 3) [gain, dw, dh], n_decoded). ``native``:
    the host C (built at first use) or ``prep_batch_plain``; by default the C
    where CUDA is available."""
    if not _use_native(native):
        return prep_batch_plain(paths, out_h, out_w, out)
    out = _check_out(out, (len(paths), out_h, out_w, 3))
    return _prep_native(paths, out, out_h, out_w, n_threads, False)


def prep_batch_s2d4(paths: List[str], out_s: int, n_threads: int = 8,
                    native: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Decode + letterbox + 4x4 space-to-depth pack: (batch (n, out_s/4, out_s/4,
    48) uint8 in the packed-stem layout, meta, n_decoded), equal to
    ``s2d4_pack(prep_batch(...)[0])``."""
    if out_s % 4:
        raise ValueError(f"out_s must be a multiple of 4, got {out_s}")
    n = len(paths)
    if not _use_native(native):
        frames, meta, n_ok = prep_batch_plain(paths, out_s, out_s)
        return s2d4_pack(frames), meta, n_ok
    out = np.empty((n, out_s // 4, out_s // 4, 48), np.uint8)
    return _prep_native(paths, out, out_s, out_s, n_threads, True)


def decode_shape(path, native: Optional[bool] = None) -> Optional[Tuple[int, int]]:
    """(h, w) of the image JAX's library decodes from ``path`` (the whole file
    is decoded, as there), or None where that fails."""
    if not _use_native(native):
        img = decode_rgb_plain(path)
        return None if img is None or img.size == 0 else img.shape[:2]
    arr, keep = _sources([path], 1)
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = prep_library().lib.skyeye_decode_shape(arr, ctypes.byref(h), ctypes.byref(w))
    del keep
    return None if rc else (h.value, w.value)
