"""Image files and resizing without OpenCV or PIL, which the card's machine lacks.

The port's stand-in for what ``skyeye_tpu``'s data path takes from them:

  ``image_size``     PIL's ``Image.open(...).size`` after ``verify()``: the (w, h)
                     in a PNG, BMP or JPEG header; a PNG's chunks are walked to
                     IEND with their CRCs, so a truncated or corrupt PNG raises,
                     as ``verify()`` does
  ``imread``         ``cv2.imread(path)`` (IMREAD_COLOR): an (H, W, 3) uint8 BGR
                     array, for PNG (every colour type and bit depth, Adam7
                     interlacing), uncompressed BMP and sequential or
                     progressive JPEG (``data/jpeg.py``, EXIF orientation
                     applied)
  ``resize_area``    ``cv2.resize(..., INTER_AREA)`` on uint8 HWC, shrinking
  ``resize_linear``  ``cv2.resize(..., INTER_LINEAR)`` on uint8 HWC
  ``imwrite``        ``cv2.imwrite(path, im)`` for ``.jpg``/``.jpeg`` and ``.bmp``
                     (the bytes cv2 writes) and ``.png`` (``imwrite_png``)
  ``imwrite_png``    a PNG of one filter type, optionally Adam7-interlaced
  ``png_parse``      a PNG's header, palette and inflated image data
  ``png_rgb``        those as (H, W, 3) uint8 RGB, as libpng gives them with
                     expand, strip_16, strip_alpha and gray_to_rgb

The resizes repeat OpenCV's arithmetic (its coefficient tables, float32 area
sums rounded half to even, 11-bit fixed-point linear weights with the vector
path's rounding), so they equal ``cv2.resize`` bit for bit.

PNG rows are filtered: filters 3 and 4 predict a byte from its left neighbour
after unfiltering, so ``unfilter`` runs a host C loop (``csrc/png_unfilter.cu``,
built like the kernels) where CUDA is available, and ``unfilter_plain``, the
same arithmetic in numpy along anti-diagonals, elsewhere. An Adam7 file is
seven reduced images, each filtered on its own: each pass is unfiltered and
unpacked alone, then scattered to its pixels.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel, and the bit depths the PNG standard allows for it
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


class ImageFormatError(ValueError):
    """A file that is truncated, corrupt, or of a kind the port does not read."""


# -- headers --------------------------------------------------------------------

def _png_chunks(data: bytes, strict: bool = True) -> Iterator[Tuple[bytes, bytes]]:
    """(type, payload) of each chunk to IEND, CRCs checked; raises on truncation.
    Not ``strict``: as libpng reads, an ancillary chunk (lower-case first letter)
    with a bad CRC is dropped, not refused."""
    if data[:8] != PNG_SIGNATURE:
        raise ImageFormatError("not a PNG file")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ImageFormatError("truncated PNG file")
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ImageFormatError("truncated PNG file")
        payload = data[pos + 8: end]
        (crc,) = struct.unpack(">I", data[end: end + 4])
        if zlib.crc32(ctype + payload) != crc:
            if strict or not ctype[:1].islower():
                raise ImageFormatError(f"broken PNG file: bad CRC in a {ctype!r} chunk")
        else:
            yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _png_header(payload: bytes) -> Tuple[int, int, int, int, int]:
    """IHDR -> (width, height, bit depth, colour type, interlace), checked."""
    if len(payload) != 13:
        raise ImageFormatError("broken PNG file: IHDR of the wrong length")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
    if w == 0 or h == 0 or ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype] \
            or comp != 0 or filt != 0 or interlace > 1:
        raise ImageFormatError(f"broken PNG file: IHDR {w}x{h}, depth {depth}, "
                               f"colour type {ctype}")
    return w, h, depth, ctype, interlace


def _bmp_header(data: bytes) -> Tuple[int, int, int, int, int, int]:
    """(width, height (negative: top-down), bits a pixel, compression, DIB header
    size, colours used) of a BMP."""
    if len(data) < 26 or data[:2] != b"BM":
        raise ImageFormatError("not a BMP file")
    (dib,) = struct.unpack("<I", data[14:18])
    if dib == 12:  # BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", data[18:26])
        return w, h, bits, 0, dib, 0
    if dib < 40 or len(data) < 14 + 40:
        raise ImageFormatError("truncated BMP header")
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    (used,) = struct.unpack("<I", data[46:50])
    return w, h, bits, comp, dib, used


def _jpeg_size(data: bytes) -> Tuple[int, int]:
    """(w, h) from the first start-of-frame marker."""
    if data[:2] != b"\xff\xd8":
        raise ImageFormatError("not a JPEG file")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ImageFormatError("broken JPEG file: no marker where one belongs")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # markers without a length
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2: pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > len(data):
                break
            h, w = struct.unpack(">HH", data[pos + 5: pos + 9])
            return w, h
        if marker in (0xD9, 0xDA):  # end of image or start of scan before a frame
            break
        pos += 2 + length
    raise ImageFormatError("truncated JPEG file: no frame header")


def image_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG, BMP or JPEG file, read from its header (a PNG's
    chunks checked to IEND). Raises ImageFormatError on what PIL's
    ``Image.open`` + ``verify()`` refuses for these formats, and on other formats."""
    data = Path(path).read_bytes()
    if data[:8] == PNG_SIGNATURE:
        chunks = _png_chunks(data)
        ctype, payload = next(chunks)
        if ctype != b"IHDR":
            raise ImageFormatError("broken PNG file: IHDR is not the first chunk")
        w, h = _png_header(payload)[:2]
        for ctype, _ in chunks:  # PIL's verify(): every CRC, up to IEND
            pass
        return w, h
    if data[:2] == b"BM":
        w, h = _bmp_header(data)[:2]
        return w, abs(h)
    if data[:2] == b"\xff\xd8":
        return _jpeg_size(data)
    raise ImageFormatError(f"{path}: not a PNG, BMP or JPEG file")


# -- PNG unfiltering --------------------------------------------------------------

@functools.cache
def png_unfilter_library():
    """Build (at first use) and bind ``csrc/png_unfilter.cu``, once per process."""
    from ..ops.cuda_build import load_library

    built = load_library("png_unfilter.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    built.lib.skyeye_png_unfilter.argtypes = [ptr, ptr, i32, i32, i32]
    built.lib.skyeye_png_unfilter.restype = i32
    return built


def unfilter(filtered: np.ndarray, bpp: int, native: Optional[bool] = None) -> np.ndarray:
    """(H, 1 + stride) filtered PNG rows -> (H, stride) bytes. ``native``: the C
    loop (built at first use; a failed build raises) or ``unfilter_plain``; by
    default the C loop where CUDA is available, as on the card's machine."""
    filtered = np.ascontiguousarray(filtered, dtype=np.uint8)
    if native is None:
        native = torch.cuda.is_available()
    if not native:
        return unfilter_plain(filtered, bpp)
    h, stride = filtered.shape[0], filtered.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    rc = png_unfilter_library().lib.skyeye_png_unfilter(
        filtered.ctypes.data, out.ctypes.data, h, stride, bpp)
    if rc:
        raise ImageFormatError(f"broken PNG file: filter type {filtered[rc - 1, 0]} "
                               f"on row {rc - 1}")
    return out


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """``unfilter`` in numpy: the byte at (row y, pixel x) needs only (y, x - 1),
    (y - 1, x) and (y - 1, x - 1), so each anti-diagonal y + x = d is done at once."""
    h, stride = filtered.shape[0], filtered.shape[1] - 1
    types = filtered[:, 0].astype(np.int64)
    if (types > 4).any():
        y = int(np.argmax(types > 4))
        raise ImageFormatError(f"broken PNG file: filter type {types[y]} on row {y}")
    w = stride // bpp
    f = filtered[:, 1:].reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # a zero row above, a zero column left
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        t = types[ys][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, c), 0))))
        out[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return out[1:, 1:].reshape(h, stride).astype(np.uint8)


# -- decoding -------------------------------------------------------------------

@dataclass
class PngData:
    """A PNG's header, palette and inflated image data (``png_parse``)."""

    width: int
    height: int
    depth: int
    color_type: int
    interlace: int
    palette: Optional[np.ndarray]  # (n, 3) uint8, PLTE's entries
    raw: bytes

    @property
    def channels(self) -> int:
        return _PNG_CHANNELS[self.color_type]


def png_parse(data: bytes, strict: bool = True) -> PngData:
    """The chunks of a PNG to IEND (``strict``: every CRC, else libpng's rule),
    its IDAT data inflated. Raises ImageFormatError on what is broken."""
    chunks = _png_chunks(data, strict)
    ctype_, payload = next(chunks)
    if ctype_ != b"IHDR":
        raise ImageFormatError("broken PNG file: IHDR is not the first chunk")
    w, h, depth, ctype, interlace = _png_header(payload)
    palette, idat = None, []
    for name, payload in chunks:
        if name == b"PLTE":
            if len(payload) % 3 or len(payload) > 768:
                if ctype == 3:
                    raise ImageFormatError("broken PNG file: PLTE of the wrong length")
                continue  # libpng ignores a broken suggested palette
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif name == b"IDAT":
            idat.append(payload)
    if ctype == 3 and palette is None:
        raise ImageFormatError("broken PNG file: palette image without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageFormatError(f"broken PNG file: {e}") from None
    return PngData(w, h, depth, ctype, interlace, palette, raw)


def png_passes(width: int, height: int, interlace: int) -> List[Tuple[int, int, int, int, int, int]]:
    """(x0, y0, dx, dy, pass width, pass height) of each non-empty pass: one for a
    plain image, up to seven for Adam7."""
    if not interlace:
        return [(0, 0, 1, 1, width, height)]
    out = []
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def png_samples(png: PngData, native: Optional[bool] = None) -> np.ndarray:
    """(H, W, channels) uint8 samples: each pass unfiltered (``unfilter``) and
    unpacked, 16-bit to its high byte (libpng's strip_16), gray below 8 bits
    scaled to 8 (expand), palette indices as they are; passes scattered."""
    w, h, depth, channels = png.width, png.height, png.depth, png.channels
    bits = channels * depth
    bpp = max(1, bits // 8)
    passes = png_passes(w, h, png.interlace)
    need = sum(ph * ((pw * bits + 7) // 8 + 1) for _, _, _, _, pw, ph in passes)
    if len(png.raw) < need:
        raise ImageFormatError("truncated PNG image data")
    raw = np.frombuffer(png.raw, np.uint8, need)
    out = np.empty((h, w, channels), np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = (pw * bits + 7) // 8
        rows = unfilter(raw[at: at + ph * (stride + 1)].reshape(ph, stride + 1), bpp, native)
        at += ph * (stride + 1)
        if depth == 16:  # libpng's png_set_strip_16: the high byte
            samples = rows.reshape(ph, pw * channels, 2)[:, :, 0]
        elif depth < 8:
            per_byte = 8 // depth
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
                ph, stride * per_byte)[:, :pw]
            if png.color_type == 0:  # gray scaled to 8 bits: 1 -> 255, 2 bits x 85, 4 bits x 17
                samples = samples * np.uint8(255 // ((1 << depth) - 1))
        else:
            samples = rows
        out[y0::dy, x0::dx] = samples.reshape(ph, pw, channels)
    return out


def png_rgb(png: PngData, samples: np.ndarray, strict: bool = True) -> np.ndarray:
    """Samples -> (H, W, 3) uint8 RGB: palette looked up, gray repeated, alpha
    dropped. A palette index past PLTE raises (``strict``) or reads as black,
    as libpng's zero-filled 256-entry palette gives it."""
    if png.color_type == 3:
        idx = samples[:, :, 0]
        palette = png.palette
        if int(idx.max()) >= len(palette):
            if strict:
                raise ImageFormatError("broken PNG file: palette index out of range")
            palette = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
        return palette[idx]
    if png.color_type in (0, 4):  # gray (+ alpha): alpha dropped, gray repeated
        return np.repeat(samples[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(samples[:, :, :3])  # RGB (+ alpha): alpha dropped


def _png_read(data: bytes) -> np.ndarray:
    png = png_parse(data)
    return np.ascontiguousarray(png_rgb(png, png_samples(png))[:, :, ::-1])


def _bmp_read(data: bytes) -> np.ndarray:
    w, h, bits, comp, dib, used = _bmp_header(data)
    (offset,) = struct.unpack("<I", data[10:14])
    if comp not in (0, 3) or (comp == 3 and bits != 32) or bits not in (1, 4, 8, 24, 32):
        raise ImageFormatError(f"BMP of {bits} bits a pixel, compression {comp}, "
                               "is not supported by the port's decoder")
    if comp == 3:  # BI_BITFIELDS: only the usual BGRA masks
        masks = struct.unpack("<III", data[54:66])  # after a 40-byte header, or inside a longer one
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise ImageFormatError(f"BMP with colour masks {masks} is not supported")
    top_down, height = h < 0, abs(h)
    stride = ((w * bits + 31) // 32) * 4
    if w <= 0 or height == 0 or len(data) < offset + stride * height:
        raise ImageFormatError("truncated BMP file")
    rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bits >= 24:
        return np.ascontiguousarray(rows[:, : w * bits // 8].reshape(height, w, bits // 8)[:, :, :3])
    entry = 3 if dib == 12 else 4
    n_colors = used or (1 << bits)
    table_at = 14 + dib + (12 if comp == 3 and dib == 40 else 0)
    palette = np.frombuffer(data, np.uint8, n_colors * entry, table_at).reshape(n_colors, entry)
    if bits == 8:
        idx = rows[:, :w]
    else:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(height, -1)[:, :w]
    if int(idx.max()) >= n_colors:
        raise ImageFormatError("broken BMP file: palette index out of range")
    return np.ascontiguousarray(palette[idx][:, :, :3])


def imread(path) -> np.ndarray:
    """The image at ``path`` as an (H, W, 3) uint8 BGR array, as ``cv2.imread``
    reads it: PNG (Adam7 too), uncompressed BMP and sequential or progressive
    JPEG. Raises FileNotFoundError for a missing file, ImageFormatError for a
    corrupt one or another format, and NotImplementedError for the JPEG kinds
    ``data/jpeg.py`` does not read (arithmetic-coded, lossless, ...)."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(f"image not found {path}")
    data = p.read_bytes()
    if data[:8] == PNG_SIGNATURE:
        return _png_read(data)
    if data[:2] == b"BM":
        return _bmp_read(data)
    if data[:2] == b"\xff\xd8":
        from . import jpeg

        try:
            return jpeg.decode(data)
        except ImageFormatError as e:
            raise ImageFormatError(f"{path}: {e}") from None
    raise ImageFormatError(f"{path}: not a PNG, BMP or JPEG file")


# -- writing ----------------------------------------------------------------------

def _png_chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def png_filter(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """(H, stride) bytes -> (H, 1 + stride) rows filtered by one filter type."""
    raw = rows.astype(np.int32)
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}[filter_type]
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = filter_type
    out[:, 1:] = (raw - pred) & 0xFF
    return out


def imwrite_png(path, img: np.ndarray, filter_type: int = 0, level: int = 1,
                interlace: bool = False) -> None:
    """Write an (H, W, 3) BGR or (H, W) gray uint8 array as an 8-bit PNG, every
    row with ``filter_type`` (0-4), compressed at zlib ``level``; ``interlace``:
    Adam7, each pass filtered on its own."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"imwrite_png takes (H, W, 3) or (H, W) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color = img.ndim == 3
    pixels = img[:, :, ::-1] if color else img
    stream = b"".join(
        png_filter(np.ascontiguousarray(pixels[y0::dy, x0::dx]).reshape(ph, -1),
                   3 if color else 1, filter_type).tobytes()
        for x0, y0, dx, dy, _, ph in png_passes(w, h, int(interlace)))
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if color else 0, 0, 0, int(interlace))
    Path(path).write_bytes(PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                           + _png_chunk(b"IDAT", zlib.compress(stream, level))
                           + _png_chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray) -> None:
    """``cv2.imwrite(path, img)`` by the suffix: ``.jpg``/``.jpeg`` and ``.bmp``
    write the bytes cv2 writes at its defaults (``data/jpeg.py``, ``bmp_bytes``),
    ``.png`` an 8-bit PNG (``imwrite_png``; cv2's deflate stream differs, its
    pixels do not)."""
    suffix = Path(path).suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        from . import jpeg

        Path(path).write_bytes(jpeg.encode(img))
    elif suffix == ".bmp":
        Path(path).write_bytes(bmp_bytes(img))
    elif suffix == ".png":
        imwrite_png(path, img)
    else:
        raise ValueError(f"imwrite writes .jpg, .jpeg, .bmp or .png, not {path}")


def bmp_bytes(img: np.ndarray) -> bytes:
    """The BMP ``cv2.imencode('.bmp', img)`` writes: 24-bit BGR, or 8-bit with a
    gray palette, rows bottom-up padded to 4 bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"bmp_bytes takes (H, W, 3) or (H, W) uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bits = 24 if img.ndim == 3 else 8
    stride = ((w * bits // 8) + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * bits // 8] = img.reshape(h, -1)
    palette = b""
    if bits == 8:
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 4, axis=1)
        table[:, 3] = 0
        palette = table.tobytes()
    offset = 54 + len(palette)
    header = struct.pack("<2sIII", b"BM", offset + rows.size, 0, offset) + struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, bits, 0, 0, 0, 0, 0, 0)
    return header + palette + rows[::-1].tobytes()


# -- resizing ---------------------------------------------------------------------

_DBL_EPSILON = 2.220446049250313e-16


def _check_resize_input(im: np.ndarray) -> np.ndarray:
    if im.dtype != np.uint8 or im.ndim not in (2, 3):
        raise ValueError(f"the resizes take uint8 (H, W) or (H, W, C), got {im.dtype} {im.shape}")
    return im


@functools.lru_cache(maxsize=64)
def _area_table(ssize: int, dsize: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab``: (destination, source, float32 weight,
    slot) entries, in order; slot j is an entry's place among its destination's."""
    scale = 1.0 / (dsize / ssize)
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx), si.append(sx1 - 1), alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx), si.append(sx), alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx), si.append(sx2), alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    di, si = np.array(di), np.array(si)
    slot = np.arange(len(di)) - np.searchsorted(di, np.arange(dsize))[di]
    return di, si, np.array(alpha, np.float32), slot


def _area_scale(ssize: int, dsize: int) -> Tuple[float, int, bool]:
    scale = 1.0 / (dsize / ssize)
    iscale = round(scale)
    return scale, iscale, abs(scale - iscale) < _DBL_EPSILON


def resize_area(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, dsize, interpolation=cv2.INTER_AREA)`` for a shrink
    (``dsize`` = (w, h), neither larger than the image's)."""
    im = _check_resize_input(im)
    h0, w0 = im.shape[:2]
    w, h = dsize
    if (w, h) == (w0, h0):
        return im.copy()
    if w > w0 or h > h0 or w < 1 or h < 1:
        raise ValueError(f"resize_area shrinks only ({w0}x{h0} -> {w}x{h}); "
                         "use resize_linear to grow")
    _, sx, fast_x = _area_scale(w0, w)
    _, sy, fast_y = _area_scale(h0, h)
    if fast_x and fast_y:  # OpenCV's resizeAreaFast: whole blocks of sy x sx
        blocks = im.reshape(h, sy, w, sx, *im.shape[2:]).astype(np.int64).sum(axis=(1, 3))
        channels = im.shape[2] if im.ndim == 3 else 1
        if sx == 2 and sy == 2 and channels in (1, 3, 4):
            out = (blocks + 2) >> 2
        else:
            out = np.rint(blocks.astype(np.float32) * np.float32(1.0 / (sx * sy)))
        return np.clip(out, 0, 255).astype(np.uint8)

    src = im.astype(np.float32)
    extra = (1,) * (im.ndim - 2)
    di, si, alpha, slot = _area_table(w0, w)
    buf = np.zeros((h0, w) + im.shape[2:], np.float32)
    for j in range(int(slot.max()) + 1):  # float32 sums in OpenCV's order
        m = slot == j
        buf[:, di[m]] = buf[:, di[m]] + src[:, si[m]] * alpha[m].reshape(-1, *extra)
    di, si, beta, slot = _area_table(h0, h)
    acc = np.zeros((h, w) + im.shape[2:], np.float32)
    for j in range(int(slot.max()) + 1):
        m = slot == j
        acc[di[m]] = acc[di[m]] + beta[m].reshape(-1, 1, *extra) * buf[si[m]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def _linear_table(ssize: int, dsize: int, clamp: bool) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's linear coefficients: (first source index, (dsize, 2) int64 weights
    in units of 1/2048). Along x (``clamp``) a position outside the image takes
    the edge pixel whole; along y it keeps its weights over replicated rows."""
    scale = 1.0 / (dsize / ssize)
    pos = np.array([(d + 0.5) * scale - 0.5 for d in range(dsize)]).astype(np.float32)
    first = np.floor(pos).astype(np.int64)
    frac = (pos - first.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = first < 0, first >= ssize - 1
        frac[low | high] = 0
        first[low], first[high] = 0, ssize - 1
    weights = np.stack([(np.float32(1) - frac) * np.float32(2048), frac * np.float32(2048)], 1)
    return first, np.rint(weights.astype(np.float32)).astype(np.int64)


def resize_linear(im: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(im, dsize, interpolation=cv2.INTER_LINEAR)`` (``dsize`` = (w, h))."""
    im = _check_resize_input(im)
    h0, w0 = im.shape[:2]
    w, h = dsize
    if (w, h) == (w0, h0):
        return im.copy()
    if w < 1 or h < 1:
        raise ValueError(f"resize_linear to {w}x{h}")
    _, sx, fast_x = _area_scale(w0, w)
    _, sy, fast_y = _area_scale(h0, h)
    if fast_x and fast_y and sx == 2 and sy == 2:  # OpenCV takes INTER_AREA here
        return resize_area(im, dsize)
    extra = (1,) * (im.ndim - 2)
    x0, a = _linear_table(w0, w, True)
    src = im.astype(np.int64)
    rows = (src[:, x0] * a[:, 0].reshape(-1, *extra)
            + src[:, np.minimum(x0 + 1, w0 - 1)] * a[:, 1].reshape(-1, *extra))
    y0, b = _linear_table(h0, h, False)
    s0, s1 = rows[np.clip(y0, 0, h0 - 1)] >> 4, rows[np.clip(y0 + 1, 0, h0 - 1)] >> 4
    b0, b1 = b[:, 0].reshape(-1, 1, *extra), b[:, 1].reshape(-1, 1, *extra)
    # the vector path of OpenCV's VResizeLinear: 16-bit high products, then >> 2 rounded
    out = (((b0 * s0) >> 16) + ((b1 * s1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
