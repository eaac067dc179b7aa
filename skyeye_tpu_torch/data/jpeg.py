"""JPEG decode and encode without libjpeg, as ``cv2.imread``/``cv2.imwrite`` do them.

The port's stand-in for the codec that OpenCV gives JAX's data path. OpenCV
reads and writes JPEG through libjpeg-turbo, whose default paths are integer
arithmetic that can be repeated exactly:

  decode  baseline, extended-sequential and progressive Huffman, 8-bit, 1 or
          3 components, any integer sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...),
          restart intervals, fill bytes, APPn/COM segments, sizes that are not
          a multiple of the MCU; progressive scans (``jdphuff.c``): spectral
          selection, successive approximation (DC first and refine, AC first
          and refine with EOB runs), into the same coefficient arrays;
          ``jidctint.c``'s ISLOW inverse DCT with its
          descale rounding and range limit, ``jdsample.c``'s fancy (triangle)
          upsampling (h2v1, h2v2 and h1v2; box replication where libjpeg takes
          it), ``jdcolor.c``'s fixed-point YCbCr->RGB tables, written as BGR;
          then the EXIF orientation, as ``cv2.imread`` applies it
  encode  what ``cv2.imwrite(path, im)`` writes at its defaults (or another
          quality): JFIF APP0, the quality-scaled standard quantisation tables
          (baseline-clamped), SOF0 with 4:2:0 sampling (one component for
          gray), the four standard Huffman tables, no restart markers;
          ``jccolor.c``'s fixed-point RGB->YCbCr, ``jcsample.c``'s h2v2
          downsample with its alternating bias, ``jfdctint.c``'s ISLOW forward
          DCT and libjpeg-turbo's reciprocal quantisation, with its edge
          replication and dummy blocks

``decode``/``encode`` run a host C version (``csrc/jpeg.cu``, built like the
kernels) where CUDA is available, as on the card's machine, and the numpy
versions here (``decode_plain``/``encode_plain``) elsewhere; both give the
same pixels and the same bytes. Lossless, hierarchical, arithmetic-coded and
12-bit files raise NotImplementedError, and so does a progressive file whose
scans leave one of the first ten coefficients unfinished (libjpeg smooths
such blocks, ``jdcoefct.c``, which is not ported); a truncated or corrupt
file raises ``ImageFormatError``.

``lenient=True`` (``decode_coefficients``, ``decode_rgb``) reads damaged data
as libjpeg does without an error: past the end of the data (or at a marker
inside a scan) the MCU in progress is decoded from zero bits and the rest of
the restart interval is skipped (zeros in a sequential file, the coefficients
left as they are in a progressive one); a Huffman code that matches nothing
takes 17 bits and decodes as symbol 0. JAX's native host prep reads JPEG
through libjpeg this way (``data/native.py``).
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .imageio import ImageFormatError

KINDS_NOT_PORTED = ("lossless, hierarchical, arithmetic-coded and 12-bit JPEG, and "
                    "libjpeg's block smoothing of unfinished progressive files, "
                    "are not in the port yet (ROADMAP.md, Queue 1 item 13)")
SMOOTHED_COEFS = 10  # libjpeg-turbo's SAVED_COEFS: zigzag 0..9 decide block smoothing


def _natural_order() -> np.ndarray:
    """Natural (row-major) index of each zigzag position, with libjpeg's 16 extra
    entries of 63 that catch a run past the end of a block."""
    order = sorted(((u + v, v if (u + v) % 2 == 0 else u, u * 8 + v)
                    for u in range(8) for v in range(8)))
    return np.array([o[2] for o in order] + [63] * 16, np.int64)


NATURAL_ORDER = _natural_order()

# ITU T.81 Annex K: (bits per code length 1-16, symbols) of the standard tables
STD_HUFFMAN = {
    (0, 0): bytes.fromhex("00010501010101010100000000000000000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
        "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
        "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4"
        "e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000000102030405060708090a0b"),
    (1, 1): bytes.fromhex(
        "0002010204040304070504040001027700010203110405213106124151076171132232810814"
        "4291a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a43444546"
        "4748494a535455565758595a636465666768696a737475767778797a82838485868788898a929394"
        "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8"
        "d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}  # key (class 0 DC / 1 AC, table id): 16 counts then the symbols

# ITU T.81 Annex K.1, natural order: luminance, chrominance
STD_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64),
    np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
             + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 6 + [99] * 32, np.int64),
)
JFIF_APP0 = bytes.fromhex("ffe000104a46494600010100000100010000")  # v1.01, no units, 1:1
DEFAULT_QUALITY = 95  # cv2.IMWRITE_JPEG_QUALITY's default

# libjpeg's fixed-point constants (13 fractional bits) and shifts
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
SCALEBITS = 16  # the colour converters' fixed point


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


# -- headers ----------------------------------------------------------------------

@dataclass
class Component:
    ident: int
    h: int
    v: int
    tq: int
    coef: Optional[np.ndarray] = None  # (rows of blocks, cols of blocks, 64), natural order


@dataclass
class Frame:
    width: int = 0
    height: int = 0
    components: List[Component] = field(default_factory=list)
    adobe_transform: Optional[int] = None
    jfif: bool = False
    orientation: int = 1  # EXIF
    progressive: bool = False

    @property
    def hmax(self) -> int:
        return max(c.h for c in self.components)

    @property
    def vmax(self) -> int:
        return max(c.v for c in self.components)


def _segment(data: bytes, pos: int) -> Tuple[int, bytes, int]:
    """(marker, payload, next position) of the marker segment at pos; fill bytes
    before a marker are skipped."""
    n = len(data)
    if pos >= n or data[pos] != 0xFF:
        raise ImageFormatError("broken JPEG file: no marker where one belongs"
                               if pos < n else "truncated JPEG file")
    while pos + 1 < n and data[pos + 1] == 0xFF:
        pos += 1
    if pos + 1 >= n:
        raise ImageFormatError("truncated JPEG file")
    marker = data[pos + 1]
    if marker in (0x01, 0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
        return marker, b"", pos + 2
    if pos + 4 > n:
        raise ImageFormatError("truncated JPEG file")
    (length,) = struct.unpack(">H", data[pos + 2: pos + 4])
    if length < 2 or pos + 2 + length > n:
        raise ImageFormatError("truncated JPEG file")
    return marker, data[pos + 4: pos + 2 + length], pos + 2 + length


def exif_orientation(payload: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in an APP1 Exif payload, else 1."""
    if payload[:6] != b"Exif\0\0" or len(payload) < 14:
        return 1
    tiff = payload[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd: ifd + 2])
        for i in range(count):
            tag, typ, _, value = struct.unpack(order + "HHI4s", tiff[ifd + 2 + 12 * i:
                                                                  ifd + 14 + 12 * i])
            if tag == 0x0112 and typ == 3:
                return struct.unpack(order + "H", value[:2])[0]
    except struct.error:
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ExifTransform``: orientations 2-8 flip and/or transpose."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, *range(2, img.ndim))
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def _sof(payload: bytes, marker: int) -> Frame:
    if marker not in (0xC0, 0xC1, 0xC2):
        raise NotImplementedError(f"JPEG SOF{marker - 0xC0}: {KINDS_NOT_PORTED}")
    if len(payload) < 6:
        raise ImageFormatError("truncated JPEG frame header")
    precision, h, w, nc = struct.unpack(">BHHB", payload[:6])
    if precision != 8:
        raise NotImplementedError(f"{precision}-bit JPEG: {KINDS_NOT_PORTED}")
    if h == 0 or w == 0:
        raise ImageFormatError(f"JPEG frame of {w}x{h} (a DNL height is not read)")
    if nc not in (1, 3) or len(payload) < 6 + 3 * nc:
        raise ImageFormatError(f"JPEG of {nc} components: the port reads 1 or 3")
    comps = []
    for i in range(nc):
        ident, hv, tq = payload[6 + 3 * i: 9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
            raise ImageFormatError("broken JPEG frame header")
        comps.append(Component(ident, hv >> 4, hv & 15, tq))
    frame = Frame(w, h, comps, progressive=marker == 0xC2)
    for c in comps:
        if frame.hmax % c.h or frame.vmax % c.v:
            raise ImageFormatError(f"JPEG sampling {c.h}x{c.v} of {frame.hmax}x{frame.vmax}")
    return frame


def read_header(data: bytes) -> Frame:
    """The frame header (size, components, sampling), the Adobe transform and the
    EXIF orientation, from the segments before the first scan."""
    if data[:2] != b"\xff\xd8":
        raise ImageFormatError("not a JPEG file")
    pos, frame, app = 2, None, {}
    while True:
        marker, payload, pos = _segment(data, pos)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            frame = _sof(payload, marker)
        elif marker == 0xCC:
            raise NotImplementedError(f"JPEG DAC: {KINDS_NOT_PORTED}")
        elif marker == 0xE0 and payload[:5] == b"JFIF\0":
            app["jfif"] = True
        elif marker == 0xE1 and "orientation" not in app and payload[:6] == b"Exif\0\0":
            app["orientation"] = exif_orientation(payload)
        elif marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            app["adobe"] = payload[11]
        elif marker in (0xDA, 0xD9):
            break
    if frame is None:
        raise ImageFormatError("truncated JPEG file: no frame header")
    frame.adobe_transform = app.get("adobe")
    frame.jfif = app.get("jfif", False)
    frame.orientation = app.get("orientation", 1)
    return frame


def _huffman_lut(spec: bytes) -> List[int]:
    """65536 entries, one for each 16-bit window: (code length << 8) | symbol, or
    0 where no code matches."""
    counts = spec[:16]
    symbols = spec[16:16 + sum(counts)]
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo: lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _parse_dht(payload: bytes, tables: Dict[Tuple[int, int], List[int]]) -> None:
    pos = 0
    while pos < len(payload):
        tc_th = payload[pos]
        counts = payload[pos + 1: pos + 17]
        n = sum(counts)
        if len(counts) < 16 or pos + 17 + n > len(payload) or tc_th >> 4 > 1 or tc_th & 15 > 3:
            raise ImageFormatError("broken JPEG Huffman table")
        if tc_th >> 4 == 0 and max(payload[pos + 17: pos + 17 + n], default=0) > 15:
            raise ImageFormatError("broken JPEG Huffman table: a DC category above 15")
        tables[(tc_th >> 4, tc_th & 15)] = _huffman_lut(payload[pos + 1: pos + 17 + n])
        pos += 17 + n


def _parse_dqt(payload: bytes, tables: Dict[int, np.ndarray]) -> None:
    pos = 0
    while pos < len(payload):
        pq, tq = payload[pos] >> 4, payload[pos] & 15
        size = 128 if pq else 64
        if pq > 1 or tq > 3 or pos + 1 + size > len(payload):
            raise ImageFormatError("broken JPEG quantisation table")
        vals = np.frombuffer(payload, ">u2" if pq else np.uint8, 64, pos + 1).astype(np.int64)
        table = np.empty(64, np.int64)
        table[NATURAL_ORDER[:64]] = vals
        tables[tq] = table
        pos += 1 + size


# -- entropy decoding -----------------------------------------------------------------

def _entropy_segments(data: bytes, pos: int, lenient: bool = False) -> Tuple[List[bytes], int]:
    """The scan's entropy-coded data from pos, split at its restart markers, each
    piece unstuffed; and the position of the marker that ends the scan. With
    ``lenient`` the end of the data ends the scan (libjpeg reads an EOI there)."""
    arr = np.frombuffer(data, np.uint8)
    ffs = np.flatnonzero(arr[pos:] == 0xFF) + pos
    segments, start, piece = [], pos, bytearray()
    i = 0
    while True:
        if i >= len(ffs) or ffs[i] + 1 >= len(data):
            if not lenient:
                raise ImageFormatError("truncated JPEG file: the scan runs to the end of the data")
            piece += data[start: int(ffs[i]) if i < len(ffs) else len(data)]
            segments.append(bytes(piece))
            return segments, len(data)
        at = int(ffs[i])
        nxt = data[at + 1]
        if nxt == 0x00:  # a stuffed 0xFF
            piece += data[start: at + 1]
            start = at + 2
            i += 1
            while i < len(ffs) and ffs[i] < start:
                i += 1
        elif nxt == 0xFF:  # a fill byte
            piece += data[start: at]
            start = at + 1
            i += 1
        elif 0xD0 <= nxt <= 0xD7:
            piece += data[start: at]
            segments.append(bytes(piece))
            piece = bytearray()
            start = at + 2
            i += 1
            while i < len(ffs) and ffs[i] < start:
                i += 1
        else:
            piece += data[start: at]
            segments.append(bytes(piece))
            return segments, at


class _Bits:
    """Bit windows over one entropy segment; zeros past its end, as libjpeg
    inserts at a marker. ``limit``: a block that ends past it ran out of data
    (the strict decoder raises there); ``real``: the segment's own bits."""

    PAD = 512  # zero bytes after the segment: more than one block can read

    def __init__(self, seg: bytes):
        b = np.frombuffer(seg + b"\0" * self.PAD, np.uint8).astype(np.int64)
        self.words = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.p = 0
        self.real = 8 * len(seg)
        self.limit = self.real + 32

    def peek16(self) -> int:
        p = self.p
        return (self.words[p >> 3] >> (16 - (p & 7))) & 0xFFFF

    def get(self, s: int) -> int:
        p = self.p
        self.p = p + s
        return (self.words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)

    def overran(self, lenient: bool) -> bool:
        """After a block: whether it read past the segment's data. The strict
        decoder raises; the lenient one (libjpeg) reads on in zeros, so the
        position goes back to the end of the data, where every bit is 0."""
        if self.p <= self.real:
            return False
        if not lenient:
            if self.p > self.limit:
                raise ImageFormatError("corrupt JPEG data: the data ran out inside a block")
            return False
        self.p = self.real
        return True


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _symbol(lut: List[int], bits: _Bits, lenient: bool) -> int:
    """One Huffman symbol; a code that matches nothing raises, or (lenient, as
    ``jpeg_huff_decode``) takes 17 bits and reads as 0."""
    e = lut[bits.peek16()]
    if e:
        bits.p += e >> 8
        return e & 255
    if not lenient:
        raise ImageFormatError("corrupt JPEG data: bad Huffman code")
    bits.p += 17
    return 0


def _scan_header(frame: Frame, payload: bytes, huff):
    """(components with their DC and AC tables, Ss, Se, Ah, Al) of an SOS,
    checked as libjpeg checks it (``jdphuff.c`` for a progressive frame)."""
    ns = payload[0] if payload else 0
    if ns < 1 or ns > 4 or len(payload) < 4 + 2 * ns:
        raise ImageFormatError("broken JPEG scan header")
    ss, se, ahal = payload[1 + 2 * ns: 4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    ids = {c.ident: c for c in frame.components}
    if frame.progressive:
        bad = (se != 0) if ss == 0 else (ss > se or se > 63 or ns != 1)
        if bad or (ah and al != ah - 1) or al > 13:
            raise ImageFormatError(f"broken JPEG progression: Ss {ss}, Se {se}, Ah {ah}, Al {al}")
    else:  # libjpeg warns and reads a sequential scan whatever its Ss, Se, Ah, Al
        ss, se, ah, al = 0, 63, 0, 0
    need_dc = ss == 0 and ah == 0
    need_ac = ss > 0 or not frame.progressive
    scan = []
    for i in range(ns):
        ident, tables = payload[1 + 2 * i], payload[2 + 2 * i]
        if ident not in ids:
            raise ImageFormatError(f"JPEG scan names component {ident}, not in the frame")
        td, ta = tables >> 4, tables & 15
        if (need_dc and (0, td) not in huff) or (need_ac and (1, ta) not in huff):
            raise ImageFormatError("JPEG scan uses a Huffman table it did not define")
        scan.append((ids[ident], huff.get((0, td)), huff.get((1, ta))))
    return scan, ss, se, ah, al


def _decode_scan(frame: Frame, payload: bytes, data: bytes, pos: int, restart: int,
                 huff: Dict[Tuple[int, int], List[int]], lenient: bool = False,
                 coef_bits: Optional[Dict[int, List[int]]] = None) -> int:
    scan, ss, se, ah, al = _scan_header(frame, payload, huff)
    ns = len(scan)
    if frame.progressive:  # libjpeg's progression status, read when smoothing is decided
        for comp, _, _ in scan:
            bits_of = coef_bits[id(comp)]
            for k in range(ss, se + 1):
                bits_of[k] = al
    segments, end = _entropy_segments(data, pos, lenient)

    hmax, vmax = frame.hmax, frame.vmax
    if ns == 1:  # non-interleaved: one block an MCU, over the component's own blocks
        c = scan[0][0]
        mcux = -(-(-(-frame.width * c.h // hmax)) // 8)
        mcuy = -(-(-(-frame.height * c.v // vmax)) // 8)
        layout = [[(0, 0, 0)]]
    else:
        mcux = -(-frame.width // (8 * hmax))
        mcuy = -(-frame.height // (8 * vmax))
        layout = [[(k, y, x) for y in range(c.v) for x in range(c.h)]
                  for k, (c, _, _) in enumerate(scan)]
    flat = [blk for per in layout for blk in per]
    coefs = {id(c): c.coef.reshape(-1).tolist() for c, _, _ in scan}
    widths = {id(c): c.coef.shape[1] for c, _, _ in scan}
    n_mcu = mcux * mcuy
    per_interval = restart or n_mcu
    n_intervals = -(-n_mcu // per_interval)
    if len(segments) < n_intervals and not lenient:
        raise ImageFormatError("truncated JPEG file: fewer restart intervals than MCUs need")
    natural = NATURAL_ORDER.tolist()
    if not frame.progressive:
        kind = "sequential"
    elif ss == 0:
        kind = "dc_refine" if ah else "dc_first"
    else:
        kind = "ac_refine" if ah else "ac_first"
    p1, m1 = 1 << al, -(1 << al)
    insufficient = False  # libjpeg's flag: the data ran out in this interval
    for t in range(n_intervals):
        m0 = t * per_interval
        if 0 < t < len(segments):  # the restart marker was there: the flag clears
            insufficient = False
        bits = _Bits(segments[t] if t < len(segments) else b"")
        pred = [0] * ns
        eobrun = 0
        for m in range(m0, min(m0 + per_interval, n_mcu)):
            if insufficient:
                continue
            my, mx = divmod(m, mcux)
            for k, y, x in flat:
                comp, dc_lut, ac_lut = scan[k]
                h, v = (1, 1) if ns == 1 else (comp.h, comp.v)
                base = ((my * v + y) * widths[id(comp)] + mx * h + x) * 64
                out = coefs[id(comp)]
                if kind == "sequential":  # the hot loop: the bit reader inlined
                    s = _symbol(dc_lut, bits, lenient)
                    pred[k] += _extend(bits.get(s), s) if s else 0
                    out[base] = pred[k]
                    words, p = bits.words, bits.p
                    j = 1
                    while j < 64:
                        e = ac_lut[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if e:
                            p += e >> 8
                            s = e & 15
                            r = (e & 255) >> 4
                        else:
                            bits.p = p
                            rs = _symbol(ac_lut, bits, lenient)
                            p = bits.p
                            r, s = rs >> 4, rs & 15
                        if s:
                            j += r
                            v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                            p += s
                            out[base + natural[j]] = v - (1 << s) + 1 if v < (1 << (s - 1)) else v
                            j += 1
                        elif r == 15:
                            j += 16
                        else:
                            break
                    bits.p = p
                elif kind == "dc_first":
                    s = _symbol(dc_lut, bits, lenient)
                    pred[k] += _extend(bits.get(s), s) if s else 0
                    out[base] = pred[k] * p1
                elif kind == "dc_refine":
                    if bits.get(1):
                        out[base] |= p1
                elif kind == "ac_first":
                    if eobrun:
                        eobrun -= 1
                    else:
                        words, p = bits.words, bits.p
                        j = ss
                        while j <= se:
                            e = ac_lut[(words[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if e:
                                p += e >> 8
                                rs = e & 255
                            else:
                                bits.p = p
                                rs = _symbol(ac_lut, bits, lenient)
                                p = bits.p
                            r, s = rs >> 4, rs & 15
                            if s:
                                j += r
                                v = (words[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                                p += s
                                out[base + natural[j]] = (v - (1 << s) + 1
                                                          if v < (1 << (s - 1)) else v) * p1
                            elif r == 15:
                                j += 15
                            else:
                                if r:
                                    eobrun = (words[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                                    p += r
                                eobrun += (1 << r) - 1
                                break
                            j += 1
                        bits.p = p
                else:
                    eobrun = _ac_refine(out, base, bits, ac_lut, ss, se, p1, m1, eobrun,
                                        natural, lenient)
                if bits.overran(lenient):
                    insufficient = True
    for c, _, _ in scan:
        c.coef = np.array(coefs[id(c)], np.int64).reshape(c.coef.shape)
    return end


def _ac_refine(out: List[int], base: int, bits: _Bits, lut: List[int], ss: int, se: int,
               p1: int, m1: int, eobrun: int, natural: List[int], lenient: bool) -> int:
    """``decode_mcu_AC_refine`` on one block; returns the EOB run left."""

    words = bits.words

    def correct(pos: int) -> None:  # a correction bit for an already nonzero coefficient
        c = out[pos]
        p = bits.p
        bits.p = p + 1
        if (words[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
            out[pos] = c + (p1 if c >= 0 else m1)

    j = ss
    if not eobrun:
        while j <= se:
            rs = _symbol(lut, bits, lenient)
            r, s = rs >> 4, rs & 15
            if s:  # a newly nonzero coefficient (of size 1; libjpeg warns otherwise)
                s = p1 if bits.get(1) else m1
            elif r != 15:
                eobrun = (1 << r) + (bits.get(r) if r else 0)
                break
            while j <= se:  # past nonzero coefficients (corrected) and r zero ones
                pos = base + natural[j]
                if out[pos]:
                    correct(pos)
                else:
                    r -= 1
                    if r < 0:
                        break
                j += 1
            if s:
                out[base + natural[j]] = s
            j += 1
    if eobrun:
        for jj in range(j, se + 1):
            pos = base + natural[jj]
            if out[pos]:
                correct(pos)
        eobrun -= 1
    return eobrun


def _smoothing_would_apply(frame: Frame, quant: Dict[int, np.ndarray],
                           coef_bits: Dict[int, List[int]]) -> bool:
    """libjpeg's ``smoothing_ok``: a progressive frame whose DC is known for every
    component and one of whose first ten coefficients is unfinished somewhere."""
    useful = False
    for c in frame.components:
        q = quant.get(c.tq)
        if q is None or not all(q[NATURAL_ORDER[:SMOOTHED_COEFS]]):
            return False
        bits_of = coef_bits[id(c)]
        if bits_of[0] < 0:
            return False
        useful = useful or any(b != 0 for b in bits_of[1:SMOOTHED_COEFS])
    return useful


def decode_coefficients(data: bytes, lenient: bool = False
                        ) -> Tuple[Frame, Dict[int, np.ndarray]]:
    """Parse a Huffman JPEG, sequential or progressive: its frame (each
    component's quantised coefficients in ``coef``) and its quantisation
    tables. ``lenient``: damaged data read as libjpeg reads it (module doc)."""
    frame = read_header(data)
    hmax, vmax = frame.hmax, frame.vmax
    mcux, mcuy = -(-frame.width // (8 * hmax)), -(-frame.height // (8 * vmax))
    for c in frame.components:
        c.coef = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int64)
    coef_bits = {id(c): [-1] * 64 for c in frame.components}
    quant: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[int]] = {}
    pos, restart, scans = 2, 0, 0
    while True:
        if lenient and pos >= len(data):
            break  # libjpeg reads an EOI at the end of the data
        marker, payload, pos = _segment(data, pos)
        if marker == 0xC4:
            _parse_dht(payload, huff)
        elif marker == 0xDB:
            _parse_dqt(payload, quant)
        elif marker == 0xDD:
            if len(payload) < 2:
                raise ImageFormatError("broken JPEG restart interval")
            (restart,) = struct.unpack(">H", payload[:2])
        elif marker == 0xDA:
            pos = _decode_scan(frame, payload, data, pos, restart, huff, lenient, coef_bits)
            scans += 1
        elif marker == 0xD9:
            break
        elif 0xD0 <= marker <= 0xD7:
            continue  # a stray restart marker between scans
    if not scans:
        raise ImageFormatError("truncated JPEG file: no scan")
    for c in frame.components:
        if c.tq not in quant:
            raise ImageFormatError(f"JPEG component {c.ident} uses an undefined quantisation "
                                   "table")
    if frame.progressive and _smoothing_would_apply(frame, quant, coef_bits):
        raise NotImplementedError(f"progressive JPEG with unfinished coefficients: "
                                  f"{KINDS_NOT_PORTED}")
    return frame, quant


# -- sample reconstruction -------------------------------------------------------

def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s):
    """The even/odd butterflies of ``jpeg_idct_islow``'s passes: (outputs 0..7
    before the descale) from the 8 inputs, the DC and 4 terms shifted up by
    CONST_BITS."""
    z2, z3 = s[2], s[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (s[0] + s[4]) << CONST_BITS
    tmp1 = (s[0] - s[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1 = t0 * FIX_0_298631336, t1 * FIX_2_053119869
    t2, t3 = t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """``jpeg_idct_islow`` on (..., 64) quantised coefficients (natural order):
    (..., 8, 8) uint8 samples, range-limited as libjpeg's table does (the
    descaled value's low 10 bits, sign-extended, plus 128, clamped)."""
    x = (coef * qtable).reshape(*coef.shape[:-1], 8, 8)
    cols = _idct_1d([x[..., k, :] for k in range(8)])  # pass 1: down each column
    ws = np.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols], axis=-2)
    rows = _idct_1d([ws[..., k] for k in range(8)])  # pass 2: along each row
    out = np.stack([_descale(v, CONST_BITS + PASS1_BITS + 3) for v in rows], axis=-1)
    out = ((out + 512) & 1023) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _neighbours(a: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """a shifted by one along axis, each way, the edge sample repeated."""
    n = a.shape[axis]
    idx = np.arange(n)
    return (np.take(a, np.maximum(idx - 1, 0), axis),
            np.take(a, np.minimum(idx + 1, n - 1), axis))


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """libjpeg-turbo's upsampler for a plane ``sh`` x ``sv`` smaller than the
    image: fancy (triangle) for h2v1 and h2v2 wider than 2 samples and for
    h1v2, box replication otherwise."""
    p = plane.astype(np.int64)
    w = p.shape[1]
    if (sh, sv) == (1, 1):
        return plane
    if (sh, sv) == (2, 1) and w > 2:
        left, right = _neighbours(p, 1)
        out = _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    elif (sh, sv) == (1, 2):
        up, down = _neighbours(p, 0)
        out = _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0)
    elif (sh, sv) == (2, 2) and w > 2:
        up, down = _neighbours(p, 0)
        sums = _interleave(3 * p + up, 3 * p + down, 0)
        left, right = _neighbours(sums, 1)
        out = _interleave((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4, 1)
    else:
        out = p.repeat(sv, 0).repeat(sh, 1)
    return out.astype(np.uint8)


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert`` through its tables, written as BGR."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    xb, xr = cb - 128, cr - 128
    half = 1 << (SCALEBITS - 1)
    r = y + ((_fix(1.40200) * xr + half) >> SCALEBITS)
    b = y + ((_fix(1.77200) * xb + half) >> SCALEBITS)
    g = y + ((-_fix(0.34414) * xb + half + -_fix(0.71414) * xr) >> SCALEBITS)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def reconstruct(frame: Frame, quant: Dict[int, np.ndarray]) -> np.ndarray:
    """Coefficients -> the (H, W, 3) uint8 BGR image, before the EXIF orientation."""
    w, h, hmax, vmax = frame.width, frame.height, frame.hmax, frame.vmax
    planes = []
    for c in frame.components:
        blocks = idct_islow(c.coef, quant[c.tq])  # (by, bx, 8, 8)
        by, bx = blocks.shape[:2]
        plane = blocks.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        dw, dh = -(-w * c.h // hmax), -(-h * c.v // vmax)  # downsampled_width/height
        planes.append(upsample(plane[:dh, :dw], hmax // c.h, vmax // c.v)[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    ids = tuple(c.ident for c in frame.components)
    # jdapimin.c's guess: JFIF means YCbCr, else Adobe's transform flag, else the ids
    if not frame.jfif and (frame.adobe_transform == 0
                           or (frame.adobe_transform is None and ids == (82, 71, 66))):
        return np.ascontiguousarray(np.stack(planes[::-1], axis=-1))  # stored as RGB
    return _ycc_to_bgr(*planes)


def decode_plain(data: bytes) -> np.ndarray:
    """``decode`` in numpy and Python."""
    return reconstruct(*decode_coefficients(data))


# -- encoding -------------------------------------------------------------------------

def quality_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``: the two tables, natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in STD_QUANT)


def _bgr_to_ycc(img: np.ndarray):
    """``jccolor.c``'s ``rgb_ycc_convert`` from BGR samples."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << (SCALEBITS - 1), 128 << SCALEBITS
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> SCALEBITS
    return y, cb, cr


def _edge_pad(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])), mode="edge")


def downsample_h2v2(plane: np.ndarray, out_cols: int) -> np.ndarray:
    """``jcsample.c``'s ``h2v2_downsample``: 2x2 sums plus a bias of 1, 2, 1, 2, ...
    along each row, over the plane edge-extended to an even height and
    ``2 * out_cols`` columns."""
    p = _edge_pad(plane, plane.shape[0] + plane.shape[0] % 2, 2 * out_cols)
    sums = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = 1 + np.arange(out_cols) % 2
    return (sums + bias) >> 2


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """``jpeg_fdct_islow`` on (..., 8, 8) samples less 128: coefficients scaled by 8."""
    def one_d(d, final: bool):
        tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
        tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
        tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
        tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
        tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        shift = CONST_BITS + PASS1_BITS if final else CONST_BITS - PASS1_BITS
        out = [None] * 8
        if final:
            out[0], out[4] = _descale(tmp10 + tmp11, PASS1_BITS), _descale(tmp10 - tmp11, PASS1_BITS)
        else:
            out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
        z1 = (tmp12 + tmp13) * FIX_0_541196100
        out[2] = _descale(z1 + tmp13 * FIX_0_765366865, shift)
        out[6] = _descale(z1 + tmp12 * -FIX_1_847759065, shift)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * FIX_1_175875602
        tmp4, tmp5 = tmp4 * FIX_0_298631336, tmp5 * FIX_2_053119869
        tmp6, tmp7 = tmp6 * FIX_3_072711026, tmp7 * FIX_1_501321110
        z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
        z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
        out[7] = _descale(tmp4 + z1 + z3, shift)
        out[5] = _descale(tmp5 + z2 + z4, shift)
        out[3] = _descale(tmp6 + z2 + z3, shift)
        out[1] = _descale(tmp7 + z1 + z4, shift)
        return out

    rows = one_d([blocks[..., k] for k in range(8)], False)  # pass 1: along each row
    ws = np.stack(rows, axis=-1)
    cols = one_d([ws[..., k, :] for k in range(8)], True)  # pass 2: down each column
    return np.stack(cols, axis=-2)


def quantize(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's ``quantize`` with ``compute_reciprocal``'s divisors
    (``qtable << 3``): (|x| + c) * reciprocal >> r, sign restored."""
    div = (qtable << 3).astype(np.int64)
    b = np.floor(np.log2(div)).astype(np.int64)  # flss(divisor) - 1
    r = 16 + b
    fq, fr = (np.int64(1) << r) // div, (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr <= div // 2, fq, fq + 1))
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    r = np.where(pow2, r - 1, r)
    q = ((np.abs(coef) + c) * fq) >> r
    return np.where(coef < 0, -q, q)


@dataclass
class _Plane:
    blocks: np.ndarray   # (rows, cols, 64) quantised coefficients, natural order
    real: Tuple[int, int]  # blocks in the image (height_in_blocks, width_in_blocks)
    h: int
    v: int
    table: int


def _plane_coefficients(samples: np.ndarray, real: Tuple[int, int], alloc: Tuple[int, int],
                        qtable: np.ndarray) -> np.ndarray:
    """Edge-extend a plane to whole blocks, DCT and quantise the real blocks; the
    dummy blocks of the MCU padding stay 0 (their DC is set later)."""
    rows, cols = real
    p = _edge_pad(samples, rows * 8, cols * 8) - 128
    blocks = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    q = quantize(fdct_islow(blocks).reshape(rows, cols, 64), qtable)
    out = np.zeros((*alloc, 64), np.int64)
    out[:rows, :cols] = q
    return out


def _fill_dummy_dc(plane: _Plane, mcux: int, mcuy: int) -> None:
    """``jccoefct.c``'s dummy blocks: right of the image a block takes its left
    neighbour's DC, below it the DC of the last block of the row above in the MCU."""
    b, (rows, cols) = plane.blocks, plane.real
    for my in range(mcuy):
        for mx in range(mcux):
            for y in range(plane.v):
                by = my * plane.v + y
                for x in range(plane.h):
                    bx = mx * plane.h + x
                    if by >= rows:
                        b[by, bx, 0] = b[by - 1, mx * plane.h + plane.h - 1, 0]
                    elif bx >= cols:
                        b[by, bx, 0] = b[by, bx - 1, 0]


def _code_table(spec: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical (code, length) for each of the 256 symbols of a Huffman spec."""
    counts, symbols = spec[:16], spec[16:]
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _magnitude(v: int) -> Tuple[int, int]:
    """(category, low bits) of a coefficient or DC difference."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _pack_bits(values: List[int], lengths: List[int]) -> bytes:
    """MSB-first bit string of the codes, padded with 1s to a byte, 0xFF stuffed."""
    vals = np.array(values, np.int64)
    lens = np.array(lengths, np.int64)
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    shifts = np.arange(31, -1, -1)
    bits = (vals[:, None] >> shifts) & 1
    bits = bits[np.arange(32)[None, :] >= 32 - lens[:, None]]
    pad = (-len(bits)) % 8
    packed = np.packbits(np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8))
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()


def _segment_bytes(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def encode_plain(img: np.ndarray, quality: int = DEFAULT_QUALITY) -> bytes:
    """``encode`` in numpy and Python."""
    img = _check_encode_input(img)
    h, w = img.shape[:2]
    tables = quality_tables(quality)
    gray = img.ndim == 2
    if gray:
        planes = [(img.astype(np.int64), 1, 1, 0)]
        hmax = vmax = 1
    else:
        y, cb, cr = _bgr_to_ycc(img)
        planes = [(y, 2, 2, 0), (cb, 1, 1, 1), (cr, 1, 1, 1)]
        hmax = vmax = 2
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out_planes = []
    for samples, ch, cv, tq in planes:
        real = (-(-h * cv // (8 * vmax)), -(-w * ch // (8 * hmax)))  # height/width_in_blocks
        if ch != hmax:  # h2v2: downsampled over the whole plane first
            samples = downsample_h2v2(samples, real[1] * 8)
        alloc = (real if gray else (mcuy * cv, mcux * ch))
        plane = _Plane(_plane_coefficients(samples, real, alloc, tables[tq]), real, ch, cv, tq)
        if not gray:
            _fill_dummy_dc(plane, mcux, mcuy)
        out_planes.append(plane)

    codes = {key: _code_table(spec) for key, spec in STD_HUFFMAN.items()}
    zz = NATURAL_ORDER[:64]
    values: List[int] = []
    lengths: List[int] = []
    pred = [0] * len(out_planes)
    if gray:
        grid = [(0, by, bx) for by in range(out_planes[0].real[0])
                for bx in range(out_planes[0].real[1])]
    else:
        grid = [(k, my * p.v + y, mx * p.h + x) for my in range(mcuy) for mx in range(mcux)
                for k, p in enumerate(out_planes) for y in range(p.v) for x in range(p.h)]
    zigzag = [p.blocks[..., zz].tolist() for p in out_planes]
    for k, by, bx in grid:
        t = out_planes[k].table
        dc_code, dc_len = codes[(0, t)]
        ac_code, ac_len = codes[(1, t)]
        blk = zigzag[k][by][bx]
        s, bits = _magnitude(blk[0] - pred[k])
        pred[k] = blk[0]
        values += [int(dc_code[s]), bits]
        lengths += [int(dc_len[s]), s]
        run = 0
        for j in range(1, 64):
            v = blk[j]
            if v == 0:
                run += 1
                continue
            while run > 15:
                values.append(int(ac_code[0xF0]))
                lengths.append(int(ac_len[0xF0]))
                run -= 16
            s, bits = _magnitude(v)
            sym = (run << 4) | s
            values += [int(ac_code[sym]), bits]
            lengths += [int(ac_len[sym]), s]
            run = 0
        if run:
            values.append(int(ac_code[0x00]))
            lengths.append(int(ac_len[0x00]))
    return _headers(h, w, tables, gray) + _pack_bits(values, lengths) + b"\xff\xd9"


def _headers(h: int, w: int, tables, gray: bool) -> bytes:
    """SOI, JFIF, DQT, SOF0, DHT and SOS in the order libjpeg writes them."""
    zz = NATURAL_ORDER[:64]
    out = b"\xff\xd8" + JFIF_APP0
    for t in range(1 if gray else 2):
        out += _segment_bytes(0xDB, bytes([t]) + tables[t][zz].astype(np.uint8).tobytes())
    comps = [(1, 0x11, 0)] if gray else [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    sof = struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(bytes(c) for c in comps)
    out += _segment_bytes(0xC0, sof)
    for t in range(1 if gray else 2):
        for cls in (0, 1):
            out += _segment_bytes(0xC4, bytes([(cls << 4) | t]) + STD_HUFFMAN[(cls, t)])
    sos = bytes([len(comps)]) + b"".join(bytes([c[0], c[2] * 0x11]) for c in comps)
    return out + _segment_bytes(0xDA, sos + bytes([0, 63, 0]))


def _check_encode_input(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3) \
            or img.shape[0] == 0 or img.shape[1] == 0 or max(img.shape[:2]) > 65535:
        raise ValueError(f"JPEG encode takes (H, W, 3) BGR or (H, W) gray uint8 of at most "
                         f"65535 a side, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


# -- the host C version ------------------------------------------------------------

_C_ERRORS = {1: "truncated JPEG file", 2: "corrupt JPEG data"}


@functools.cache
def jpeg_library():
    """Build (at first use) and bind ``csrc/jpeg.cu``, once per process."""
    from ..ops.cuda_build import load_library

    built = load_library("jpeg.cu")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    built.lib.skyeye_jpeg_decode.argtypes = [ptr, i64, ptr, i32, i32]
    built.lib.skyeye_jpeg_decode.restype = i32
    for name in ("skyeye_jpeg_encode", "skyeye_jpeg_encode_progressive"):
        getattr(built.lib, name).argtypes = [ptr, i32, i32, i32, i32, ptr, i64]
        getattr(built.lib, name).restype = i64
    return built


def _use_native(native: Optional[bool]) -> bool:
    return torch.cuda.is_available() if native is None else native


def decode(data: bytes, native: Optional[bool] = None) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 BGR as ``cv2.imdecode(IMREAD_COLOR)`` gives
    them (the EXIF orientation applied). ``native``: the C version (built at
    first use; a failed build raises) or ``decode_plain``; by default the C
    version where CUDA is available."""
    frame = read_header(data)  # raises NotImplementedError for what is not ported
    if _use_native(native):
        out = np.empty((frame.height, frame.width, 3), np.uint8)
        buf = np.frombuffer(data, np.uint8)
        rc = jpeg_library().lib.skyeye_jpeg_decode(buf.ctypes.data, len(data), out.ctypes.data,
                                                   frame.width, frame.height)
        if rc == 3:  # the header read, so a progressive frame libjpeg would smooth
            raise NotImplementedError(f"progressive JPEG with unfinished coefficients: "
                                      f"{KINDS_NOT_PORTED}")
        if rc:
            raise ImageFormatError(_C_ERRORS.get(rc, f"JPEG decode failed ({rc})"))
    else:
        out = decode_plain(data)
    return apply_orientation(out, frame.orientation)


def encode(img: np.ndarray, quality: int = DEFAULT_QUALITY, native: Optional[bool] = None) -> bytes:
    """(H, W, 3) BGR or (H, W) gray uint8 -> the bytes ``cv2.imencode('.jpg')``
    writes at ``IMWRITE_JPEG_QUALITY`` ``quality``. ``native`` as in ``decode``."""
    img = _check_encode_input(img)
    if not _use_native(native):
        return encode_plain(img, quality)
    return _encode_c(img, quality, "skyeye_jpeg_encode")


def encode_progressive(img: np.ndarray, quality: int = DEFAULT_QUALITY) -> bytes:
    """``encode``'s coefficients written progressive: SOF2 and
    ``jpeg_simple_progression``'s scans (DC and AC first with successive
    approximation, then their refinements; ten for colour, six for gray) with
    the standard Huffman tables, each block closing its own EOB run. It decodes
    to the pixels of ``encode``'s file. Host C only (built at first use): a
    writer of test frames, which the port's loaders never call."""
    return _encode_c(_check_encode_input(img), quality, "skyeye_jpeg_encode_progressive")


def _encode_c(img: np.ndarray, quality: int, entry: str) -> bytes:
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    # at most 27 bits a coefficient (16 of code, 11 of value), doubled by stuffing
    capacity = (-(-h // 16) * 16) * (-(-w // 16) * 16) * channels * 7 + 4096
    out = np.empty(capacity, np.uint8)
    n = getattr(jpeg_library().lib, entry)(img.ctypes.data, h, w, channels,
                                           min(max(int(quality), 1), 100), out.ctypes.data,
                                           capacity)
    if n <= 0:
        raise RuntimeError(f"JPEG encode failed ({n})")
    return out[:n].tobytes()
