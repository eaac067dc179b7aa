"""Box annotation without OpenCV: ``colors``, ``Annotator``, ``plot_one_box``, ``save_one_box``.

Port of ``skyeye_tpu/utils/visualization.py:28-127``, which draws with
``cv2.rectangle(..., LINE_AA)`` and ``cv2.putText`` in FONT_HERSHEY_SIMPLEX. The
port draws in numpy and writes with ``data.imageio.imwrite``:

- A box outline is the band that cv2's anti-aliased thick rectangle fills
  with the full colour: every pixel within ``ceil(lw / 2)`` (Chebyshev
  distance) of the outline, and the outline alone at ``lw`` 1. Departure:
  cv2's one-pixel anti-aliased fringe around the band, its rounded outer
  corners and its attenuated ``lw`` 1 line are not drawn.
- A label box has cv2's geometry: ``text_size`` equals
  ``cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX, lw / 3, max(lw - 1, 1))[0]``
  for printable ASCII at line widths 1-6 (OpenCV 5's text engine: a string is
  as wide as its characters' widths less one pixel a join, and 9 * lw high;
  ``TEXT_ADVANCE`` holds the widths, measured with cv2). Wider lines scale the
  width-6 advances. The filled box covers cv2's fully coloured pixels.
  Departure: the glyphs come from the 5x7 bitmap font ``GLYPHS``, scaled to
  the text height, and not from cv2's outline font.

``plot_images``, ``plot_labels``, ``plot_results`` and the PR curves are not
ported (ROADMAP.md, Queue 1 item 15).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..data.imageio import imwrite


class Colors:
    """Deterministic class colour palette (hex ring)."""

    def __init__(self):
        hexs = (
            "FF3838", "FF9D97", "FF701F", "FFB21D", "CFD231", "48F90A", "92CC17",
            "3DDB86", "1A9334", "00D4BB", "2C99A8", "00C2FF", "344593", "6473FF",
            "0018EC", "8438FF", "520085", "CB38FF", "FF95C8", "FF37C7",
        )
        self.palette = [self._hex2rgb(f"#{c}") for c in hexs]
        self.n = len(self.palette)

    @staticmethod
    def _hex2rgb(h):
        return tuple(int(h[1 + i: 1 + i + 2], 16) for i in (0, 2, 4))

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()

FIRST_CHAR, LAST_CHAR = 32, 126  # printable ASCII; other characters draw as "?"
TEXT_HEIGHT_PER_LW = 9  # cv2's text height at fontScale lw / 3: 27 px a unit of scale
# cv2.getTextSize(c, FONT_HERSHEY_SIMPLEX, lw / 3, max(lw - 1, 1)) width less 1,
# for each printable ASCII character, at lw 1 to 6 (OpenCV 5.0.0)
TEXT_ADVANCE = {lw: np.frombuffer(bytes.fromhex(h), np.uint8).astype(np.int64) for lw, h in {
    1: "0202030605070602050504050204020405050505050505050505020204050405080606060605050606020605"
       "050706060606060505060607060605030403040703050505050503050502020402080505050503040305050705"
       "050403020305",
    2: "0404070d0b0e0d040b0b080b040904090b0b0b0b0b0b0b0b0b0b0405090a090a100c0c0c0d0b0b0d0d050c0b"
       "0a0f0d0d0c0d0c0b0b0d0c0f0c0c0b060906080e060a0b0a0b0a070b0b04040904110b0b0b0b0709070b0a0f0a"
       "0a090704070a",
    3: "07080c131216150612120c11070d070f1212121212121212121208080e100e10181414141412111415081312"
       "1017141413141312111413171313120a0e0a0d150b10111011100c1212070810071a121111110c0f0c12101710"
       "100f0b070b10",
    4: "090a101a191e1c09191911170a120a14191919191919191919190a0b13151316201b1a1a1b18171b1c0b1918"
       "161f1b1b191b1a19171b1a1f1919180e130e111c0e16171617161018180a0b150a221817171710141118161f16"
       "16140f090f15",
    5: "0c0d14211f26230b1f1f151d0d170d191f1f1f1f1f1f1f1f1f1f0d0e181b181b28212121221e1d22230e1f1f"
       "1c2722212021201f1d22202720201e1118111523121b1d1b1d1c141e1e0d0d1b0d2b1e1c1d1d141a151e1c271b"
       "1c1a130c131a",
    6: "0e101827252d2a0d252519230f1b0f1e2525252525252525252510101d201d2130282828282423282a112625"
       "212f2928262827252329272f262624151d151a2a1621232123211824240f10200f3424222323191f1924212f21"
       "211f170e1720",
}.items()}
# A 5x7 bitmap font for printable ASCII: 35 bits a character, rows top to bottom,
# each row's 5 pixels from the most significant bit
GLYPHS = np.array([
    [(int(h[i: i + 9], 16) >> (34 - b)) & 1 for b in range(35)]
    for h in ["".join((
        "000000000108421004294a00000295f57d4a11f4717c463222226332544564d108400000088842082208210888",
        "0095754800084f90800000030880000f800000000018c0022222003a33ae62e11842108e3a211111f7c441062e",
        "08ca97c427e1e0862e1910f462e7c22221083a317462e3a317844c018c03180018c03088088882082001f07c00",
        "2082088883a21110043a216d6ae3a31fc6317a31f463e3a308422e72518c65c7e10f421f7e10f42103a30bc62f",
        "4631fc63138842108e1c4210a4c4654c525142108421f4775ac6314639ace313a318c62e7a31f42103a318d64d",
        "7a31f52513e107043e7c842108446318c62e46318c5444631ad6aa462a22a31462a210847c222221f39084210e",
        "02082082038421084e11510000000000001f208200000000e0be2f4216cc63e000e8422e042d9c62f000e8fe0e",
        "1928e210801f18bc2e4216cc631100c2108e080610a4c4212a629230842108e001aad6310016cc631000e8c62e",
        "001e8fa10000d9bc210016cc210000e8383e211c4212600118c66d00118c54400118d6aa00115115100118bc2e",
        "001f1111f0884410821084210842084110880008a8800"))]
    for i in range(0, 9 * (LAST_CHAR - FIRST_CHAR + 1), 9)
], bool).reshape(-1, 7, 5)


def _char_index(ch: str) -> int:
    c = ord(ch)
    return (c if FIRST_CHAR <= c <= LAST_CHAR else ord("?")) - FIRST_CHAR


def _advances(text: str, lw: int) -> np.ndarray:
    idx = np.array([_char_index(ch) for ch in text], np.int64)
    if lw in TEXT_ADVANCE:
        return TEXT_ADVANCE[lw][idx]
    return np.rint(TEXT_ADVANCE[6][idx] * (lw / 6)).astype(np.int64)


def text_size(text: str, lw: int) -> Tuple[int, int]:
    """(w, h) of ``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, lw / 3,
    max(lw - 1, 1))``: exact for printable ASCII at lw 1-6."""
    if not text:
        return 0, 0
    return int(_advances(text, lw).sum()) + 1, TEXT_HEIGHT_PER_LW * lw


def _fill(im: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Fill the pixels [x0, x1] x [y0, y1], both ends included, clipped to im."""
    h, w = im.shape[:2]
    x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    y0, y1 = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if x0 <= x1 and y0 <= y1:
        im[y0: y1 + 1, x0: x1 + 1] = color


def _outline(im: np.ndarray, p1, p2, color, lw: int) -> None:
    """The full-colour band of ``cv2.rectangle(im, p1, p2, color, lw, LINE_AA)``."""
    half = (lw + 1) // 2 if lw > 1 else 0
    xa, xb = sorted((p1[0], p2[0]))
    ya, yb = sorted((p1[1], p2[1]))
    for y in (ya, yb):
        _fill(im, xa - half, y - half, xb + half, y + half, color)
    for x in (xa, xb):
        _fill(im, x - half, ya - half, x + half, yb + half, color)


def _text(im: np.ndarray, text: str, org, lw: int, color) -> None:
    """``text`` in the 5x7 font, baseline-left at org, glyphs centred in cv2's
    character widths and 7/9 of the text height tall."""
    gh = max(7, round(TEXT_HEIGHT_PER_LW * lw * 7 / 9))
    gw = max(5, round(gh * 5 / 7))
    rows, cols = np.arange(gh) * 7 // gh, np.arange(gw) * 5 // gw
    h, w = im.shape[:2]
    x = org[0]
    for ch, adv in zip(text, _advances(text, lw)):
        mask = GLYPHS[_char_index(ch)][rows][:, cols]
        ys, xs = np.nonzero(mask)
        ys = ys + org[1] - gh
        xs = xs + x + (int(adv) + 1 - gw) // 2
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        im[ys[keep], xs[keep]] = color
        x += int(adv)


class Annotator:
    """Box and label renderer over a numpy BGR image, drawn in place (as cv2
    draws on a contiguous array). ``font_size`` and ``pil`` are JAX's
    signature; the port has no PIL, so ``pil=True`` raises."""

    def __init__(self, im: np.ndarray, line_width: Optional[int] = None,
                 font_size: Optional[int] = None, pil: bool = False):
        if pil:
            raise NotImplementedError("the port draws in numpy; PIL is not on its machine")
        self.im = np.ascontiguousarray(im)
        self.lw = line_width or max(round(sum(self.im.shape[:2]) / 2 * 0.003), 2)

    def box_label(self, box, label: str = "", color=(128, 128, 128),
                  txt_color=(255, 255, 255)):
        p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
        channels = self.im.shape[2] if self.im.ndim == 3 else 1
        color = np.asarray(color, self.im.dtype)[:channels]
        _outline(self.im, p1, p2, color, self.lw)
        if label:
            w, h = text_size(label, self.lw)
            outside = p1[1] - h - 3 >= 0
            p2t = (p1[0] + w, p1[1] - h - 3 if outside else p1[1] + h + 3)
            _fill(self.im, p1[0], p1[1], p2t[0], p2t[1], color)
            _text(self.im, label, (p1[0], p1[1] - 2 if outside else p1[1] + h + 2), self.lw,
                  np.asarray(txt_color, self.im.dtype)[:channels])

    def result(self) -> np.ndarray:
        return self.im


ImageAnnotator = Annotator  # the reference's name (JAX's alias)


def plot_one_box(box, im: np.ndarray, color=(128, 128, 128), label: Optional[str] = None,
                 line_thickness: int = 3) -> np.ndarray:
    a = Annotator(im, line_width=line_thickness)
    a.box_label(box, label or "", color)
    return a.result()


def save_one_box(xyxy: Sequence[float], im: np.ndarray, file="crop.jpg", gain: float = 1.02,
                 pad: int = 10, square: bool = False, BGR: bool = True,
                 save: bool = True) -> np.ndarray:
    """Save and return an enlarged crop around a box (``detect --save-crop``),
    written by ``data.imageio.imwrite`` as cv2.imwrite writes it."""
    b = np.asarray(xyxy, np.float32).reshape(4)
    cx, cy = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
    w, h = (b[2] - b[0]) * gain + pad, (b[3] - b[1]) * gain + pad
    if square:
        w = h = max(w, h)
    x1, y1 = int(max(cx - w / 2, 0)), int(max(cy - h / 2, 0))
    x2, y2 = int(min(cx + w / 2, im.shape[1])), int(min(cy + h / 2, im.shape[0]))
    crop = im[y1:y2, x1:x2]
    if save:
        file = Path(file)
        file.parent.mkdir(parents=True, exist_ok=True)
        imwrite(file, crop if BGR else crop[..., ::-1])
    return crop
