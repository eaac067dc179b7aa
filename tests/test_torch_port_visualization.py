"""``skyeye_tpu_torch.utils.visualization`` against JAX's cv2 drawing.

- ``colors`` equals JAX's palette, RGB and BGR.
- ``text_size`` equals ``cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX, lw / 3,
  max(lw - 1, 1))[0]`` for every printable ASCII character and for seeded
  strings, at line widths 1-6: the label box has cv2's geometry.
- Boxes drawn by the port's ``Annotator`` equal JAX's ``Annotator`` (cv2
  LINE_AA) everywhere except the anti-aliased fringe: pixels at Chebyshev
  distance ``ceil(lw / 2)`` or one more from the outline (within 1 px of the
  band's edge), the square of that reach around each corner (cv2 rounds the
  outer corners), and, where a label is drawn, its box widened by ``2 * lw``
  px (cv2's glyphs reach past the filled box; the port's glyphs are a bitmap
  font, a recorded departure). Tolerance 0 elsewhere.
- ``plot_one_box`` likewise; ``save_one_box`` returns JAX's crop and writes
  the bytes cv2 writes.
"""
import random

import cv2
import numpy as np
import pytest

import skyeye_tpu.utils.visualization as jvis
from skyeye_tpu_torch.utils import visualization as pvis


def test_colors_equal_jax():
    for i in range(45):
        assert pvis.colors(i) == jvis.colors(i)
        assert pvis.colors(i, True) == jvis.colors(i, True)


@pytest.mark.parametrize("lw", range(1, 7))
def test_label_box_geometry_equals_cv2(lw):
    tf = max(lw - 1, 1)
    for c in range(32, 127):
        assert pvis.text_size(chr(c), lw) == cv2.getTextSize(chr(c), 0, lw / 3, tf)[0], chr(c)
    rnd = random.Random(lw)
    alphabet = [chr(c) for c in range(32, 127)]
    for _ in range(200):
        s = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(1, 24)))
        assert pvis.text_size(s, lw) == cv2.getTextSize(s, 0, lw / 3, tf)[0], s
    assert pvis.text_size("", lw) == cv2.getTextSize("", 0, lw / 3, tf)[0]


def _chebyshev_to_outline(shape, p1, p2):
    ys, xs = np.mgrid[0: shape[0], 0: shape[1]]
    xa, xb = sorted((p1[0], p2[0]))
    ya, yb = sorted((p1[1], p2[1]))

    def segment(x0, y0, x1, y1):
        return np.maximum(abs(xs - np.clip(xs, x0, x1)), abs(ys - np.clip(ys, y0, y1)))

    return np.minimum.reduce([segment(xa, ya, xb, ya), segment(xa, yb, xb, yb),
                              segment(xa, ya, xa, yb), segment(xb, ya, xb, yb)])


def fringe(shape, box, lw, label):
    """The pixels the comparison leaves out: the outline's anti-aliased fringe and
    corners, and the label box (cv2's geometry) widened by 2 * lw."""
    x1, y1, x2, y2 = (int(v) for v in box)
    half = (lw + 1) // 2 if lw > 1 else 0
    d = _chebyshev_to_outline(shape, (x1, y1), (x2, y2))
    out = (d == half) | (d == half + 1)
    for cx in (x1, x2):
        for cy in (y1, y2):
            out[max(cy - half - 1, 0): max(cy + half + 2, 0),
                max(cx - half - 1, 0): max(cx + half + 2, 0)] = True
    if label:
        w, h = cv2.getTextSize(label, 0, lw / 3, max(lw - 1, 1))[0]
        top, bottom = (y1 - h - 3, y1) if y1 - h - 3 >= 0 else (y1, y1 + h + 3)
        m = 2 * lw
        out[max(top - m, 0): max(bottom + m + 1, 0), max(x1 - m, 0): max(x1 + w + m + 1, 0)] = True
    return out


@pytest.mark.parametrize("lw", range(1, 7))
def test_annotator_equals_jax_outside_the_fringe_and_the_label_boxes(lw):
    rng = np.random.RandomState(lw)
    rnd = random.Random(lw)
    for k in range(12):
        im = rng.randint(0, 256, (150, 230, 3)).astype(np.uint8)
        x1, y1 = rng.randint(-6, 140, 2)
        box = [x1 + rng.uniform(0, 1), y1 + rng.uniform(0, 1), x1 + rng.randint(0, 90),
               y1 + rng.randint(0, 90)]
        label = "" if k % 4 == 0 else "".join(rnd.choice("abgjpqy XYZ0123456789._-")
                                               for _ in range(rnd.randint(1, 14)))
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = jvis.Annotator(im.copy(), line_width=lw)
        want.box_label(box, label, color)
        got = pvis.Annotator(im.copy(), line_width=lw)
        got.box_label(box, label, color)
        keep = ~fringe(im.shape[:2], box, lw, label)
        np.testing.assert_array_equal(got.result()[keep], want.result()[keep],
                                      err_msg=f"box {box}, label {label!r}")
        assert (got.result() != im).any()


def test_default_line_width_and_in_place_drawing_follow_jax():
    for shape in [(90, 120, 3), (1080, 1920, 3), (37, 53, 3), (2160, 3840, 3)]:
        im = np.zeros(shape, np.uint8)
        assert pvis.Annotator(im).lw == jvis.Annotator(im).lw
    im = np.zeros((50, 60, 3), np.uint8)
    ann = pvis.ImageAnnotator(im, line_width=2)
    ann.box_label([5, 20, 40, 45], "car 0.90", pvis.colors(3, True))
    assert ann.result() is im and im.any()  # drawn in place, as cv2 draws
    with pytest.raises(NotImplementedError):
        pvis.Annotator(im, pil=True)


def test_plot_one_box_and_save_one_box_follow_jax(tmp_path):
    rng = np.random.RandomState(11)
    im = rng.randint(0, 256, (120, 170, 3)).astype(np.uint8)
    box = [20.7, 50.2, 90.4, 110.9]
    got = pvis.plot_one_box(box, im.copy(), (10, 200, 30), "bus 0.51", line_thickness=3)
    want = jvis.plot_one_box(box, im.copy(), (10, 200, 30), "bus 0.51", line_thickness=3)
    keep = ~fringe(im.shape[:2], box, 3, "bus 0.51")
    np.testing.assert_array_equal(got[keep], want[keep])
    for xyxy, kw in [(box, {}), ([150.0, 3.0, 175.0, 40.0], {"square": True}),
                     ([0.0, 0.0, 30.0, 20.0], {"gain": 1.2, "pad": 4, "BGR": False})]:
        p = pvis.save_one_box(xyxy, im, file=tmp_path / "port" / "c.jpg", **kw)
        j = jvis.save_one_box(xyxy, im, file=tmp_path / "jax" / "c.jpg", **kw)
        np.testing.assert_array_equal(p, j)
        assert (tmp_path / "port" / "c.jpg").read_bytes() == (tmp_path / "jax" / "c.jpg").read_bytes()
