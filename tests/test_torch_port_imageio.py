"""The port's image IO and resizes against OpenCV and PIL, which it stands in for.

``imread`` must equal ``cv2.imread`` exactly on PNGs written by cv2, by PIL and
by the port's own writer (every filter type, gray, RGBA, palette at 1, 4 and 8
bits, with transparency, 16-bit) and on BMPs; ``image_size`` must equal PIL's
``size`` (JPEG too; JPEG decoding is ``test_torch_port_jpeg.py``'s); broken files raise where PIL's ``verify()`` or cv2 refuse
them. ``resize_area`` and ``resize_linear`` must equal ``cv2.resize`` with
INTER_AREA and INTER_LINEAR bit for bit. The C unfilter loop is compiled here
with the host C++ compiler and held against ``unfilter_plain``.
"""
import ctypes
import shutil
import subprocess
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from skyeye_tpu_torch.data import imageio as iio

REPO = Path(__file__).resolve().parent.parent
H, W = 37, 53


def _smooth(rng, h, w, c):
    """Blocks of 4 px with small noise: every PNG filter type wins somewhere."""
    x = rng.randint(0, 250, (h // 4 + 1, w // 4 + 1, c)).astype(np.uint8)
    return (np.ascontiguousarray(x.repeat(4, 0).repeat(4, 1)[:h, :w])
            + rng.randint(0, 6, (h, w, c)).astype(np.uint8))


def _palette(rgb, colors, **save):
    return lambda path: Image.fromarray(rgb).convert(
        "P", palette=Image.ADAPTIVE, colors=colors).save(path, **save)


def _writers():
    rng = np.random.RandomState(0)
    im = _smooth(rng, H, W, 3)
    rgb = np.ascontiguousarray(im[:, :, ::-1])
    rgba = np.dstack([rgb, rng.randint(0, 256, (H, W, 1)).astype(np.uint8)])
    wide16 = im.astype(np.uint16) * 257 + rng.randint(0, 256, (H, W, 3)).astype(np.uint16)
    gray16 = (im[:, :, 0].astype(np.uint16) * 251)
    cases = {
        "cv2_bgr.png": lambda p: cv2.imwrite(p, im),
        "cv2_gray.png": lambda p: cv2.imwrite(p, im[:, :, 0].copy()),
        "cv2_bgra.png": lambda p: cv2.imwrite(p, _smooth(rng, H, W, 4)),
        "cv2_bgr16.png": lambda p: cv2.imwrite(p, wide16),
        "cv2_gray16.png": lambda p: cv2.imwrite(p, gray16),
        "cv2_stored.png": lambda p: cv2.imwrite(p, im, [cv2.IMWRITE_PNG_COMPRESSION, 0]),
        "cv2_level9.png": lambda p: cv2.imwrite(p, im, [cv2.IMWRITE_PNG_COMPRESSION, 9]),
        "pil_rgb.png": lambda p: Image.fromarray(rgb).save(p),
        "pil_rgba.png": lambda p: Image.fromarray(rgba).save(p),
        "pil_l.png": lambda p: Image.fromarray(rgb).convert("L").save(p),
        "pil_la.png": lambda p: Image.fromarray(rgb).convert("LA").save(p),
        "pil_1bit.png": lambda p: Image.fromarray(rgb).convert("1").save(p),
        "pil_i16.png": lambda p: Image.fromarray(gray16 + 100).save(p),
        "pil_palette8.png": _palette(rgb, 200),
        "pil_palette4.png": _palette(rgb, 13, bits=4),
        "pil_palette1.png": _palette(rgb, 2, bits=1),
        "pil_palette_trns.png": _palette(rgb, 50, transparency=3),
        "cv2_bgr.bmp": lambda p: cv2.imwrite(p, im),
        "cv2_gray.bmp": lambda p: cv2.imwrite(p, im[:, :, 0].copy()),
        "pil_rgb.bmp": lambda p: Image.fromarray(rgb).save(p),
        "pil_l.bmp": lambda p: Image.fromarray(rgb).convert("L").save(p),
        "pil_palette.bmp": _palette(rgb, 100),
        "pil_1bit.bmp": lambda p: Image.fromarray(rgb).convert("1").save(p),
        "pil_rgba.bmp": lambda p: Image.fromarray(rgba).save(p),
    }
    for t in range(5):
        cases[f"port_filter{t}.png"] = lambda p, t=t: iio.imwrite_png(p, im, filter_type=t)
        cases[f"port_gray_filter{t}.png"] = (
            lambda p, t=t: iio.imwrite_png(p, im[:, :, 1].copy(), filter_type=t))
    return cases


WRITERS = _writers()


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_imread_equals_cv2_and_image_size_equals_pil(tmp_path, name):
    path = str(tmp_path / name)
    WRITERS[name](path)
    want = cv2.imread(path)
    got = iio.imread(path)  # the CPU: the numpy unfilter
    assert got.dtype == np.uint8 and got.shape == want.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    with Image.open(path) as im:
        im.verify()
    with Image.open(path) as im:
        assert iio.image_size(path) == im.size


@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_size_equals_pil_and_decoding_names_the_roadmap(tmp_path, progressive):
    """A baseline JPEG (PIL's writer) reads as cv2.imread reads it; a progressive
    one raises, naming the roadmap item that will take it."""
    path = str(tmp_path / "frame.jpg")
    rgb = np.random.RandomState(1).randint(0, 256, (61, 97, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(path, quality=90, progressive=progressive)
    with Image.open(path) as im:
        assert iio.image_size(path) == im.size == (97, 61)
    if progressive:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            iio.imread(path)
    else:
        np.testing.assert_array_equal(iio.imread(path), cv2.imread(path))


def _png_bytes(tmp_path):
    path = tmp_path / "good.png"
    cv2.imwrite(str(path), np.random.RandomState(2).randint(0, 256, (40, 30, 3)).astype(np.uint8))
    return path.read_bytes()


def test_broken_files_raise_where_pil_and_cv2_refuse_them(tmp_path):
    data = _png_bytes(tmp_path)
    cases = {
        "truncated.png": data[: len(data) // 2],
        "no_iend.png": data[:-12],
        "zero.png": b"",
        "bad_crc.png": data[:40] + bytes([data[40] ^ 0xFF]) + data[41:],
        "text.png": b"not an image at all",
    }
    for name, content in cases.items():
        path = tmp_path / name
        path.write_bytes(content)
        with pytest.raises(Exception):  # what the JAX dataset relies on
            with Image.open(path) as im:
                im.verify()
        with pytest.raises(iio.ImageFormatError):
            iio.image_size(path)
        with pytest.raises(iio.ImageFormatError):
            iio.imread(path)
    with pytest.raises(FileNotFoundError):
        iio.imread(tmp_path / "missing.png")


def test_interlaced_png_is_refused_by_name(tmp_path):
    path = tmp_path / "adam7.png"
    iio.imwrite_png(path, np.full((20, 24, 3), 7, np.uint8))
    data = bytearray(path.read_bytes())
    data[28] = 1  # IHDR's interlace method: Adam7 (PIL writes no interlaced PNG)
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    path.write_bytes(bytes(data))
    with Image.open(path) as im:
        assert iio.image_size(path) == im.size
    with pytest.raises(iio.ImageFormatError, match="Adam7"):
        iio.imread(path)


def test_a_bad_filter_type_raises(tmp_path):
    rows = iio.png_filter(np.zeros((4, 9), np.uint8), 3, 0)
    rows[2, 0] = 7
    with pytest.raises(iio.ImageFormatError, match="filter type 7 on row 2"):
        iio.unfilter_plain(rows, 3)


# -- resizes ------------------------------------------------------------------

def _resize_cases():
    cases = []
    for h0, w0 in ((37, 53), (72, 128), (101, 77), (1080, 1920)):
        for f in (1 / 1.5, 1 / 2.5, 0.8):  # shrinks: by 1.5x, by 2.5x, to 0.8x
            cases.append(("area", h0, w0, max(1, int(h0 * f)), max(1, int(w0 * f))))
        for f in ((1.5, 2.5, 0.8, 1 / 1.5) if h0 < 1000 else (0.8, 1 / 1.5)):
            cases.append(("linear", h0, w0, max(1, int(h0 * f)), max(1, int(w0 * f))))
    for h0, w0, h, w in ((64, 64, 32, 32), (90, 120, 30, 40), (60, 60, 15, 15), (10, 14, 5, 7)):
        cases += [("area", h0, w0, h, w), ("linear", h0, w0, h, w)]  # whole-block scales
    cases += [("area", 97, 131, 97, 52), ("linear", 5, 7, 13, 17), ("linear", 7, 9, 7, 20),
              ("linear", 720, 1280, 736, 1309)]
    return cases


@pytest.mark.parametrize("kind,h0,w0,h,w", _resize_cases())
def test_resize_equals_cv2(kind, h0, w0, h, w):
    rng = np.random.RandomState(h0 * 7 + w0 + h)
    fn, flag = ((iio.resize_area, cv2.INTER_AREA) if kind == "area"
                else (iio.resize_linear, cv2.INTER_LINEAR))
    for channels in (3, 1, 4):
        im = rng.randint(0, 256, (h0, w0, channels)).astype(np.uint8)
        if channels == 1:
            im = im[:, :, 0].copy()
        got, want = fn(im, (w, h)), cv2.resize(im, (w, h), interpolation=flag)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_resize_area_refuses_to_grow():
    with pytest.raises(ValueError, match="shrinks only"):
        iio.resize_area(np.zeros((10, 10, 3), np.uint8), (12, 10))


# -- the C unfilter -------------------------------------------------------------

@pytest.fixture(scope="module")
def c_unfilter(tmp_path_factory):
    """csrc/png_unfilter.cu built by the host C++ compiler (it holds no device
    code), with the argument types the port binds."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the unfilter loop with")
    lib_path = tmp_path_factory.mktemp("unfilter") / "libunfilter.so"
    subprocess.run([cxx, "-x", "c++", "-O2", "-shared", "-fPIC", "-o", str(lib_path),
                    str(REPO / "skyeye_tpu_torch/csrc/png_unfilter.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.skyeye_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    lib.skyeye_png_unfilter.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_c_unfilter_equals_the_plain_version(c_unfilter, bpp):
    rng = np.random.RandomState(bpp)
    raw = np.ascontiguousarray(_smooth(rng, 45, 31, bpp).reshape(45, 31 * bpp))
    for t in range(5):
        filtered = iio.png_filter(raw, bpp, t)
        np.testing.assert_array_equal(iio.unfilter_plain(filtered, bpp), raw)
        filtered[::3, 0] = (filtered[::3, 0] + 2) % 5  # rows of other types between
        plain = iio.unfilter_plain(filtered, bpp)
        out = np.empty_like(raw)
        assert c_unfilter.skyeye_png_unfilter(filtered.ctypes.data, out.ctypes.data,
                                              raw.shape[0], raw.shape[1], bpp) == 0
        np.testing.assert_array_equal(out, plain)
    bad = iio.png_filter(raw, bpp, 0)
    bad[5, 0] = 9
    out = np.empty_like(raw)
    assert c_unfilter.skyeye_png_unfilter(bad.ctypes.data, out.ctypes.data, raw.shape[0],
                                          raw.shape[1], bpp) == 6


@pytest.mark.parametrize("filter_type", range(5))
def test_png_writer_round_trips_through_cv2(tmp_path, filter_type):
    im = _smooth(np.random.RandomState(filter_type), 50, 70, 3)
    path = str(tmp_path / "w.png")
    iio.imwrite_png(path, im, filter_type=filter_type, level=6)
    np.testing.assert_array_equal(cv2.imread(path), im)
    raw = zlib.decompress(b"".join(
        p for t, p in iio._png_chunks(Path(path).read_bytes()) if t == b"IDAT"))
    assert set(raw[:: 70 * 3 + 1]) == {filter_type}
    np.testing.assert_array_equal(iio.imread(path), im)
