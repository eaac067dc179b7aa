"""The port's JPEG codec (``data/jpeg.py``, ``csrc/jpeg.cu``) against OpenCV's.

cv2 reads and writes JPEG through libjpeg-turbo (3.1.2 in cv2 5.0.0 here); the
port repeats its integer paths. Tolerance 0 throughout:
- ``decode_plain`` equals ``cv2.imdecode`` bit for bit over sampling 4:4:4,
  4:2:2, 4:2:0 and 4:4:0, gray, qualities 50, 75, 95 and 100, sizes that are
  not a multiple of the MCU, with and without restart intervals, and on files
  of 1 and 2 pixels a side (libjpeg's box upsampling there);
- ``imread`` applies the EXIF orientation as ``cv2.imread`` does (3, 6 and 8,
  in either byte order, and the rest of 1-8);
- ``encode_plain`` writes the bytes ``cv2.imencode('.jpg')`` writes at its
  defaults, at quality 75, and for gray;
- the host C version, compiled here by the host C++ compiler (the file holds
  no device code) and bound as ``jpeg_library`` binds it, equals the plain
  versions pixel for pixel and byte for byte;
- progressive files (cv2's successive-approximation script, with and without
  restart intervals, every sampling and gray) decode as cv2 decodes them, in
  both versions; lossless, hierarchical, arithmetic-coded and 12-bit ones
  raise NotImplementedError naming the roadmap; truncated and corrupt ones
  raise ``ImageFormatError``, in both versions.
"""
import ctypes
import shutil
import struct
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest

from skyeye_tpu_torch.data import imageio, jpeg
from skyeye_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parent.parent
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
SIZES = [(37, 53), (64, 48), (160, 224)]
QUALITIES = (50, 75, 95, 100)


def _frame(rng, h, w, channels=3):
    """Smooth colour fields with noise: every coefficient band is busy."""
    coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, channels)).astype(np.float32)
    im = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, channels)
    im = np.clip(im + rng.normal(0, 12, im.shape), 0, 255).astype(np.uint8)
    return im if channels == 3 else np.ascontiguousarray(im[:, :, 0])


def _cv2_jpeg(im, **params):
    flags = []
    for key, value in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    ok, buf = cv2.imencode(".jpg", im, flags)
    assert ok
    return buf.tobytes()


def _cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_plain_decode_equals_cv2(sampling, size):
    rng = np.random.RandomState(sum(size) + int(sampling))
    for quality in QUALITIES:
        for rst in (0, 2):
            data = _cv2_jpeg(_frame(rng, *size), quality=quality, rst_interval=rst,
                             sampling_factor=SAMPLING[sampling])
            np.testing.assert_array_equal(jpeg.decode_plain(data), _cv2_decode(data),
                                          err_msg=f"quality {quality}, restart {rst}")


@pytest.mark.parametrize("size", SIZES + [(1, 1), (2, 3), (17, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_decode_equals_cv2_for_gray_and_tiny_frames(size):
    rng = np.random.RandomState(size[0] * size[1])
    for quality in QUALITIES:
        gray = _cv2_jpeg(_frame(rng, *size, channels=1), quality=quality)
        np.testing.assert_array_equal(jpeg.decode_plain(gray), _cv2_decode(gray))
        color = _cv2_jpeg(_frame(rng, *size), quality=quality)
        np.testing.assert_array_equal(jpeg.decode_plain(color), _cv2_decode(color))


def _with_exif(data: bytes, orientation: int, order: str) -> bytes:
    """An APP1 Exif segment with one IFD0 entry, the orientation, after SOI."""
    tiff = ({"<": b"II", ">": b"MM"}[order] + struct.pack(order + "HI", 42, 8)
            + struct.pack(order + "H", 1) + struct.pack(order + "HHI", 0x0112, 3, 1)
            + struct.pack(order + "H", orientation) + b"\0\0" + struct.pack(order + "I", 0))
    payload = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + data[2:]


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_exif_orientation_equals_cv2_imread(tmp_path, orientation):
    data = _cv2_jpeg(_frame(np.random.RandomState(orientation), 24, 40))
    for order in "<>":
        for o in sorted({orientation, *range(1, 9)}) if order == "<" else [orientation]:
            path = tmp_path / f"o{o}{'le' if order == '<' else 'be'}.jpg"
            path.write_bytes(_with_exif(data, o, order))
            got = imageio.imread(path)
            np.testing.assert_array_equal(got, cv2.imread(str(path)), err_msg=f"orientation {o}")
            if o == orientation:
                assert got.shape[:2] == ((40, 24) if o in (6, 8) else (24, 40))
                assert imageio.image_size(path) == (40, 24)  # PIL's size: as stored


@pytest.mark.parametrize("case", ["defaults", "quality75", "gray", "gray_quality75"])
def test_plain_encode_writes_cv2s_bytes(case):
    rng = np.random.RandomState(len(case))
    for size in SIZES + [(1, 1), (9, 17)]:
        im = _frame(rng, *size, channels=1 if "gray" in case else 3)
        params = {"quality": 75} if "75" in case else {}
        want = _cv2_jpeg(im, **params)
        got = jpeg.encode_plain(im, **params)
        assert got == want, f"{size}: {len(got)} bytes against cv2's {len(want)}"


def test_imwrite_writes_what_cv2_imwrite_writes(tmp_path):
    im = _frame(np.random.RandomState(7), 45, 67)
    for name in ("a.jpg", "b.jpeg", "c.bmp"):
        imageio.imwrite(tmp_path / name, im)
        cv2.imwrite(str(tmp_path / f"cv2_{name}"), im)
        assert (tmp_path / name).read_bytes() == (tmp_path / f"cv2_{name}").read_bytes()
    imageio.imwrite(tmp_path / "d.png", im)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "d.png")), im)
    with pytest.raises(ValueError, match="imwrite writes"):
        imageio.imwrite(tmp_path / "e.tif", im)


def test_refusals(tmp_path):
    """Lossless, hierarchical, arithmetic-coded and 12-bit frames, and a
    progressive file that leaves low coefficients unfinished (libjpeg would
    smooth its blocks), raise NotImplementedError naming item 13; truncated
    files raise ImageFormatError."""
    im = _frame(np.random.RandomState(8), 40, 56)
    progressive = _cv2_jpeg(im, progressive=1)
    sof = progressive.index(b"\xff\xc2")
    for marker in (0xC3, 0xC5, 0xC9, 0xCA):
        data = progressive[:sof + 1] + bytes([marker]) + progressive[sof + 2:]
        with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 13"):
            jpeg.decode_plain(data)
    twelve = progressive[:sof + 4] + bytes([12]) + progressive[sof + 5:]
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 13"):
        jpeg.decode_plain(twelve)
    unfinished = progressive[:_scan_starts(progressive)[3]] + b"\xff\xd9"
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 13"):
        jpeg.decode_plain(unfinished)
    path = tmp_path / "p.jpg"
    path.write_bytes(unfinished)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        imageio.imread(path)
    data = _cv2_jpeg(im)
    for cut in (len(data) - 2, len(data) // 2, 200, 20, 3):
        with pytest.raises(imageio.ImageFormatError):
            jpeg.decode_plain(data[:cut])
        path.write_bytes(data[:cut])
        with pytest.raises(imageio.ImageFormatError):
            imageio.imread(path)


def _scan_starts(data: bytes):
    """Offsets of the SOS markers (0xFF is stuffed in entropy-coded data, so
    0xFFDA is always a marker), where a file can be cut between scans."""
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.fixture(scope="module")
def c_codec(tmp_path_factory):
    """csrc/jpeg.cu built by the host C++ compiler and bound by ``jpeg_library``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the JPEG codec with")
    lib_path = tmp_path_factory.mktemp("jpeg") / "libjpeg_host.so"
    subprocess.run([cxx, "-x", "c++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    str(lib_path), str(REPO / "skyeye_tpu_torch/csrc/jpeg.cu")], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(cuda_build, "load_library",
               lambda source: cuda_build.Built(ctypes.CDLL(str(lib_path)), lib_path, 0.0, ""))
    jpeg.jpeg_library.cache_clear()
    yield jpeg.jpeg_library()
    jpeg.jpeg_library.cache_clear()
    mp.undo()


@pytest.mark.parametrize("sampling", list(SAMPLING) + ["gray"])
def test_c_codec_equals_the_plain_versions(c_codec, sampling):
    rng = np.random.RandomState(len(sampling))
    for size in SIZES + [(1, 1), (2, 3)]:
        for quality in QUALITIES:
            im = _frame(rng, *size, channels=1 if sampling == "gray" else 3)
            params = {} if sampling == "gray" else {"sampling_factor": SAMPLING[sampling]}
            for rst in (0, 3):
                for progressive in (0, 1):
                    data = _cv2_jpeg(im, quality=quality, rst_interval=rst,
                                     progressive=progressive, **params)
                    np.testing.assert_array_equal(jpeg.decode(data, native=True),
                                                  jpeg.decode_plain(data))
            if sampling in ("420", "gray"):  # what the encoder writes
                assert jpeg.encode(im, quality, native=True) == jpeg.encode_plain(im, quality)


def test_c_codec_refuses_what_the_plain_version_refuses(c_codec):
    data = _cv2_jpeg(_frame(np.random.RandomState(9), 40, 56))
    for cut in range(len(data) - 2, 150, -41):
        for native in (True, False):
            with pytest.raises(imageio.ImageFormatError, match="truncated|corrupt"):
                jpeg.decode(data[:cut], native=native)
    noise = np.random.RandomState(10).randint(0, 256, (256, 384, 3)).astype(np.uint8)
    data = _cv2_jpeg(noise, quality=100)
    assert jpeg.encode(noise, 100, native=True) == data
    np.testing.assert_array_equal(jpeg.decode(data, native=True), _cv2_decode(data))
