"""The port's native host prep (``data/native.py``, ``csrc/prep.cu``) against JAX's.

JAX's ``skyeye_tpu.data.native`` runs ``native/libskyeye_prep.so`` (libjpeg,
libpng, g++ -O3 -march=native, so FMA-contracted). The port's numpy version
must equal it bit for bit, ``meta`` to the float and ``n_ok`` equal, on seeded
files: JPEG baseline 4:2:0 and 4:4:4, gray, progressive (restart intervals),
EXIF-oriented (neither side rotates); PNG 8- and 16-bit, palette with tRNS,
RGBA, gray+alpha, Adam7; the sizes whose blend differs without the fused
multiply-adds (333x517 -> 320, 719x1281 -> 416); upscales; a missing, a
corrupt and a truncated file; and
``prep_batch_s2d4`` and ``decode_shape``. A truncated progressive file that
libjpeg would smooth is the recorded departure (ROADMAP Queue 3): JAX decodes
it, the port zeroes the frame. The host C version, compiled here by the host
C++ compiler (it holds no device code) with the flags ``prep_library`` gives
nvcc, equals the numpy version byte for byte; progressive JPEG and Adam7 PNG
decode as ``cv2.imread`` reads them, pixel for pixel, in both versions. The
library key follows the files ``prep.cu`` includes.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

import skyeye_tpu.data.native as jax_native
from skyeye_tpu_torch.data import imageio, jpeg
from skyeye_tpu_torch.data import native
from skyeye_tpu_torch.ops import cuda_build
from test_torch_port_jpeg import _with_exif

REPO = Path(__file__).resolve().parent.parent
FMA_CASES = [((333, 517), 320), ((719, 1281), 416)]

if not jax_native.native_available():
    pytest.skip("JAX's native library (native/libskyeye_prep.so) does not load here",
                allow_module_level=True)


def _frame(rng, h, w):
    coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    im = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(im + rng.normal(0, 12, im.shape), 0, 255).astype(np.uint8)


def _jpeg(im, **params):
    flags = []
    for key, value in params.items():
        flags += [getattr(cv2, f"IMWRITE_JPEG_{key.upper()}"), value]
    return cv2.imencode(".jpg", im, flags)[1].tobytes()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """name -> path of every seeded case."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(11)
    im = _frame(rng, 150, 230)
    out = {}

    def put(name, data):
        out[name] = root / name
        out[name].write_bytes(data)

    put("b420.jpg", _jpeg(im))
    put("b444.jpeg", _jpeg(im, sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444))
    put("gray.jpg", _jpeg(im[:, :, 1]))
    put("progressive.jpg", _jpeg(im, progressive=1, rst_interval=3))
    put("exif6.jpg", _with_exif(_jpeg(im), 6, "<"))
    baseline = _jpeg(im, rst_interval=2)
    put("truncated.jpg", baseline[: len(baseline) * 3 // 5])
    put("corrupt.jpg", b"\xff\xd8 not a JPEG after all")
    put("png8.png", cv2.imencode(".png", im)[1].tobytes())
    put("png16.PNG", cv2.imencode(".png", im.astype(np.uint16) * 257 + 99)[1].tobytes())
    put("rgba.png", cv2.imencode(".png", np.dstack([im, im[:, :, 0]]))[1].tobytes())
    Image.fromarray(np.ascontiguousarray(im[:, :, 1:])).save(root / "graya.png")  # gray+alpha
    out["graya.png"] = root / "graya.png"
    Image.fromarray(im).convert("P", palette=Image.ADAPTIVE, colors=12).save(
        root / "palette.png", transparency=2)
    out["palette.png"] = root / "palette.png"
    imageio.imwrite_png(root / "adam7.png", im, 4, interlace=True)
    out["adam7.png"] = root / "adam7.png"
    put("upscale.jpg", _jpeg(_frame(rng, 30, 21)))
    for (h, w), _ in FMA_CASES:
        put(f"fma{h}.png", cv2.imencode(".png", _frame(rng, h, w))[1].tobytes())
    out["missing.jpg"] = root / "missing.jpg"
    return out


def _hold(got, want):
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("size", [128, 320])
def test_plain_prep_equals_jax_bit_for_bit(files, size):
    paths = [str(p) for name, p in files.items() if not name.startswith("fma")]
    want = jax_native.prep_batch(paths, size, size)
    _hold(native.prep_batch(paths, size, size, native=False), want)
    assert want[2] == len(paths) - 2  # the missing and the corrupt file
    _hold(native.prep_batch_s2d4(paths, size, native=False),
          jax_native.prep_batch_s2d4(paths, size))
    out = np.full((len(paths), size, size + 32, 3), 7, np.uint8)
    got = native.prep_batch(paths, size, size + 32, out=out, native=False)
    assert got[0] is out
    _hold(got, jax_native.prep_batch(paths, size, size + 32))


@pytest.mark.parametrize("case", FMA_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_the_fused_multiply_add_cases_equal_jax(files, case):
    """Sizes where an unfused blend rounds one pixel differently."""
    (h, _), size = case
    path = [str(files[f"fma{h}.png"])]
    _hold(native.prep_batch(path, size, size, native=False),
          jax_native.prep_batch(path, size, size))


def test_decode_shape_equals_jax(files):
    for name, path in files.items():
        if name.startswith("fma"):
            continue
        assert native.decode_shape(path, native=False) == jax_native.decode_shape(path), name


def test_truncated_progressive_file_is_the_recorded_departure(files, tmp_path):
    """libjpeg smooths the blocks of a progressive file whose scans stop early
    (``jdcoefct.c``); the port refuses it (ROADMAP item 13): JAX decodes the
    frame, the port zeroes it. Cut inside the last scan, where nothing is
    smoothed, the two agree."""
    data = files["progressive.jpg"].read_bytes()
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    early, late = tmp_path / "early.jpg", tmp_path / "late.jpg"
    early.write_bytes(data[: sos[4] + 40])
    late.write_bytes(data[: (sos[-1] + len(data)) // 2])
    want = jax_native.prep_batch([str(early), str(late)], 128, 128)
    got = native.prep_batch([str(early), str(late)], 128, 128, native=False)
    assert want[2] == 2 and got[2] == 1 and got[1][0, 0] == 0 and not got[0][0].any()
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[1][1], want[1][1])
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        jpeg.decode_coefficients(early.read_bytes(), lenient=True)


def test_progressive_and_adam7_decode_as_cv2_reads_them(files, tmp_path):
    rng = np.random.RandomState(5)
    for h, w in ((1, 1), (13, 7), (64, 64), (97, 61)):
        im = _frame(rng, h, w)
        for path, data in ((tmp_path / "p.jpg", _jpeg(im, progressive=1)),
                           (tmp_path / "g.jpg", _jpeg(im[:, :, 0], progressive=1))):
            path.write_bytes(data)
            np.testing.assert_array_equal(native.decode_rgb_plain(path)[:, :, ::-1],
                                          cv2.imread(str(path)))
        imageio.imwrite_png(tmp_path / "a.png", im, 2, interlace=True)
        np.testing.assert_array_equal(native.decode_rgb_plain(tmp_path / "a.png")[:, :, ::-1],
                                      cv2.imread(str(tmp_path / "a.png")))


@pytest.fixture(scope="module")
def c_prep(tmp_path_factory):
    """csrc/prep.cu built by the host C++ compiler with ``prep_library``'s own
    flags, and bound as ``prep_library`` binds it."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the host prep with")
    lib_path = tmp_path_factory.mktemp("prep") / "libprep_host.so"
    flags = [f for f in native.host_flags() if f != "-Xcompiler"]
    subprocess.run([cxx, "-x", "c++", "-O3", "-std=c++17", "-shared", "-fPIC", *flags, "-o",
                    str(lib_path), str(REPO / "skyeye_tpu_torch/csrc/prep.cu")], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(cuda_build, "load_library", lambda source, extra_flags=(): cuda_build.Built(
        ctypes.CDLL(str(lib_path)), lib_path, 0.0, ""))
    native.prep_library.cache_clear()
    yield native.prep_library()
    native.prep_library.cache_clear()
    mp.undo()


def test_c_prep_equals_the_plain_version(c_prep, files):
    paths = [str(p) for p in files.values()]
    for size, threads in ((128, 1), (320, 4), (416, 0)):
        _hold(native.prep_batch(paths, size, size, n_threads=threads, native=True),
              native.prep_batch(paths, size, size, native=False))
    _hold(native.prep_batch_s2d4(paths, 320, native=True),
          native.prep_batch_s2d4(paths, 320, native=False))
    for name, path in files.items():
        assert native.decode_shape(path, native=True) == jax_native.decode_shape(path), name


def test_c_prep_decodes_progressive_and_adam7_as_cv2(c_prep, tmp_path):
    """A square frame letterboxed to its own size is copied through: the C
    decode itself, held against cv2.imread."""
    im = _frame(np.random.RandomState(6), 96, 96)
    (tmp_path / "p.jpg").write_bytes(_jpeg(im, progressive=1, rst_interval=5))
    imageio.imwrite_png(tmp_path / "a.png", im, 3, interlace=True)
    for name in ("p.jpg", "a.png"):
        path = str(tmp_path / name)
        frames, meta, n_ok = native.prep_batch([path], 96, 96, native=True)
        assert n_ok == 1 and meta[0].tolist() == [1.0, 0.0, 0.0]
        np.testing.assert_array_equal(frames[0][:, :, ::-1], cv2.imread(path))


def test_the_library_key_follows_included_files(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(REPO / "skyeye_tpu_torch" / "csrc", csrc)
    flags = (*cuda_build.NVCC_FLAGS, *native.host_flags())
    names = [p.name for p in cuda_build.source_files(csrc / "prep.cu")]
    assert names == ["prep.cu", "jpeg.cu", "png_unfilter.cu"]
    before = cuda_build.library_key(csrc / "prep.cu", flags)
    jpeg_key = cuda_build.library_key(csrc / "jpeg.cu", cuda_build.NVCC_FLAGS)
    (csrc / "jpeg.cu").write_text((csrc / "jpeg.cu").read_text() + "\n// changed\n")
    assert cuda_build.library_key(csrc / "prep.cu", flags) != before
    assert cuda_build.library_key(csrc / "jpeg.cu", cuda_build.NVCC_FLAGS) != jpeg_key
    assert cuda_build.library_key(csrc / "png_unfilter.cu", ()) == cuda_build.library_key(
        REPO / "skyeye_tpu_torch" / "csrc" / "png_unfilter.cu", ())
