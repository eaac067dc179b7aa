"""``skyeye_tpu_torch.data.loaders.LoadImages`` against JAX's.

On a folder of JPEG, PNG and BMP files (cv2-written, odd sizes), a glob and a
single file: the same files in the same order, and for each the same
``(path, img, img0, vid_cap, s)`` and ``mode``/``count``/``frame``, with
``img`` and ``img0`` equal byte for byte (JAX reads with ``cv2.imread`` and
letterboxes with cv2; the port with its own decoder and letterbox), at
``auto`` False (detect's) and True. Videos, webcams and streams raise,
naming the roadmap.
"""
import cv2
import numpy as np
import pytest

from skyeye_tpu.data import loaders as jax_loaders
from skyeye_tpu_torch.data import loaders as port_loaders

SHAPES = [(120, 200), (37, 53), (160, 224), (200, 150), (64, 48)]
SUFFIXES = ["jpg", "png", "jpeg", "bmp", "jpg"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("source")
    rng = np.random.RandomState(0)
    for i, ((h, w), suffix) in enumerate(zip(SHAPES, SUFFIXES)):
        coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
        im = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
        im = np.clip(im + rng.normal(0, 8, im.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"f{i}.{suffix}"), im)
    (root / "notes.txt").write_text("not an image")
    return root


def _items(loader):
    out = []
    for path, img, img0, cap, s in loader:
        out.append((path, img, img0, cap, s, loader.mode, loader.count, loader.frame))
    return out


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("source", ["folder", "glob", "file"])
def test_load_images_equals_jax(folder, source, auto):
    path = {"folder": folder, "glob": folder / "*.jp*g", "file": folder / "f0.jpg"}[source]
    kw = dict(img_size=160, stride=32, auto=auto)
    jax_ds, port_ds = jax_loaders.LoadImages(path, **kw), port_loaders.LoadImages(path, **kw)
    assert port_ds.files == jax_ds.files and len(port_ds) == len(jax_ds)
    assert len(port_ds) == {"folder": 5, "glob": 3, "file": 1}[source]
    got, want = _items(port_ds), _items(jax_ds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], g[3], g[4], g[5], g[6], g[7]) == (w[0], w[3], w[4], w[5], w[6], w[7])
        for a, b in ((g[1], w[1]), (g[2], w[2])):
            assert a.dtype == b.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, b)


def test_videos_webcams_and_streams_raise(folder, tmp_path):
    (tmp_path / "clip.mp4").write_bytes(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 14"):
        port_loaders.LoadImages(tmp_path)
    for make in (lambda: port_loaders.LoadWebcam("0"), lambda: port_loaders.LoadStreams("0")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make()
    with pytest.raises(FileNotFoundError):
        port_loaders.LoadImages(folder / "missing")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        port_loaders.LoadImages(empty)
