"""The port's dataset and batch loader against JAX's, on the same files.

A YOLO-layout directory of PNG and BMP frames of mixed aspect (written with
cv2), with a background image, an image without a label file, and files that
both packages must count as corrupt and drop: a truncated PNG, an image under
10 px, negative and 4-column labels. ``skyeye_tpu_torch.data.dataset`` must
find, keep and order the same files with the same labels and shapes, build the
same rect batch shapes with and without ``shape_buckets``, give the same items
(letterboxed images bit for bit) and the same ``BatchLoader`` batches as JAX's
Python path (its native C++ decoder switched off in the test).
"""
import json
import logging
import os
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml

import skyeye_tpu.data.dataset as jax_dataset
import skyeye_tpu.data.native as jax_native
from skyeye_tpu.config import DataConfig as JaxDataConfig
from skyeye_tpu_torch.config import _SCHEMA, DataConfig, _read_flat_yaml
from skyeye_tpu_torch.data import dataset
from skyeye_tpu_torch.data.prefetch import _PinnedRing
from skyeye_tpu_torch.utils.general import check_dataset, increment_path

REPO = Path(__file__).resolve().parent.parent

SHAPES = [(120, 200), (150, 200), (200, 150), (160, 160), (90, 240), (200, 130),
          (140, 190), (256, 200), (100, 180), (210, 100), (120, 200), (77, 131)]


def _frame(rng, h, w):
    coarse = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    return np.ascontiguousarray(coarse.repeat(8, 0).repeat(8, 1)[:h, :w])


def _labels(rng, n, nc=4):
    xy = rng.uniform(0.2, 0.8, (n, 2))
    wh = rng.uniform(0.02, 0.3, (n, 2))
    return np.concatenate([rng.randint(0, nc, (n, 1)), xy, wh], 1)


def write_dataset(root: Path, seed: int = 0):
    """images/val and labels/val under root: 12 good images, 4 corrupt ones."""
    rng = np.random.RandomState(seed)
    img_dir, lbl_dir = root / "images" / "val", root / "labels" / "val"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(SHAPES):
        ext = "bmp" if i % 5 == 4 else "png"
        cv2.imwrite(str(img_dir / f"im{i:02d}.{ext}"), _frame(rng, h, w))
        if i == 3:
            continue  # no label file: a background image
        rows = _labels(rng, 0 if i == 5 else rng.randint(1, 9))
        if i == 7:  # a segment polygon: class and 4 points
            rows = [[2, 0.3, 0.3, 0.5, 0.25, 0.6, 0.5, 0.35, 0.55]]
        (lbl_dir / f"im{i:02d}.txt").write_text(
            "\n".join(" ".join(f"{v:.6f}" for v in r) for r in rows) + "\n")
    good = (img_dir / "im00.png").read_bytes()
    (img_dir / "truncated.png").write_bytes(good[: len(good) // 2])
    cv2.imwrite(str(img_dir / "tiny.png"), _frame(rng, 8, 30))
    cv2.imwrite(str(img_dir / "negative.png"), _frame(rng, 64, 64))
    (lbl_dir / "negative.txt").write_text("1 -0.2 0.5 0.1 0.1\n")
    cv2.imwrite(str(img_dir / "fourcols.png"), _frame(rng, 64, 64))
    (lbl_dir / "fourcols.txt").write_text("1 0.5 0.1 0.1\n")
    (img_dir / "notes.txt").write_text("not an image\n")


@pytest.fixture
def data_root(tmp_path):
    write_dataset(tmp_path)
    return tmp_path


@pytest.fixture
def python_path(monkeypatch):
    """JAX's BatchLoader on its Python path (the port does not have the native one)."""
    monkeypatch.setattr(jax_native, "native_available", lambda: False)


def _same_dataset(ours, theirs):
    assert ours.img_files == theirs.img_files
    assert ours.label_files == theirs.label_files
    assert len(ours) == len(theirs)
    np.testing.assert_array_equal(ours.shapes, theirs.shapes)
    np.testing.assert_array_equal(ours.batch_index, theirs.batch_index)
    for a, b in zip(ours.labels, theirs.labels):
        np.testing.assert_array_equal(a, b)


def test_helpers_match_jax(data_root):
    split = data_root / "images" / "val"
    files = dataset.find_images(split)
    assert files == jax_dataset.find_images(split)
    listing = data_root / "val.txt"
    listing.write_text("\n".join(["./images/val/im01.png", str(split / "im02.png"), ""]))
    assert dataset.find_images(listing) == jax_dataset.find_images(listing)
    pattern = str(split / "im0*.png")
    assert dataset.find_images([pattern]) == jax_dataset.find_images([pattern])
    assert dataset.img2label_paths(files) == jax_dataset.img2label_paths(files)
    assert dataset.get_hash(files) == jax_dataset.get_hash(files)
    for f, lbl in zip(files, dataset.img2label_paths(files)):
        ours = dataset.verify_image_label((f, lbl))
        theirs = jax_dataset.verify_image_label((f, lbl))
        assert (ours[0], ours[2], ours[3:6]) == (theirs[0], theirs[2], theirs[3:6]), f
        if ours[1] is not None:
            np.testing.assert_array_equal(ours[1], theirs[1])


@pytest.mark.parametrize("rect,buckets", [(False, None), (True, None), (True, 2), (True, 8)])
def test_scan_rect_shapes_and_items_match_jax(data_root, rect, buckets, caplog):
    split = data_root / "images" / "val"
    kw = dict(img_size=128, batch_size=3, rect=rect, stride=32, pad=0.5 if rect else 0.0,
              shape_buckets=buckets)
    caplog.set_level(logging.INFO)
    ours = dataset.AerialDataset(split, **kw)
    assert f"dataset scan: {len(SHAPES) - 2} labeled, 2 background, 4 corrupt" in caplog.text
    theirs = jax_dataset.AerialDataset(split, **kw)
    _same_dataset(ours, theirs)
    assert len(ours) == len(SHAPES)
    if rect:
        np.testing.assert_array_equal(ours.batch_shapes, theirs.batch_shapes)
        assert len({tuple(s) for s in ours.batch_shapes.tolist()}) <= (buckets or 99)
    for i in range(len(ours)):
        img, labels = ours[i]
        want_img, want_labels = theirs[i]
        np.testing.assert_array_equal(img, want_img)
        np.testing.assert_allclose(labels, want_labels, rtol=0, atol=1e-6)
        for a, b in zip(ours.padded_labels(labels), theirs.padded_labels(want_labels)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_cache_is_the_ports_own_and_is_read_back(data_root, monkeypatch):
    split = data_root / "images" / "val"
    first = dataset.AerialDataset(split, img_size=128)
    cache = data_root / "labels" / "val.cache"
    assert json.loads(cache.read_text())["version"] == dataset.CACHE_VERSION

    def unreachable(args):
        raise AssertionError("the cache should have been read")

    monkeypatch.setattr(dataset, "verify_image_label", unreachable)
    again = dataset.AerialDataset(split, img_size=128)  # a cache hit, corrupt files dropped
    _same_dataset(again, first)
    monkeypatch.undo()

    theirs = jax_dataset.AerialDataset(split, img_size=128)  # reads no JSON: rebuilds
    _same_dataset(first, theirs)
    assert cache.read_bytes()[:6] == b"\x93NUMPY"  # JAX's np.save
    ours = dataset.AerialDataset(split, img_size=128)  # JAX's cache is not read: rebuilt
    _same_dataset(ours, theirs)
    assert json.loads(cache.read_text())["version"] == dataset.CACHE_VERSION


def test_changed_files_rebuild_the_cache(data_root):
    split = data_root / "images" / "val"
    dataset.AerialDataset(split, img_size=128)
    label = data_root / "labels" / "val" / "im00.txt"
    label.write_text("0 0.5 0.5 0.2 0.2\n1 0.25 0.25 0.1 0.3\n3 0.7 0.7 0.05 0.05\n")
    os.utime(label)
    ours = dataset.AerialDataset(split, img_size=128)
    assert ours.labels[ours.img_files.index(str(split / "im00.png"))].shape == (3, 5)


@pytest.mark.parametrize("rect", [False, True])
def test_batch_loader_matches_jax_python_path(data_root, python_path, rect):
    split = data_root / "images" / "val"
    kw = dict(img_size=128, batch_size=5, stride=32, rect=rect, pad=0.5 if rect else 0.0,
              workers=3, shuffle=False, shape_buckets=8)
    loader, _ = dataset.create_dataloader(split, **kw)
    jloader, _ = jax_dataset.create_dataloader(split, **kw)
    assert not jloader._use_native
    ours, theirs = list(loader), list(jloader)
    assert len(ours) == len(theirs) == len(loader) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert int(ours[-1]["n_valid"]) == len(SHAPES) - 10


def test_infinite_loader_matches_jax_across_passes(data_root, python_path):
    """Batches without end, shuffled anew each pass from the seed, as JAX's
    ``InfiniteBatchLoader`` gives them: 7 batches of 5 from 12 frames run into
    a third pass (the last batch of each pass padded by wrapping around)."""
    split = data_root / "images" / "val"
    kw = dict(img_size=128, stride=32, cache_images=False, max_labels=8)
    ours = dataset.InfiniteBatchLoader(dataset.AerialDataset(split, **kw), batch_size=5,
                                       shuffle=True, workers=2, seed=3)
    theirs = jax_dataset.InfiniteBatchLoader(jax_dataset.AerialDataset(split, **kw),
                                             batch_size=5, shuffle=True, workers=2, seed=3)
    assert not theirs._use_native
    got, want = list(ours.take(7)), list(theirs.take(7))
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_load_dataset_and_a_loader_error_reach_the_caller(data_root):
    ds = dataset.load_dataset(data_root / "images" / "val", img_size=96)
    assert len(ds) == len(SHAPES)
    loader = dataset.BatchLoader(ds, batch_size=4, workers=2)
    os.remove(ds.img_files[5])
    with pytest.raises(FileNotFoundError):
        list(loader)


@pytest.mark.parametrize("path", sorted((REPO / "configs" / "data").glob("*.yaml")),
                         ids=lambda p: p.name)
def test_data_config_matches_jax_with_and_without_pyyaml(path, monkeypatch):
    want = JaxDataConfig.from_yaml(path)
    text = path.read_text()
    assert _read_flat_yaml(text) == yaml.safe_load(text)
    monkeypatch.setitem(sys.modules, "yaml", None)  # the card's machine: no PyYAML
    assert DataConfig.from_yaml(path) == DataConfig(**vars(want))
    assert check_dataset(path.name) == DataConfig(**vars(want))  # found under configs/


@pytest.mark.parametrize("text", [
    "test: ~", "test: null", "test:", "names: [a, 'b c']", "names: {0: a, 1: b}",
    "names:\n- a\n- b", "names:\n  0: a\n  1: b", "nc: 10\npath: ../x  # a comment",
    "download: |\n  curl x\n  y: z\nval: v"])
def test_flat_reader_reads_what_pyyaml_reads(text):
    want = {k: v for k, v in yaml.safe_load(text).items() if k in _SCHEMA}
    assert _read_flat_yaml(text) == want


@pytest.mark.parametrize("text", [
    "nc: 1.5", "train: yes", "val: 'a #b'", "nc: 010", "names:\n  - a\n  1: b",
    "path: a: b", 'val: "a\\tb"', "val: [a, b", "val: &x a", "val: a\n  - b"])
def test_flat_reader_raises_outside_the_schema(text):
    with pytest.raises(ValueError):
        _read_flat_yaml(text)


def test_a_null_split_reads_as_absent(tmp_path):
    (tmp_path / "d.yaml").write_text("path: data\nval: images/val\ntest: ~\n")
    cfg = DataConfig.from_yaml(tmp_path / "d.yaml")
    assert cfg.test == "" and cfg.val == str(Path("data") / "images" / "val")
    with pytest.raises(ValueError):
        DataConfig.from_dict({"val": ["a", "b"]})


def test_check_dataset_from_a_dict_and_increment_path(tmp_path):
    cfg = check_dataset({"path": str(tmp_path), "val": "images/val", "nc": 2,
                         "names": {0: "a", 1: "b"}})
    assert cfg.val == str(tmp_path / "images" / "val") and cfg.names == ["a", "b"]
    assert check_dataset(cfg) is cfg
    assert check_dataset({"val": "/abs/val", "nc": 3}).names == ["0", "1", "2"]
    run = increment_path(tmp_path / "exp", mkdir=True)
    assert run == tmp_path / "exp" and increment_path(tmp_path / "exp") == tmp_path / "exp2"


def test_pinned_ring_holds_size_buffers_whatever_the_batch_shapes():
    """Rect batches come in many shapes; the ring keeps ``size`` buffers, each
    grown to the largest batch, and hands out views of each array's shape."""
    rng = np.random.RandomState(0)
    ring = _PinnedRing(3)
    largest = 0
    for i, (h, w) in enumerate([(8, 12), (12, 12), (4, 12), (12, 8), (8, 8)] * 2):
        arrays = [rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8),
                  rng.rand(2, 5, 6).astype(np.float32), rng.rand(2, 5) > 0.5,
                  np.arange(i, dtype=np.int64)]
        largest = max(largest, sum(-(-a.nbytes // 64) * 64 for a in arrays))
        views, _ = ring.take(arrays)
        for arr, view in zip(arrays, views):
            np.testing.assert_array_equal(view.numpy(), arr)
        assert len(ring.slots) == min(i + 1, 3)
    assert ring.largest == largest
    assert all(slot[0].numel() <= largest for slot in ring.slots)
