"""The port's host augmentation against JAX's, which runs it through OpenCV.

``skyeye_tpu_torch.data.augment`` reproduces OpenCV 5.0.0's arithmetic in
numpy (HSV conversions, ``LUT``, ``warpAffine``/``warpPerspective`` with
INTER_LINEAR and a constant border, ``getRotationMatrix2D``). Here it is held
against cv2 itself and against ``skyeye_tpu.data.augment`` on the same inputs
and the same seeds, at tolerance 0: pixels, boxes and draws. Then the
augmented dataset items (mosaic, mixup, warp, HSV, flips) and the batch
loader against JAX's with one worker, and the port's loader against itself at
several worker counts, and ``cli.train`` with JAX's defaults (host
augmentation) against JAX's.
"""
import random

import cv2
import numpy as np
import pytest
import torch

import skyeye_tpu.data.augment as jax_augment
import skyeye_tpu.data.dataset as jax_dataset
from skyeye_tpu_torch.data import augment, dataset

from test_torch_port_dataset import write_dataset


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def data_root(tmp_path):
    write_dataset(tmp_path)
    return tmp_path


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _targets(rng, n, w, h):
    xy = np.sort(rng.uniform(0, [w, h, w, h], (n, 4)).reshape(n, 2, 2), axis=1).reshape(n, 4)
    return np.concatenate([rng.integers(0, 5, (n, 1)), xy], 1).astype(np.float32)


# -- OpenCV's arithmetic ----------------------------------------------------------------


def test_bgr_to_hsv_equals_cv2_on_every_colour():
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij")
    img = np.stack([b, g, r], -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(augment._bgr_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_equals_cv2_on_every_hsv_triple():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(180 * 256, 256, 3)
    np.testing.assert_array_equal(augment._hsv_to_bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def test_hsv_conversions_equal_cv2_in_a_rows_scalar_tail():
    """OpenCV converts 32 pixels a vector step and the rest of a row in scalar
    code, which rounds where the vector code truncates: every width from 1 to 70."""
    rng = np.random.default_rng(0)
    for w in range(1, 71):
        img = _image(rng, 5, w)
        hsv = img.copy()
        hsv[..., 0] %= 180
        np.testing.assert_array_equal(augment._bgr_to_hsv(img),
                                      cv2.cvtColor(img, cv2.COLOR_BGR2HSV), err_msg=str(w))
        np.testing.assert_array_equal(augment._hsv_to_bgr(hsv),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR), err_msg=str(w))


@pytest.mark.parametrize("angle,scale", [(0.0, 1.0), (13.7, 0.61), (-44.9, 1.45), (90.0, 1.0),
                                         (1e-3, 0.5)])
def test_rotation_matrix_equals_cv2(angle, scale):
    np.testing.assert_array_equal(augment._rotation_matrix(angle, scale),
                                  cv2.getRotationMatrix2D(angle=angle, center=(0, 0),
                                                          scale=scale))


def test_fma32_rounds_once():
    """Against the exact value in rationals: float32 a * b + c rounded once."""
    from fractions import Fraction

    rng = np.random.default_rng(1)
    a = (rng.standard_normal(400) * 10.0 ** rng.integers(-12, 4, 400)).astype(np.float32)
    b = (rng.standard_normal(400) * 300).astype(np.float32)
    c = (rng.standard_normal(400) * 10.0 ** rng.integers(-12, 4, 400)).astype(np.float32)
    got = augment._fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.int32)) & 1))
        assert g == best, (x, y, z)


@pytest.mark.parametrize("size", [(64, 80), (97, 153), (200, 131), (33, 17)])
@pytest.mark.parametrize("kind", ["affine", "perspective"])
def test_warps_equal_cv2(size, kind):
    """Rotated, sheared and scaled maps, with the output wider than a vector
    step and a scalar tail in every row (widths not a multiple of 16)."""
    rng = np.random.default_rng(size[0] * 7 + size[1])
    h, w = size
    img = _image(rng, h, w)
    for trial in range(4):
        r = random.Random(trial)
        M, _ = augment.build_affine_matrix(
            w, h, degrees=30.0, translate=0.2, scale=0.5, shear=8.0,
            perspective=0.0008 if kind == "perspective" else 0.0, rng=r)
        if kind == "perspective":
            got = augment._warp_perspective(img, M, (w + 3, h))
            want = cv2.warpPerspective(img, M, dsize=(w + 3, h), borderValue=(114, 114, 114))
        else:
            got = augment._warp_affine(img, M[:2], (w + 3, h))
            want = cv2.warpAffine(img, M[:2], dsize=(w + 3, h), borderValue=(114, 114, 114))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


# -- the augmentations against JAX's ------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("gains", [(0.015, 0.7, 0.4), (0.5, 0.9, 0.9), (0.0, 0.0, 0.0),
                                   (0.1, 0.0, 0.0)])
def test_augment_hsv_matches_jax(seed, gains):
    rng = np.random.default_rng(seed)
    img = _image(rng, 48 + seed, 75 + 13 * seed)
    r1, r2 = random.Random(seed), random.Random(seed)
    got = augment.augment_hsv(img, *gains, rng=r1)
    want = jax_augment.augment_hsv(img, *gains, rng=r2)
    np.testing.assert_array_equal(got, want)
    assert r1.random() == r2.random()  # the same number of draws


WARP_CASES = {
    "affine": dict(degrees=0.0, translate=0.1, scale=0.5, shear=0.0),
    "rotate_shear": dict(degrees=20.0, translate=0.2, scale=0.6, shear=6.0),
    "perspective": dict(degrees=5.0, translate=0.1, scale=0.3, shear=2.0, perspective=0.0006),
    "identity": dict(degrees=0.0, translate=0.0, scale=0.0, shear=0.0),
    "mosaic_border": dict(degrees=3.0, translate=0.1, scale=0.5, shear=0.0, border=True),
}


@pytest.mark.parametrize("case", sorted(WARP_CASES))
@pytest.mark.parametrize("seed", range(3))
def test_random_perspective_matches_jax(case, seed):
    kw = dict(WARP_CASES[case])
    rng = np.random.default_rng(100 + seed)
    if kw.pop("border", False):
        s = 96 + 16 * seed
        h = w = 2 * s
        kw["border"] = (-s // 2, -s // 2)
    else:
        h, w = 90 + 7 * seed, 131 + 5 * seed
    img = _image(rng, h, w)
    targets = _targets(rng, 12, w, h)
    got = augment.random_perspective(img, targets.copy(), rng=random.Random(seed), **kw)
    want = jax_augment.random_perspective(img, targets.copy(), rng=random.Random(seed), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype
    if case == "identity":
        assert got[0] is img


@pytest.mark.parametrize("seed", range(3))
def test_flips_cutout_and_mixup_match_jax(seed):
    rng = np.random.default_rng(seed)
    img, img2 = _image(rng, 60, 88), _image(rng, 60, 88)
    labels = np.concatenate([rng.integers(0, 3, (7, 1)), rng.uniform(0.1, 0.9, (7, 2)),
                             rng.uniform(0.05, 0.4, (7, 2))], 1).astype(np.float32)
    for ours, theirs in ((augment.flip_lr, jax_augment.flip_lr),
                         (augment.flip_ud, jax_augment.flip_ud)):
        for a, b in zip(ours(img, labels), theirs(img, labels)):
            np.testing.assert_array_equal(a, b)
    for p in (0.0, 1.0):
        got = augment.cutout(img, labels, p=p, rng=random.Random(seed))
        want = jax_augment.cutout(img, labels, p=p, rng=random.Random(seed))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = augment.mixup(img, labels, img2, labels[:3], np.random.default_rng(seed))
    want = jax_augment.mixup(img, labels, img2, labels[:3], np.random.default_rng(seed))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hyp", [None, dict(degrees=15.0, shear=4.0, flipud=0.5, hsv_h=0.1)])
def test_aerial_augmentor_matches_jax(hyp):
    rng = np.random.default_rng(5)
    ours, theirs = augment.AerialAugmentor(hyp, seed=9), jax_augment.AerialAugmentor(hyp, seed=9)
    assert augment.AerialAugmentation is augment.AerialAugmentor
    for _ in range(4):
        img = _image(rng, 72, 96)
        labels = np.concatenate([rng.integers(0, 3, (5, 1)), rng.uniform(0.2, 0.8, (5, 2)),
                                 rng.uniform(0.1, 0.3, (5, 2))], 1).astype(np.float32)
        for a, b in zip(ours(img, labels), theirs(img, labels)):
            np.testing.assert_array_equal(a, b)


def test_albumentations_wrapper_is_the_identity_as_jax_without_the_package():
    img = np.zeros((8, 8, 3), np.uint8)
    labels = np.ones((2, 5), np.float32)
    assert jax_augment.AlbumentationsWrapper().transform is None  # not installed
    got = augment.AlbumentationsWrapper()(img, labels)
    assert got[0] is img and got[1] is labels


# -- the augmented dataset and loader ---------------------------------------------------------

HYPS = {
    "default": {},
    "mixup": dict(mixup=0.5, degrees=10.0, shear=3.0, flipud=0.5),
    "perspective": dict(mixup=0.3, perspective=0.0005, scale=0.3),
    "no_mosaic": dict(mosaic=0.0, degrees=5.0),
}


@pytest.mark.parametrize("name", sorted(HYPS))
@pytest.mark.parametrize("seed", [0, 3])
def test_augmented_items_match_jax(data_root, name, seed):
    split = data_root / "images" / "val"
    kw = dict(img_size=96, augment=True, hyp=HYPS[name], seed=seed, max_labels=16)
    ours = dataset.AerialDataset(split, **kw)
    theirs = jax_dataset.AerialDataset(split, **kw)
    assert not ours.rect and ours.mosaic == theirs.mosaic
    for i in (0, 5, 11, 2, 7, 7):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"item {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"item {i}")
        assert a[1].dtype == b[1].dtype
    assert ours.rng.random() == theirs.rng.random()
    assert ours.np_rng.random() == theirs.np_rng.random()


def test_loader_matches_jax_with_one_worker_and_itself_with_four(data_root):
    split = data_root / "images" / "val"
    kw = dict(img_size=96, augment=True, hyp=HYPS["mixup"], seed=1, max_labels=16)

    def batches(module, workers):
        ds = module.AerialDataset(split, **kw)
        loader = module.BatchLoader(ds, batch_size=5, shuffle=True, workers=workers, seed=1)
        return [b for _ in range(2) for b in loader]

    want = batches(jax_dataset, 1)
    for workers in (1, 4):
        got = batches(dataset, workers)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key}, {workers}")


# -- training with host augmentation --------------------------------------------------------


def test_train_with_jax_defaults_matches_jax(tmp_path):
    """``cli.train`` with JAX's defaults (``device_aug=False``: the loader runs
    mosaic, the warp, HSV and flips) over 2 epochs of one optimizer step each:
    ``results.csv`` at ``test_torch_port_train.py``'s tolerances. JAX's loader
    at one worker, the port's at three."""
    from test_torch_port_evolve import (
        assert_results_rows_match, jax_cli_settings, rows, write_trainset,
    )
    import skyeye_tpu.cli.train as jax_train
    from skyeye_tpu_torch.cli import train as port_train
    from test_torch_port_train import CFG, IMG

    data, weights, variables = write_trainset(tmp_path)
    kw = dict(cfg=CFG, data=data, epochs=2, batch_size=2, img_size=IMG, weights=weights,
              accumulate=2, seed=0)
    with jax_cli_settings(variables):
        _, jax_dir = jax_train.train(project=str(tmp_path / "jax"), workers=1, **kw)
    _, port_dir = port_train.train(project=str(tmp_path / "port"), workers=3, device="cpu",
                                   **kw)
    ph, prows = rows(port_dir / "results.csv")
    jh, jrows = rows(jax_dir / "results.csv")
    assert ph == jh and len(prows) == 2
    assert_results_rows_match(prows, jrows)
    assert "device_aug: false" in (port_dir / "opt.yaml").read_text()
