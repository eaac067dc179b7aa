"""The port's device augmentation against the JAX package's, on JAX's draws.

JAX draws from ``jax.random`` keys, which torch cannot reproduce: each test
recomputes JAX's draws with JAX's own key splits, hands them to the port's
``apply_*`` function, and holds the result against JAX's function on the same
key: images within 1e-5, labels within 1e-5, masks equal. Where the affine
samples, images within 3e-5: two ulps of a canvas coordinate (up to 2s = 128
px, ulp 7.6e-6) times the noise frames' largest step between neighbours (1 a
pixel); the port computes the inverse matrix and the coordinates in another
order than XLA (1.03e-5 measured). Also: the whole pipeline's shapes, and zero
gains giving the identity. Images are numpy from seeds, float32 in [0, 1],
64 px.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyeye_tpu.config import DEFAULT_HYP
from skyeye_tpu.data import device_aug as jaug
from skyeye_tpu_torch.data import device_aug as taug

B, S, M = 4, 64, 6
TOL = 1e-5
SAMPLED_TOL = 2 * 2.0 ** -23 * (2 * S)  # two ulps of a canvas coordinate, 1 a pixel

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    t = np.zeros((B, M, 6), np.float32)
    t[..., 1] = rng.integers(0, 5, (B, M))
    t[..., 2:4] = rng.uniform(0.2, 0.8, (B, M, 2))
    t[..., 4:6] = rng.uniform(0.05, 0.4, (B, M, 2))
    mask = rng.uniform(size=(B, M)) < 0.7
    return images, t, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _mosaic_draws(key, hyp, mosaic_p):
    """JAX's mosaic_affine_batch draws, split as it splits its key."""
    hyp = {**DEFAULT_HYP, **hyp}
    kg, key = jax.random.split(key)
    gate = jax.random.uniform(kg, (B,)) < mosaic_p
    rows = []
    for k in jax.random.split(key, B):
        kc, km = jax.random.split(k)
        cyx = jax.random.uniform(kc, (2,), minval=0.5 * S, maxval=1.5 * S)
        k1, k2, k3, k4, k5 = jax.random.split(km, 5)
        u = lambda kk, lo, hi: jax.random.uniform(kk, (), minval=lo, maxval=hi)  # noqa: E731
        rows.append([cyx, u(k1, -hyp["degrees"], hyp["degrees"]),
                     u(k2, 1 - hyp["scale"], 1 + hyp["scale"]),
                     u(k3, -hyp["shear"], hyp["shear"]), u(k4, -hyp["shear"], hyp["shear"]),
                     u(k5, 0.5 - hyp["translate"], 0.5 + hyp["translate"]),
                     u(jax.random.fold_in(k5, 1), 0.5 - hyp["translate"],
                       0.5 + hyp["translate"])])
    col = lambda i: _t(np.stack([np.asarray(r[i]) for r in rows]))  # noqa: E731
    return {"gate": _t(gate), "center": col(0), "angle": col(1), "scale": col(2),
            "shear_x": col(3), "shear_y": col(4), "translate_x": col(5), "translate_y": col(6)}


def _hsv_draws(key):
    return _t(jax.random.uniform(key, (B, 3), minval=-1.0, maxval=1.0))


def _flip_draws(key, p_lr, p_ud):
    k1, k2 = jax.random.split(key)
    return {"lr": _t(jax.random.uniform(k1, (B,)) < p_lr),
            "ud": _t(jax.random.uniform(k2, (B,)) < p_ud)}


def _mixup_draws(key, p):
    k1, k2 = jax.random.split(key)
    return {"lam": _t(jax.random.beta(k1, 8.0, 8.0, (B,))),
            "do": _t(jax.random.uniform(k2, (B,)) < p)}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol, float(np.abs(got - want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv_apply_matches_jax(seed):
    images = _inputs(seed)[0]
    key = jax.random.PRNGKey(seed)
    want = jaug.hsv_jitter_batch(jnp.asarray(images), key, 0.015, 0.7, 0.4)
    got = taug.apply_hsv(_t(images), _hsv_draws(key), 0.015, 0.7, 0.4)
    _close(got, want)


def test_rgb_hsv_round_trip_matches_jax():
    images = _inputs(2)[0]
    _close(taug.rgb_to_hsv(_t(images)), jaug.rgb_to_hsv(jnp.asarray(images)))
    hsv = np.asarray(jaug.rgb_to_hsv(jnp.asarray(images)))
    _close(taug.hsv_to_rgb(_t(hsv)), jaug.hsv_to_rgb(jnp.asarray(hsv)))


@pytest.mark.parametrize("p_lr,p_ud", [(0.5, 0.5), (1.0, 0.0)])
def test_flip_apply_matches_jax(p_lr, p_ud):
    images, t, _ = _inputs(3)
    key = jax.random.PRNGKey(7)
    wi, wt = jaug.flip_batch(jnp.asarray(images), jnp.asarray(t), key, p_lr, p_ud)
    gi, gt = taug.apply_flip(_t(images), _t(t), _flip_draws(key, p_lr, p_ud))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


MOSAIC_CASES = {
    "mosaic_default_hyp": ({}, 1.0),
    "single_image_affine": ({}, 0.0),
    "mixed_gates_rotate_shear": (dict(degrees=10.0, shear=3.0, scale=0.3), 0.5),
    "no_warp": (dict(translate=0.0, scale=0.0), 1.0),
}


@pytest.mark.parametrize("case", list(MOSAIC_CASES))
def test_mosaic_affine_apply_matches_jax(case):
    hyp, p = MOSAIC_CASES[case]
    images, t, mask = _inputs(4)
    key = jax.random.PRNGKey(11)
    wi, wt, wm = jaug.mosaic_affine_batch(jnp.asarray(images), jnp.asarray(t),
                                          jnp.asarray(mask), key, {**DEFAULT_HYP, **hyp},
                                          mosaic_p=p)
    gi, gt, gm = taug.apply_mosaic_affine(_t(images), _t(t), _t(mask),
                                          _mosaic_draws(key, hyp, p))
    _close(gi, wi, SAMPLED_TOL)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    _close(gt.numpy()[gm.numpy()], np.asarray(wt)[np.asarray(wm)])
    assert gm.any()


def test_mixup_apply_matches_jax():
    images, t, mask = _inputs(5)
    key = jax.random.PRNGKey(13)
    wi, wt, wm = jaug.mixup_batch(jnp.asarray(images), jnp.asarray(t), jnp.asarray(mask),
                                  key, p=0.7)
    gi, gt, gm = taug.apply_mixup(_t(images), _t(t), _t(mask), _mixup_draws(key, 0.7))
    _close(gi, wi)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


@pytest.mark.parametrize("mixup", [0.0, 0.5])
def test_whole_pipeline_matches_jax_on_its_draws(mixup):
    hyp = {**DEFAULT_HYP, "mixup": mixup}
    images, t, mask = _inputs(6)
    key = jax.random.PRNGKey(17)
    wi, wt, wm = jaug.augment_batch_device(jnp.asarray(images), jnp.asarray(t),
                                           jnp.asarray(mask), key, hyp)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"mosaic_affine": _mosaic_draws(k1, hyp, hyp["mosaic"]), "hsv": _hsv_draws(k2),
             "flip": _flip_draws(k3, hyp["fliplr"], hyp["flipud"])}
    if mixup:
        draws["mixup"] = _mixup_draws(k4, mixup)
    gi, gt, gm = taug.apply_augmentation(_t(images), _t(t), _t(mask), draws, hyp)
    _close(gi, wi, SAMPLED_TOL)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    _close(gt.numpy()[gm.numpy()], np.asarray(wt)[np.asarray(wm)])


@pytest.mark.parametrize("mixup", [0.0, 0.5])
def test_pipeline_shapes_from_a_generator(mixup):
    images, t, mask = _inputs(7)
    hyp = {**DEFAULT_HYP, "mixup": mixup}
    gi, gt, gm = taug.augment_batch_device(_t(images), _t(t), _t(mask),
                                           torch.Generator().manual_seed(0), hyp)
    m_out = 4 * M * (2 if mixup else 1)
    assert gi.shape == (B, S, S, 3) and gt.shape == (B, m_out, 6) and gm.shape == (B, m_out)
    assert gi.dtype == torch.float32 and bool(torch.isfinite(gi).all())
    assert float(gi.min()) >= 0.0 and float(gi.max()) <= 1.0
    again = taug.augment_batch_device(_t(images), _t(t), _t(mask),
                                      torch.Generator().manual_seed(0), hyp)
    assert torch.equal(again[0], gi) and torch.equal(again[2], gm)


def test_zero_gains_give_the_identity():
    """No mosaic, no warp, no HSV gain, no flip: the images (up to the HSV round
    trip's rounding) and the labels come back; the other slots are masked."""
    hyp = {**DEFAULT_HYP, **{k: 0.0 for k in ("hsv_h", "hsv_s", "hsv_v", "degrees",
                                                "translate", "scale", "shear", "fliplr",
                                                "flipud", "mosaic", "mixup")}}
    images, t, mask = _inputs(8)
    t[..., 4:6] = 0.2  # boxes well inside the frame: the candidate filter keeps them
    gi, gt, gm = taug.augment_batch_device(_t(images), _t(t), _t(mask),
                                           torch.Generator().manual_seed(1), hyp)
    np.testing.assert_allclose(gi.numpy(), images, atol=1e-6)
    np.testing.assert_array_equal(gm.numpy()[:, :M], mask)
    assert not gm[:, M:].any()
    np.testing.assert_allclose(gt.numpy()[:, :M][mask][:, 1:], t[mask][:, 1:], atol=1e-5)
