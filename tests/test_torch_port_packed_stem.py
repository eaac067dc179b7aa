"""The packed (space-to-depth) stem of the PyTorch port against the JAX package.

``s2d4_host``/``s2d4_device``, the kernel remaps and ``pack_stem_variables`` /
``fold_input_scale`` must equal JAX's exactly (they move or scale the same
float32 values). The packed-stem detector against the canonical one on the
same weights is an exact remap computed by other convolutions: 1e-4 relative
and 2e-5 absolute, ``tests/test_packed_stem.py``'s bound; against JAX's
packed-stem detector on the same weights, the same bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.config import ModelConfig as JaxConfig
from skyeye_tpu.models import SkyEyeDetectorModule as JaxModule
from skyeye_tpu.ops import packed_stem as jps
from skyeye_tpu.utils.checkpoint import fuse_conv_bn as jax_fuse_conv_bn
from skyeye_tpu_torch.config import ModelConfig
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.ops import packed_stem as tps
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables, fuse_conv_bn

CFG = {"nc": 5, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5}
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def variables():
    """Seeded flax variables with every BN leaf randomised (so the 4x tiling of
    the stem's BN leaves is exercised)."""
    module = JaxModule(config=JaxConfig(**CFG))
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.RandomState(42)
    flat = {}
    for path, s in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-2]) / s.shape[-1]), s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.6, 1.4, s.shape)
        else:
            v = rng.normal(0, 0.1, s.shape)
        flat[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _port(tree, **kw):
    m = SkyEyeDetectorModule(ModelConfig(**CFG), **kw).eval()
    m.load_state_dict(from_jax_variables(_flat(tree)), strict=True)
    return m


def _run(model, x_nhwc):
    with torch.no_grad():
        return [o.numpy() for o in model(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_s2d4_host_and_device_equal_jax(dtype):
    x = np.random.default_rng(0).integers(0, 255, (2, 32, 48, 3)).astype(dtype)
    want = np.asarray(jps.s2d4_device(jnp.asarray(x)))
    np.testing.assert_array_equal(jps.s2d4_host(x), want)
    got = tps.s2d4_host(x)
    assert got.shape == (2, 8, 12, 48) and got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tps.s2d4_device(torch.from_numpy(x)).numpy(), want)


def test_kernel_remaps_equal_jax():
    rng = np.random.default_rng(1)
    kf = rng.normal(size=(6, 6, 3, 8)).astype(np.float32)
    kd = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    np.testing.assert_array_equal(tps.pack_stem_kernel(kf), jps.pack_stem_kernel(kf))
    np.testing.assert_array_equal(tps.pack_down1_kernel(kd), jps.pack_down1_kernel(kd))
    with pytest.raises(ValueError):
        tps.pack_stem_kernel(kd)


@pytest.mark.parametrize("folded", [False, True])
def test_pack_stem_variables_equal_jax(variables, folded):
    tree = jax_fuse_conv_bn(variables) if folded else variables
    want = from_jax_variables(_flat(jps.pack_stem_variables(tree)))
    got = tps.pack_stem_variables(from_jax_variables(_flat(tree)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
    with pytest.raises(NotImplementedError, match="item 9"):
        tps.pack_stem_variables(from_jax_variables(_flat(tree)), down1_p2p=True)


def test_fold_input_scale_equals_jax(variables):
    want = from_jax_variables(_flat(jps.fold_input_scale(jps.pack_stem_variables(variables))))
    got = tps.fold_input_scale(tps.pack_stem_variables(from_jax_variables(_flat(variables))))
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)


def test_packed_stem_model_equals_canonical_and_jax(variables):
    img = np.random.default_rng(1).integers(0, 255, (2, SIZE, SIZE, 3)).astype(np.uint8)
    x = img.astype(np.float32) / 255.0
    canonical = _port(variables)
    packed = SkyEyeDetectorModule(ModelConfig(**CFG), packed_stem=True).eval()
    packed.load_state_dict(tps.pack_stem_variables(canonical.state_dict()), strict=True)
    ref = _run(canonical, x)
    got_host = _run(packed, tps.s2d4_host(x))  # packed on the host
    got_device = _run(packed, x)  # a raw frame, packed on the device
    jax_packed = JaxModule(config=JaxConfig(**CFG), packed_stem=True)
    want = jax.jit(lambda v, a: jax_packed.apply(v, a, train=False))(
        jps.pack_stem_variables(variables), jps.s2d4_host(x))
    for r, gh, gd, w in zip(ref, got_host, got_device, want):
        np.testing.assert_allclose(gh, r, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(gd, r, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(gh, np.asarray(w), rtol=1e-4, atol=2e-5)


def test_packed_stem_after_bn_fold_and_input_scale_equals_canonical(variables):
    """Serving order: fuse_conv_bn, pack_stem_variables, then fold_input_scale
    and frames in 0..255 (``test_packed_stem.py``'s serving case)."""
    img = np.random.default_rng(2).integers(0, 255, (1, SIZE, SIZE, 3)).astype(np.float32)
    canonical = _port(variables)
    folded = fuse_conv_bn(canonical.state_dict())
    canonical.load_state_dict(folded, strict=True)
    packed = SkyEyeDetectorModule(ModelConfig(**CFG), packed_stem=True).eval()
    packed.load_state_dict(tps.fold_input_scale(tps.pack_stem_variables(folded)), strict=True)
    for r, g in zip(_run(canonical, img / 255.0), _run(packed, img)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=2e-5)


def test_int8_modes_need_the_packed_stem():
    for flag in ("int8_early", "int8_stem"):
        with pytest.raises(ValueError, match="packed-stem"):
            SkyEyeDetectorModule(ModelConfig(**CFG), **{flag: True})
