"""The enhanced variant of the PyTorch port against the JAX package.

``CrossLayerAttention`` (both the local-region mode and ``ref_exact``), its
bilinear resize and the whole enhanced detector, on flax variables randomised
from a seed and carried across by ``from_jax_variables``, on numpy inputs from
a seed, in float32 on the CPU. Tolerance: atol 1e-4 on attention outputs and
logits, as the other model tests (float32 sums in another order); the resize
alone 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import attention as jatt
from skyeye_tpu.models import detector as jdet
from skyeye_tpu_torch import SkyEyeDetector
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

ATOL = 1e-4


def _randomised(shapes, seed):
    """Seeded numpy values for every flax leaf of these shapes; variances > 0."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, v in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "var":
            out[path] = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            out[path] = rng.uniform(0.8, 1.2, v.shape)
        elif leaf == "kernel":
            out[path] = rng.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            out[path] = rng.normal(0, 0.1, v.shape)
    return {k: v.astype(np.float32) for k, v in out.items()}


def _to_jax(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((4, 5), (8, 10)),      # the served 2x upsample, non-square
    ((3, 5), (7, 9)),       # odd grids, a scale that is not whole
    ((5, 3), (9, 11)),
    ((7, 9), (4, 5)),       # shrinking: JAX's antialiasing
    ((7, 3), (4, 9)),       # one axis shrinks, the other grows
    ((6, 6), (6, 6)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_resize_matches_jax_image_resize(in_hw, out_hw, dtype):
    x = np.random.RandomState(1).normal(0, 1, (2, *in_hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x, dtype), (2, *out_hw, 3), "bilinear")
    got = tatt.bilinear_resize(_nchw(x).to(getattr(torch, dtype)), *out_hw)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy().transpose(0, 2, 3, 1)
    # bf16: JAX rounds the weights and sums in bf16, PyTorch rounds once
    atol = 1e-5 if dtype == "float32" else 0.02 * np.abs(x).max()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("ref_exact", [False, True])
@pytest.mark.parametrize("q_shape,k_shape,heads", [
    ((2, 8, 8, 16), (2, 4, 4, 32), 4),    # the detector's pairing: hq 4 < hk 8
    ((2, 7, 9, 16), (2, 4, 5, 32), 4),    # odd, non-square grids
    ((1, 5, 6, 24), (1, 5, 6, 24), 4),    # same grid, no resize
    ((1, 6, 4, 32), (1, 9, 7, 16), 2),    # key finer than the query, hq > hk
])
def test_cross_layer_attention_matches_flax(ref_exact, q_shape, k_shape, heads):
    jm = jatt.CrossLayerAttention(query_channels=q_shape[-1], key_channels=k_shape[-1],
                                  region_size=2, heads=heads, ref_exact=ref_exact)
    rng = np.random.RandomState(2)
    q = rng.normal(0, 1, q_shape).astype(np.float32)
    k = rng.normal(0, 1, k_shape).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(k))
    flat = _randomised(shapes, 3)
    ref = np.asarray(jm.apply(_to_jax(flat), jnp.asarray(q), jnp.asarray(k)))
    tm = tatt.CrossLayerAttention(q_shape[-1], k_shape[-1], region_size=2, heads=heads,
                                  ref_exact=ref_exact)
    tm.load_state_dict(from_jax_variables(flat), strict=True)
    with torch.no_grad():
        got = tm.eval()(_nchw(q), _nchw(k)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("r", [1, 3])
def test_region_sizes_other_than_two_match_flax(r):
    """The shift offsets from -(r - 1) // 2, in JAX's order, at r 1 and 3."""
    jm = jatt.CrossLayerAttention(query_channels=8, key_channels=8, region_size=r, heads=2)
    rng = np.random.RandomState(4)
    q = rng.normal(0, 1, (1, 6, 5, 8)).astype(np.float32)
    k = rng.normal(0, 1, (1, 3, 3, 8)).astype(np.float32)
    flat = _randomised(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(q),
                                      jnp.asarray(k)), 5)
    ref = np.asarray(jm.apply(_to_jax(flat), jnp.asarray(q), jnp.asarray(k)))
    tm = tatt.CrossLayerAttention(8, 8, region_size=r, heads=2)
    tm.load_state_dict(from_jax_variables(flat), strict=True)
    with torch.no_grad():
        got = tm.eval()(_nchw(q), _nchw(k)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ref_exact", [False, True])
def test_enhanced_detector_logits_match_jax(ref_exact):
    """skyeye_l_enhanced's geometry (width 1, depth 1) at base 16, 64 x 96 px."""
    cfg = {"nc": 5, "base_channels": 16, "depth_multiple": 1.0, "width_multiple": 1.0,
           "variant": "l", "enhanced": True, "ref_exact_cross_attn": ref_exact}
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg))
    flat = _randomised(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3))), 8)
    assert "params/cross_attn_p5_p4/q_proj/kernel" in flat
    tmod = tdet.create_detector(cfg, device="cpu")
    assert tmod.cross_attn_p4_p3.ref_exact is ref_exact
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    x = np.random.RandomState(9).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    ref = jax.jit(jmod.apply)(_to_jax(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)


def test_ref_exact_comes_from_the_config():
    cfg = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.25,
           "enhanced": True}
    assert not tdet.create_detector(cfg, device="cpu").cross_attn_p5_p4.ref_exact
    m = tdet.create_detector({**cfg, "ref_exact_cross_attn": True}, device="cpu")
    assert m.config.ref_exact_cross_attn and m.cross_attn_p5_p4.ref_exact
    # ref_exact projects q to key_channels
    assert m.cross_attn_p5_p4.q_proj.weight.shape[0] == m.cross_attn_p5_p4.key_channels


def test_enhanced_config_builds_through_the_facade():
    """The shipped name at full width: cross-attention P5 -> P4 (c4 512, c5 1024)
    and P4 -> P3 (c3 256, c4 512), 4 heads, seeded with init_weights' scales."""
    det = SkyEyeDetector("skyeye_l_enhanced", device="cpu")
    m = det.model
    assert m.config.enhanced and not m.config.transformer_heads
    a54, a43 = m.cross_attn_p5_p4, m.cross_attn_p4_p3
    assert (a54.query_channels, a54.key_channels, a54.heads) == (512, 1024, 4)
    assert (a43.query_channels, a43.key_channels, a43.region_size) == (256, 512, 2)
    w = a54.k_proj.weight.detach()
    assert abs(float(w.std()) - 1024 ** -0.5) < 0.1 * 1024 ** -0.5  # N(0, 1 / fan_in)
    assert float(a54.k_proj.bias.detach().abs().max()) == 0.0
