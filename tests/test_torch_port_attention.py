"""The transformer path of the PyTorch port against the JAX package (K4's slice).

Inputs are numpy from a seed; flax variables are randomised from a seed and
carried across by ``from_jax_variables``. On the CPU the port's attention wrapper
runs its kernel's plain version; the JAX side runs the Pallas kernel in interpret
mode (``padded_flash_attention(interpret=True)``, and ``SKYEYE_FLASH_INTERPRET=1``
for the flax modules, as ``tests/test_pallas_kernels.py`` does).

Tolerances: attention outputs rtol 2e-4, atol 2e-5 (those of the Pallas kernel's
own tests; float32 sums in another order); the large-logit case rtol 1e-3,
atol 1e-4 (its JAX test's); layers and logits atol 1e-4, decoded boxes 1e-3 px.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import attention as jatt
from skyeye_tpu.models import detector as jdet
from skyeye_tpu.models import head as jhead
from skyeye_tpu.ops.pallas.attention_kernel import (
    attention_reference as jax_attention_reference,
    padded_flash_attention,
)
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.models import head as thead
from skyeye_tpu_torch.ops import attention_kernel as tak
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

ATOL = 1e-4


def _qkv(seed, shape, sigma=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.normal(0, sigma if i < 2 else 1.0, shape)).astype(np.float32) for i in range(3)]


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


def _pair(jmod, tmod, x, seed):
    flat = _randomised(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    return _to_jax(flat), tmod.eval()


@pytest.mark.parametrize("n,hd", [(256, 64), (400, 96), (300, 32)])
def test_plain_versions_match_jax_padded_flash(n, hd):
    q, k, v = _qkv(n + hd, (2, n, hd))
    ref = np.asarray(padded_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (tak.flash_attention, tak.flash_attention_plain, tak.attention_reference):
        got = fn(tq, tk, tv).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=fn.__name__)
    jref = np.asarray(jax_attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(tak.attention_reference(tq, tk, tv).numpy(), jref,
                               rtol=2e-4, atol=2e-5)


def test_plain_versions_stable_on_large_logits():
    q, k, v = _qkv(2, (1, 128, 64), sigma=30.0)
    ref = np.asarray(padded_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            interpret=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (tak.flash_attention_plain, tak.attention_reference):
        got = fn(tq, tk, tv).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4, err_msg=fn.__name__)


def test_flash_plain_masks_the_key_tail_at_every_tile_edge():
    """N = 1, one key past a tile, one short of one: the tail tile's missing keys
    change nothing."""
    for n in (1, tak.BLOCK_K - 1, tak.BLOCK_K + 1):
        q, k, v = (torch.from_numpy(a) for a in _qkv(n, (3, n, 8)))
        torch.testing.assert_close(tak.flash_attention_plain(q, k, v),
                                   tak.attention_reference(q, k, v), rtol=2e-4, atol=2e-5)


def test_wrapper_checks_its_inputs():
    q = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="one \\(B, N, hd\\) shape"):
        tak.flash_attention(q, q[:, :4], q)
    with pytest.raises(TypeError, match="float32"):
        tak.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        tak.flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))


@pytest.mark.parametrize("n", [256, 64])
def test_mhsa_and_transformer_layer_match_flax(n, monkeypatch):
    """At N = 256 both sides take the fused path (the port's wrapper, JAX's Pallas
    kernel interpreted); at N = 64 both take the einsum path."""
    monkeypatch.setenv("SKYEYE_FLASH_INTERPRET", "1")
    calls = []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = np.random.RandomState(n).normal(0, 1, (2, n, 64)).astype(np.float32)
    side = int(n ** 0.5)
    grid = x.reshape(2, side, side, 64)  # the flax layer takes (B, H, W, C), row-major tokens
    for jmod, tmod, jx in ((jatt.MultiHeadSelfAttention(num_heads=4),
                            tatt.MultiHeadSelfAttention(64, 4), x),
                           (jatt.TransformerLayer(num_heads=4), tatt.TransformerLayer(64, 4),
                            grid)):
        variables, tmod = _pair(jmod, tmod, jx, seed=n + 1)
        ref = np.asarray(jmod.apply(variables, jnp.asarray(jx))).reshape(x.shape)
        with torch.no_grad():
            got = tmod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # the gate: heads go through the wrapper as (B * heads, N, hd), only from 256 tokens
    assert calls == ([(8, n, 16)] * 2 if n >= tatt.FLASH_MIN_TOKENS else [])


def test_mask_or_bias_takes_the_einsum_path(monkeypatch):
    monkeypatch.setattr(tatt, "flash_attention", lambda *a: pytest.fail("kernel on a mask"))
    m = tatt.MultiHeadSelfAttention(32, 2).eval()
    x = torch.randn(1, 256, 32)
    with torch.no_grad():
        m(x, mask=torch.zeros(1, 2, 256, 256))
        m(x, bias=torch.zeros(1, 2, 256, 256))


def test_transformer_detector_logits_and_decode_match_jax(monkeypatch):
    """skyeye_l_transformer's geometry at base 16 and 512 px: P5 is 16 x 16 = 256
    tokens, C = 256, 4 heads of 64, so both sides run the fused attention."""
    monkeypatch.setenv("SKYEYE_FLASH_INTERPRET", "1")
    cfg = {"nc": 7, "base_channels": 16, "depth_multiple": 1.0, "width_multiple": 1.0,
           "variant": "l", "transformer_heads": True}
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
    flat = _randomised(shapes, 12)
    assert any("head/transformer2/attn/qkv/kernel" in k for k in flat)
    tmod = tdet.create_detector(cfg, device="cpu")
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    x = np.random.RandomState(13).uniform(0, 1, (1, 512, 512, 3)).astype(np.float32)
    ref = jax.jit(jmod.apply)(_to_jax(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)
    ref_dec = jhead.decode_predictions(ref, jnp.asarray(tmod.config.anchors), (512, 512),
                                       anchor_major=False)
    got_dec = thead.decode_predictions(got, tmod.config.anchors, (512, 512), anchor_major=False)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(ref_dec), rtol=0, atol=1e-3)


def test_transformer_config_builds_through_the_entry_point():
    """The shipped config name reaches the transformer head (built at base 16 here;
    the full width runs on the card, in chip_smoke.py)."""
    config = tdet.load_model_config("skyeye_l_transformer")
    assert config.transformer_heads and not config.enhanced
    m = tdet.create_detector(dataclasses.replace(config, base_channels=16), device="cpu")
    layer = m.head.transformer2
    assert layer.norm1.eps == 1e-6 and layer.norm2.eps == 1e-6 and layer.attn.num_heads == 4
    assert layer.attn.qkv.weight.shape == (3 * 256, 256)
    assert layer.ff1.weight.shape == (4 * 256, 256)
    assert not hasattr(m.head, "transformer0") and not hasattr(m.head, "transformer1")
