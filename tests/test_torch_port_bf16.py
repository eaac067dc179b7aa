"""bf16 compute in the PyTorch port against the JAX package's bf16 modules.

Each model family (skyeye_s's geometry, the enhanced variant in both
cross-attention modes, the transformer variant on its fused attention path)
and the fused-CSP mode run with ``dtype`` bfloat16 on both sides, on the same
seeded float32 weights and inputs. The two round at different points (flax
rounds each op's bf16 result where PyTorch sometimes rounds once), so the bound
is the one of the JAX fused-CSP test: per level, max |got - ref| <= 0.05 x
max |ref| + 1e-2. Parameters and the ``state_dict`` stay float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import detector as jdet
from skyeye_tpu.ops.fused_csp import fuse_csp_variables
from skyeye_tpu.utils.checkpoint import fuse_conv_bn as jax_fuse_conv_bn
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.ops.fused_csp import FusedCSPBlock
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

FAMILIES = {
    "s": ({"depth_multiple": 0.33, "width_multiple": 0.5, "variant": "s"}, 64),
    "enhanced": ({"depth_multiple": 0.33, "width_multiple": 0.5, "variant": "l",
                  "enhanced": True}, 64),
    "enhanced_ref_exact": ({"depth_multiple": 0.33, "width_multiple": 0.5, "variant": "l",
                            "enhanced": True, "ref_exact_cross_attn": True}, 64),
    # P5 16 x 16 = 256 tokens: both sides take the fused attention path
    "transformer": ({"depth_multiple": 0.33, "width_multiple": 0.5, "variant": "l",
                     "transformer_heads": True}, 512),
}


def _randomised(shapes, seed):
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


def _tree(flat, as_jax=True):
    conv = jnp.asarray if as_jax else np.asarray
    return traverse_util.unflatten_dict({tuple(k.split("/")): conv(v) for k, v in flat.items()})


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _assert_within_bf16_bound(got, ref):
    for g, r in zip(got, ref):
        a = np.asarray(r, np.float32)
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == a.shape
        err = np.abs(g.float().numpy() - a).max()
        assert np.isfinite(g.float().numpy()).all() and err <= 0.05 * np.abs(a).max() + 1e-2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_in_bf16_matches_jax_bf16(family, monkeypatch):
    monkeypatch.setenv("SKYEYE_FLASH_INTERPRET", "1")
    geometry, px = FAMILIES[family]
    cfg = {"nc": 5, "base_channels": 16, **geometry}
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg), dtype=jnp.bfloat16)
    flat = _randomised(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3))), 30)
    x = np.random.RandomState(31).uniform(0, 1, (1, px, px, 3)).astype(np.float32)
    ref = jax.jit(jmod.apply)(_tree(flat), jnp.asarray(x, jnp.bfloat16))

    tmod = tdet.create_detector(cfg, dtype=torch.bfloat16, device="cpu")
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    calls = []
    real = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda q, k, v: calls.append(q.dtype) or real(q, k, v))
    with torch.no_grad():
        got = tmod(_nchw(x))
    _assert_within_bf16_bound(got, ref)
    # K4 keeps float32 inputs in a bf16 model, as JAX casts around its kernel
    assert calls == ([torch.float32] if family == "transformer" else [])


def test_state_dict_stays_float32_and_keyed_as_in_float32():
    cfg = {"nc": 5, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5,
           "enhanced": True, "transformer_heads": True}
    f32 = tdet.create_detector(cfg, device="cpu").state_dict()
    bf16 = tdet.create_detector(cfg, dtype=torch.bfloat16, device="cpu")
    assert bf16.dtype == torch.bfloat16
    state = bf16.state_dict()
    assert list(state) == list(f32)
    for key, v in state.items():
        assert v.dtype == f32[key].dtype, key
        if v.is_floating_point():
            assert v.dtype == torch.float32 and torch.equal(v, f32[key]), key
    fused = tdet.fused_csp_detector(bf16)
    assert fused.dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in fused.state_dict().values()
               if v.is_floating_point())


def test_fused_csp_mode_in_bf16_matches_jax_bf16():
    """The whole fused-CSP detector in bf16 on both sides, on the same folded
    weights; K3 takes and returns bf16 with no float32 copy around it."""
    cfg = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5,
           "variant": "s"}
    jcanon = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg))
    flat = _randomised(jax.eval_shape(jcanon.init, jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3))), 32)
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg), fused_csp=True,
                                     dtype=jnp.bfloat16)
    jvars = jax.tree_util.tree_map(
        jnp.asarray, fuse_csp_variables(jax_fuse_conv_bn(_tree(flat, as_jax=False))))
    x = np.random.RandomState(33).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jmod.apply)(jvars, jnp.asarray(x, jnp.bfloat16))

    canonical = tdet.create_detector(cfg, dtype=torch.bfloat16, device="cpu")
    canonical.load_state_dict(from_jax_variables(flat), strict=True)
    fused = tdet.fused_csp_detector(canonical)
    block = fused.backbone.csp1
    assert isinstance(block, FusedCSPBlock) and block.dtype == torch.bfloat16
    seen = []
    hook = block.register_forward_hook(lambda m, args, out: seen.append(
        (args[0].dtype, out.dtype)))
    with torch.no_grad():
        got = fused(_nchw(x))
    hook.remove()
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    _assert_within_bf16_bound(got, ref)


def test_decode_of_bf16_logits_is_float32():
    from skyeye_tpu_torch.models.head import decode_predictions

    outs = [torch.randn(1, 4 >> i, 4 >> i, 3, 8).to(torch.bfloat16) for i in range(3)]
    dec = decode_predictions(outs, tdet.ModelConfig().anchors, (32, 32))
    assert dec.dtype == torch.float32
