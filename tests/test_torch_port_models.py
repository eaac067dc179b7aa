"""Model modules of the PyTorch port against the JAX package, on shared weights.

Flax variables are randomised from a seed (BatchNorm statistics too, so the
bridge's mapping of every leaf is exercised), flattened to numpy, mapped with
``from_jax_variables`` and loaded with ``strict=True``. Inputs are numpy from a
seed; everything runs in float32 on the CPU. Tolerance: atol 1e-4 on
activations and logits (float32, sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import attention as jatt
from skyeye_tpu.models import backbone as jbb
from skyeye_tpu.models import blocks as jblocks
from skyeye_tpu.models import detector as jdet
from skyeye_tpu.models import head as jhead
from skyeye_tpu.models import neck as jneck
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import backbone as tbb
from skyeye_tpu_torch.models import blocks as tblocks
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.models import head as thead
from skyeye_tpu_torch.models import neck as tneck
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

ATOL = 1e-4


def _shapes(jmod, *args):
    """The flax module's variable shapes, traced without compiling an init."""
    return jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)


def _randomised(variables, seed):
    """Every leaf replaced by seeded numpy values of its shape; variances > 0."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(variables, sep="/")
    out = {}
    for path, v in flat.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "var":
            out[path] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif leaf == "scale":
            out[path] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif leaf == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            out[path] = (rng.normal(0, 1, v.shape) / np.sqrt(fan_in)).astype(np.float32)
        else:
            out[path] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return out


def _to_jax(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})


def _pair(jmod, tmod, x_nhwc, seed=0):
    """Init the flax module, randomise, bridge into the torch module; return both."""
    flat = _randomised(_shapes(jmod, jnp.asarray(x_nhwc)), seed)
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    return _to_jax(flat), tmod.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _image(seed, shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


BLOCKS = {
    "conv3x3_s2": (lambda: jblocks.ConvBlock(24, 3, 2), lambda: tblocks.ConvBlock(12, 24, 3, 2)),
    "conv1x1": (lambda: jblocks.ConvBlock(8, 1, 1), lambda: tblocks.ConvBlock(12, 8, 1, 1)),
    "bottleneck": (lambda: jblocks.Bottleneck(12), lambda: tblocks.Bottleneck(12, 12)),
    "csp": (lambda: jblocks.CSPBlock(16, 2), lambda: tblocks.CSPBlock(12, 16, 2)),
    "spp": (lambda: jblocks.SPPBlock(20), lambda: tblocks.SPPBlock(12, 20)),
    "focus": (lambda: jblocks.FocusBlock(16, kernel_size=3),
              lambda: tblocks.FocusBlock(12, 16, kernel_size=3)),
    "cbam": (lambda: jatt.CBAM(), lambda: tatt.CBAM(12)),
    "channel_attention": (lambda: jatt.ChannelAttention(), lambda: tatt.ChannelAttention(12)),
    "spatial_attention": (lambda: jatt.SpatialAttention(), lambda: tatt.SpatialAttention()),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_jax(name):
    jmk, tmk = BLOCKS[name]
    x = _image(1, (2, 18, 22, 12))
    variables, tmod = _pair(jmk(), tmk(), x, seed=len(name))
    ref = np.asarray(jmk().apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_space_to_depth_order_matches_jax_and_the_fused_stem():
    x = _image(2, (2, 8, 10, 3))
    ref = np.asarray(jblocks.space_to_depth_2x2(jnp.asarray(x)))
    got = tblocks.space_to_depth_2x2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    # the fused 6x6/2 stem equals s2d followed by a 3x3 conv with unfused weights
    focus = tblocks.FocusBlock(3, 5).eval()
    with torch.no_grad():
        k_fused = focus.conv.weight.numpy().transpose(2, 3, 1, 0)          # HWIO
        k_s2d = torch.from_numpy(jblocks.unfuse_stem_kernel(k_fused).transpose(3, 2, 0, 1))
        via_s2d = torch.nn.functional.conv2d(
            _nchw(got), k_s2d.contiguous(), padding=1)
        direct = focus.conv(_nchw(x))
    np.testing.assert_allclose(via_s2d.numpy(), direct.numpy(), rtol=0, atol=1e-5)


GEOMETRIES = {"s": (0.33, 0.5), "m": (0.67, 0.75), "l": (1.0, 1.0)}


@pytest.mark.parametrize("variant", list(GEOMETRIES))
def test_backbone_and_neck_match_jax(variant):
    d, w = GEOMETRIES[variant]
    x = _image(3, (2, 64, 96, 3))
    jb = jbb.CSPDarknet(base_channels=16, depth_multiple=d, width_multiple=w)
    variables, tb = _pair(jb, tbb.CSPDarknet(16, d, w), x, seed=4)
    ref = jax.jit(jb.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tb(_nchw(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=0, atol=ATOL)

    ch = tbb.feature_channels(16, w)
    assert ch == jbb.feature_channels(16, w)
    feats = [_image(5 + i, (2, 8 >> i, 12 >> i, c)) for i, c in enumerate(ch)]
    jn = jneck.FeatureNeck(in_channels=tuple(ch))
    nvars = _randomised(_shapes(jn, [jnp.asarray(f) for f in feats]), 6)
    tn = tneck.FeatureNeck(ch)
    tn.load_state_dict(from_jax_variables(nvars), strict=True)
    ref = jax.jit(jn.apply)(_to_jax(nvars), [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tn.eval()([_nchw(f) for f in feats])
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=0, atol=ATOL)


def test_upsample_matches_jax():
    x = _image(7, (2, 3, 5, 4))
    ref = np.asarray(jneck.upsample_nearest_2x(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(tneck.upsample_nearest_2x(_nchw(x))), ref)


@pytest.mark.parametrize("variant", list(GEOMETRIES))
def test_detector_logits_and_decode_match_jax(variant):
    d, w = GEOMETRIES[variant]
    cfg = {"nc": 7, "base_channels": 16, "depth_multiple": d, "width_multiple": w,
           "variant": variant}
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg))
    flat = _randomised(_shapes(jmod, jnp.zeros((1, 64, 64, 3))), 8)
    tmod = tdet.create_detector(cfg, device="cpu")
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    x = _image(9, (2, 64, 96, 3)) * 0.5 + 0.5
    ref = jax.jit(jmod.apply)(_to_jax(flat), jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape  # (B, H, W, na, nc + 5)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)
    anchors = np.asarray(cfg_anchors := tmod.config.anchors, np.float32)
    for anchor_major in (True, False):
        ref_dec = jhead.decode_predictions(ref, jnp.asarray(anchors), (64, 96),
                                           anchor_major=anchor_major)
        got_dec = thead.decode_predictions(got, cfg_anchors, (64, 96), anchor_major=anchor_major)
        # decoded xywh are in pixels: logit error atol 1e-4 grows by at most stride x 2
        np.testing.assert_allclose(got_dec.numpy(), np.asarray(ref_dec), rtol=0, atol=1e-3)
    ref_layout = jhead.to_reference_layout(ref)
    for g, r in zip(thead.to_reference_layout(got), ref_layout):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=ATOL)


def test_decode_matches_jax_on_identical_logits():
    rng = np.random.RandomState(11)
    outs = [rng.normal(0, 2, (2, 8 >> i, 6 >> i, 3, 9)).astype(np.float32) for i in range(3)]
    anchors = np.asarray(tdet.ModelConfig().anchors, np.float32)
    for anchor_major in (True, False):
        ref = jhead.decode_predictions([jnp.asarray(o) for o in outs], jnp.asarray(anchors),
                                       (64, 48), anchor_major=anchor_major)
        got = thead.decode_predictions([torch.from_numpy(o) for o in outs], anchors, (64, 48),
                                       anchor_major=anchor_major)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


def test_unported_variants_raise():
    # every shipped configuration is ported: the transformer variant
    # (tests/test_torch_port_attention.py) and the enhanced one
    # (tests/test_torch_port_enhanced.py); a name that is none of them raises
    with pytest.raises(FileNotFoundError, match="no model config"):
        tdet.create_detector("skyeye_xl_enhanced", device="cpu")
