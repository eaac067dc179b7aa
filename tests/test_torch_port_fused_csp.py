"""The fused-CSP serving mode of the PyTorch port against the JAX package (K3's slice).

Flax variables are randomised from a seed (BN statistics too, so folding is
exercised), carried across by ``from_jax_variables``, and inputs are numpy from
a seed. The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers run their plain version on the CPU.

Tolerances: folding and the flat rewrite are float32 elementwise work, 1e-6.
The kernel's plain version against ``csp_fused``/``csp_fused_v2``:
0.02 * max|ref| + 1e-3, the bf16 accumulation-order class of the Pallas tests.
The fused detector against JAX's: 0.05 * max|a| + 1e-2 per level, the bound of
``tests/test_pallas_kernels.py``'s fused-detector test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import blocks as jblocks
from skyeye_tpu.models import detector as jdet
from skyeye_tpu.ops.fused_csp import fuse_csp_variables
from skyeye_tpu.ops.pallas.csp_kernel import csp_fused as jax_csp_fused
from skyeye_tpu.ops.pallas.csp_kernel import csp_fused_v2 as jax_csp_fused_v2
from skyeye_tpu.utils.checkpoint import fuse_conv_bn as jax_fuse_conv_bn
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.ops import csp_kernel as tck
from skyeye_tpu_torch.ops.fused_csp import FusedCSPBlock, fuse_csp_state
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables, fuse_conv_bn

CFG = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5,
       "variant": "s"}


def _randomised(shapes, seed):
    """Seeded numpy values for every flax leaf; BN scales, means and variances far
    from the identity, so that folding moves every weight."""
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


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): np.asarray(v)
                                         for k, v in flat.items()})


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def detector_weights():
    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG))
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return _randomised(shapes, 21)


def _assert_states_equal(got, want, atol=1e-6):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=0, atol=atol,
                                   err_msg=key)


def test_fuse_conv_bn_matches_jax_through_the_bridge(detector_weights):
    want = from_jax_variables(_flat(jax_fuse_conv_bn(_tree(detector_weights))))
    got = fuse_conv_bn(from_jax_variables(detector_weights))
    _assert_states_equal(got, want)
    assert torch.equal(got["backbone.stem.bn.weight"],
                       torch.ones_like(got["backbone.stem.bn.weight"]))
    assert torch.equal(got["backbone.csp1.cv1.bn.running_var"],
                       torch.full_like(got["backbone.csp1.cv1.bn.running_var"], 1 - 1e-5))


def test_fuse_csp_state_matches_jax_through_the_bridge(detector_weights):
    folded = jax_fuse_conv_bn(_tree(detector_weights))
    want = from_jax_variables(_flat(fuse_csp_variables(folded, path=("backbone", "csp1"))))
    got = fuse_csp_state(fuse_conv_bn(from_jax_variables(detector_weights)), "backbone.csp1")
    _assert_states_equal(got, want)
    assert got["backbone.csp1.w_m2"].shape == (1, 3, 3, 8, 8)  # nb 1, h = 16 * 2 * 0.5 / 2


def test_fuse_csp_state_rejects_weights_that_are_not_folded(detector_weights):
    with pytest.raises(ValueError, match="not BN-folded"):
        fuse_csp_state(from_jax_variables(detector_weights))
    folded = fuse_conv_bn(from_jax_variables(detector_weights))
    folded["backbone.csp1.m0.cv2.bn.weight"] = folded["backbone.csp1.m0.cv2.bn.weight"] * 2.0
    with pytest.raises(ValueError, match="m0.cv2.bn: weights are not BN-folded"):
        fuse_csp_state(folded)


def _csp_weights(nb, c, seed):
    """Flat weights of a folded canonical CSP block, from JAX's own transform."""
    block = jblocks.CSPBlock(c, nb)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, c)))
    tree = _tree(_randomised(shapes, seed))
    folded = jax_fuse_conv_bn({col: {"backbone": {"csp1": tree[col]}}
                               for col in ("params", "batch_stats")})
    flat = fuse_csp_variables(folded)["params"]["backbone"]["csp1"]
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


@pytest.mark.parametrize("nb,c,hw,tile_rows", [(1, 64, (16, 16), 8), (2, 32, (12, 10), 4)])
def test_plain_version_matches_both_pallas_versions(nb, c, hw, tile_rows):
    weights = _csp_weights(nb, c, seed=nb * 100 + c)
    x = np.random.RandomState(c).normal(0, 1, (2, *hw, c)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    refs = {
        "csp_fused": jax_csp_fused(xb, jw, num_blocks=nb, tile_rows=tile_rows, interpret=True),
        "csp_fused_v2": jax_csp_fused_v2(xb, jw, num_blocks=nb, tile_rows=tile_rows,
                                         interpret=True),
    }
    tx = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    outs = {"plain": tck.csp_fused_plain(tx, tw, nb),
            "csp_fused": tck.csp_fused(tx, tw, nb, tile_rows),
            "csp_fused_v2": tck.csp_fused_v2(tx, tw, nb, tile_rows)}
    for ref_name, ref in refs.items():
        ref = np.asarray(ref, np.float32)
        for name, out in outs.items():
            assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
            err = np.abs(out.float().numpy() - ref).max()
            assert err <= 0.02 * np.abs(ref).max() + 1e-3, (name, ref_name, err)


def test_wrapper_checks_weight_shapes():
    weights = {k: torch.from_numpy(v) for k, v in _csp_weights(1, 16, seed=3).items()}
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="w_m1"):
        tck.csp_fused_v2(x, weights, num_blocks=2)
    with pytest.raises(KeyError, match="b_cv3"):
        tck.csp_fused_v2(x, {k: v for k, v in weights.items() if k != "b_cv3"}, 1)


def test_fused_block_is_serving_only():
    block = FusedCSPBlock(16, 16, 1)
    with pytest.raises(RuntimeError, match="serving-only"):
        block(torch.zeros(1, 16, 4, 4))
    assert all(not p.requires_grad for p in block.parameters())


def test_fused_csp_detector_matches_jax(detector_weights):
    """fused_csp=True on both sides, on the same folded weights, at 64 px."""
    folded = jax_fuse_conv_bn(_tree(detector_weights))
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG), fused_csp=True)
    jvars = jax.tree_util.tree_map(jnp.asarray, fuse_csp_variables(folded))
    x = np.random.RandomState(22).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = jax.jit(jmod.apply)(jvars, jnp.asarray(x))

    canonical = tdet.create_detector(CFG, device="cpu")
    canonical.load_state_dict(from_jax_variables(detector_weights), strict=True)
    fused = tdet.fused_csp_detector(canonical)
    assert isinstance(fused.backbone.csp1, FusedCSPBlock) and not fused.training
    with torch.no_grad():
        got = fused(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
        canon = canonical(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    for g, r, c in zip(got, ref, canon):
        a = np.asarray(r, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == a.shape
        assert np.abs(g.numpy() - a).max() <= 0.05 * np.abs(a).max() + 1e-2
        # and the canonical detector on the unfolded weights, as chip_smoke.py holds it
        assert np.abs(g.numpy() - c.numpy()).max() <= 0.05 * np.abs(c.numpy()).max() + 1e-2
