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


# skyeye_s's csp1 width; a narrow nb 2; skyeye_m's csp1 width (C 96, h 48, nb 2)
@pytest.mark.parametrize("nb,c,hw,tile_rows", [(1, 64, (16, 16), 8), (2, 32, (12, 10), 4),
                                               (2, 96, (9, 11), 8)])
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


def test_fused_block_prepares_its_packed_weights_once(detector_weights, monkeypatch):
    """fused_csp_detector prepares csp1's packed weights once; two forwards reuse
    them and both match JAX's fused detector; prepare() packs new weights."""
    from skyeye_tpu_torch.ops import fused_csp

    calls = []
    real = fused_csp.prepare_weights
    monkeypatch.setattr(fused_csp, "prepare_weights",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    folded = jax_fuse_conv_bn(_tree(detector_weights))
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG), fused_csp=True)
    jvars = jax.tree_util.tree_map(jnp.asarray, fuse_csp_variables(folded))
    canonical = tdet.create_detector(CFG, device="cpu")
    canonical.load_state_dict(from_jax_variables(detector_weights), strict=True)
    fused = tdet.fused_csp_detector(canonical)
    block = fused.backbone.csp1
    prepared = block.prepared
    assert prepared is not None and len(calls) == 1
    for seed in (23, 24):
        x = np.random.RandomState(seed).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
        ref = jax.jit(jmod.apply)(jvars, jnp.asarray(x))
        with torch.no_grad():
            got = fused(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
        for g, r in zip(got, ref):
            a = np.asarray(r, np.float32)
            assert np.abs(g.numpy() - a).max() <= 0.05 * np.abs(a).max() + 1e-2
    assert block.prepared is prepared and len(calls) == 1
    with torch.no_grad():
        block.w_cv1.mul_(0.5)
    assert block.prepare() is block.prepared is not prepared and len(calls) == 2
    assert torch.equal(block.prepared.rounded["w_cv1"],
                       (prepared.rounded["w_cv1"] * 0.5).to(torch.bfloat16).float())


def test_fused_block_refuses_unprepared_weights():
    block = FusedCSPBlock(16, 16, 1).eval()
    with pytest.raises(RuntimeError, match="call prepare"):
        block(torch.zeros(1, 16, 4, 4))
    block.prepare()
    assert block(torch.zeros(1, 16, 4, 4)).shape == (1, 16, 4, 4)


def _csp1_shapes():
    """(name, C, h, nb) of csp1 in every shipped model configuration."""
    from skyeye_tpu_torch.config import MODEL_CONFIGS
    from skyeye_tpu_torch.models.backbone import scaled_channels, scaled_depth

    for name, cfg in MODEL_CONFIGS.items():
        c = scaled_channels(cfg["base_channels"] * 2, cfg["width_multiple"])
        yield name, c, c // 2, scaled_depth(3, cfg["depth_multiple"])


@pytest.mark.parametrize("name,c,h,nb", list(_csp1_shapes()))
def test_every_shipped_csp1_fits_the_kernel(name, c, h, nb):
    """csp1 of every shipped configuration is a group csrc/csp.cu is built for and
    fits one block's shared memory at TILE_ROWS: skyeye_s's with its packed
    weights, the wider ones with the weights read from device memory."""
    hp, op = (h + 31) // 32 * 32, (c + 31) // 32 * 32
    assert (hp // 32, op // 32) in tck.SUPPORTED_GROUPS
    assert tck.smem_bytes(c, h, nb, tck.TILE_ROWS, c) <= tck.MAX_SMEM
    assert tck.weights_in_smem(c, h, nb, tck.TILE_ROWS, c) == (name == "skyeye_s")


def _unpack(frags, kp, np_):
    """The (kp, np_) matrix a block of mma.m16n8k16 B fragments holds, read by the
    PTX fragment map: lane (g, t) of (k step s, n tile j) holds, in order,
    k = 16 s + 2t, 2t + 1, 2t + 8, 2t + 9 of column 8 j + g."""
    f = frags.float().reshape(kp // 16, np_ // 8, 32, 4)
    w = torch.empty((kp, np_))
    for s in range(kp // 16):
        for j in range(np_ // 8):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e, dk in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                    w[16 * s + dk, 8 * j + g] = f[s, j, lane, e]
    return w


@pytest.mark.parametrize("c,h,c_out,nb", [(64, 32, 64, 1), (12, 6, 10, 2)])
def test_packed_weights_hold_the_rounded_weights_in_fragment_order(c, h, c_out, nb):
    """Each packed block unpacks to its bf16-rounded weight, zero-padded (C to 16,
    h and C_out to 32), in the order csrc/csp.cu reads them; the biases likewise."""
    gen = torch.Generator().manual_seed(c + nb)
    shapes = {"w_cv1": (c, h), "b_cv1": (h,), "w_m1": (nb, h, h), "b_m1": (nb, h),
              "w_m2": (nb, 3, 3, h, h), "b_m2": (nb, h), "w_cv2": (c, h), "b_cv2": (h,),
              "w_cv3": (2 * h, c_out), "b_cv3": (c_out,)}
    weights = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    pw = tck.prepare_weights(weights, nb)
    r = {k: v.to(torch.bfloat16).float() for k, v in weights.items()}
    assert all(torch.equal(pw.rounded[k], r[k]) for k in r)
    cp, hp, op = (c + 15) // 16 * 16, (h + 31) // 32 * 32, (c_out + 31) // 32 * 32

    def padded(w, kp, np_):
        out = torch.zeros((kp, np_))
        out[: w.shape[0], : w.shape[1]] = w
        return out

    w3 = torch.zeros((2 * hp, c_out))
    w3[:h], w3[hp:hp + h] = r["w_cv3"][:h], r["w_cv3"][h:]
    blocks = ([(r["w_cv1"], cp, hp)] + [(r["w_m1"][i], hp, hp) for i in range(nb)]
              + [(r["w_m2"][i, dy, dx], hp, hp) for i in range(nb) for dy in range(3)
                 for dx in range(3)]
              + [(r["w_cv2"], cp, hp), (w3, 2 * hp, op)])
    at = 0
    for w, kp, np_ in blocks:
        torch.testing.assert_close(_unpack(pw.frags[at:at + kp * np_], kp, np_),
                                   padded(w, kp, np_), rtol=0, atol=0)
        at += kp * np_
    assert at == pw.frags.numel()
    bias = torch.cat([padded(r["b_cv1"][None], 1, hp)[0]]
                     + [padded(r["b_m1"][i][None], 1, hp)[0] for i in range(nb)]
                     + [padded(r["b_m2"][i][None], 1, hp)[0] for i in range(nb)]
                     + [padded(r["b_cv2"][None], 1, hp)[0], padded(r["b_cv3"][None], 1, op)[0]])
    torch.testing.assert_close(pw.bias, bias, rtol=0, atol=0)
    pixels = (tck.TILE_ROWS + 2 * nb) * (tck.TILE_COLS + 2 * nb)
    xs, ws = max(cp, 2 * hp, op) + 8, hp + 8
    assert tck.smem_bytes(c, h, nb, tck.TILE_ROWS, c_out) == (
        pw.frags.numel() * 2 + pw.bias.numel() * 4 + pixels * (xs + ws) * 2)


def test_plain_version_takes_prepared_weights():
    weights = {k: torch.from_numpy(v) for k, v in _csp_weights(2, 32, seed=5).items()}
    x = torch.from_numpy(np.random.RandomState(6).normal(0, 1, (1, 9, 11, 32))
                         .astype(np.float32)).to(torch.bfloat16)
    pw = tck.prepare_weights(weights, 2)
    assert torch.equal(tck.csp_fused_v2(x, pw, 2), tck.csp_fused_plain(x, weights, 2))
    with pytest.raises(ValueError, match="prepared for C 32, nb 2"):
        tck.csp_fused_v2(x, pw, 1)
