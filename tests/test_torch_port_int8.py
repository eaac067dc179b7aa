"""Int8 serving on the PyTorch port against the JAX package: calibration, the
three quantizers, the int8 convolution, ``Int8Neck``, ``Int8EarlyStage``,
``Int8PackedStem`` and the facade's ``quantize_int8``.

Flax variables are drawn from a seed at the scale of flax's init with
``tests/test_int8_stage.py``'s perturbation of every BN leaf (so folding moves
every weight, and JAX's closeness gates, set on such weights, apply), carried
across by ``from_jax_variables``; inputs are numpy from a seed. Torch runs on
one thread.

Tolerances, and why:
  * ranges: relative 1e-5 on every key a ``_range_key_map`` reads (float32
    convolutions summed in another order on the two sides);
  * quantizers, given the same folded weights and ranges: bitwise, dtype too
    (the same numpy arithmetic);
  * the int32 product of ``int8_conv``, both routes: equal to JAX's (exact);
  * a requantized tensor: an element may differ by one step where the epilogue's
    float32 SiLU lands on a .5 tie one ulp apart (XLA's logistic against torch's
    sigmoid): at most 0.1% of elements, by 1;
  * the int8 detectors' logits against JAX's: within 1e-5 * max|ref| + 1e-6 for
    all but 1% of elements (a flipped requant step moves the ones after it), and
    none beyond 0.05 * max|ref|;
  * against the float detector, JAX's own gates (``tests/test_int8_neck.py``,
    ``test_int8_stage.py``, ``test_int8_stem.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.api import SkyEyeDetector as JaxDetector
from skyeye_tpu.config import ModelConfig as JaxConfig
from skyeye_tpu.models import SkyEyeDetectorModule as JaxModule
from skyeye_tpu.ops import int8_neck as jneck
from skyeye_tpu.ops import int8_stage as jstage
from skyeye_tpu.ops.calibrate import observe_ranges as jax_observe_ranges
from skyeye_tpu.ops.int8_stem import quantize_stem_variables as jax_quantize_stem
from skyeye_tpu.ops.packed_stem import fold_input_scale as jax_fold_input_scale
from skyeye_tpu.ops.packed_stem import pack_stem_variables as jax_pack_stem
from skyeye_tpu.ops.packed_stem import s2d4_host
from skyeye_tpu.utils.checkpoint import fuse_conv_bn as jax_fuse_conv_bn
from skyeye_tpu_torch.api import SkyEyeDetector
from skyeye_tpu_torch.config import ModelConfig
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.ops import int8_neck, int8_stage
from skyeye_tpu_torch.ops.calibrate import calibration_paths, observe_ranges
from skyeye_tpu_torch.ops.int8_stem import Int8PackedStem, quantize_stem_variables
from skyeye_tpu_torch.ops.packed_stem import fold_input_scale, pack_stem_variables
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

CFG = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5}
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _tree(flat):
    return traverse_util.unflatten_dict({tuple(k.split("/")): np.asarray(v)
                                         for k, v in flat.items()})


def _port(module_kw, jax_vars):
    m = SkyEyeDetectorModule(ModelConfig(**CFG), **module_kw).eval()
    m.load_state_dict(from_jax_variables(_flat(jax_vars)), strict=True)
    return m


def _jit_apply(module):
    return jax.jit(lambda v, x: module.apply(v, x, train=False))


def _run_port(model, x_nhwc):
    with torch.no_grad():
        return [o.numpy() for o in model(torch.from_numpy(np.asarray(x_nhwc)).permute(0, 3, 1, 2))]


@pytest.fixture(scope="module")
def setup():
    """Seeded, BN-folded flax variables; calibration batches (raw and packed)."""
    canonical = JaxModule(config=JaxConfig(**CFG))
    shapes = jax.eval_shape(lambda k, x: canonical.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.RandomState(13)
    flat = {}
    for path, v in _flat(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                shapes)).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":  # flax's conv init scale, N(0, 2 / fan_out)
            flat[path] = rng.normal(0, np.sqrt(2.0 / np.prod(v.shape[:-2]) / v.shape[-1]),
                                    v.shape)
        else:  # test_int8_stage's fixture: the init moved by 0.05 noise, |.| + 0.05
            init = 1.0 if leaf in ("scale", "var") else 0.0
            flat[path] = np.abs(init + 0.05 * rng.normal(0, 1, v.shape)) + 0.05
    variables = _tree({k: v.astype(np.float32) for k, v in flat.items()})
    fused = jax_fuse_conv_bn(variables)
    data = np.random.default_rng(5)
    batches = [data.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2)]
    return {"canonical": canonical, "fused": fused, "batches": batches,
            "packed_vars": jax_pack_stem(fused),
            "packed_batches": [s2d4_host(b) for b in batches]}


@pytest.fixture(scope="module")
def neck_ranges(setup):
    port = _port({}, setup["fused"])
    return (jax_observe_ranges(setup["canonical"], setup["fused"], setup["batches"]),
            observe_ranges(port, setup["batches"]), port)


@pytest.fixture(scope="module")
def early_ranges(setup):
    packed = JaxModule(config=JaxConfig(**CFG), packed_stem=True)
    port = _port({"packed_stem": True}, setup["packed_vars"])
    return (jax_observe_ranges(packed, setup["packed_vars"], setup["packed_batches"]),
            observe_ranges(port, setup["packed_batches"]), port, packed)


def _early_map():
    return jstage._range_key_map(1, 1)  # depth 0.33: one bottleneck in csp1 and csp2


@pytest.mark.parametrize("which", ["neck", "early"])
def test_observe_ranges_match_jax_on_every_key_the_quantizers_read(which, request):
    jax_r, port_r, *_ = request.getfixturevalue(f"{which}_ranges")
    keys = calibration_paths(jneck._range_key_map(3) if which == "neck" else _early_map())
    assert keys
    for key in sorted(keys):
        for stat in ("absmax", "pctl"):
            np.testing.assert_allclose(port_r[key][stat], jax_r[key][stat], rtol=1e-5,
                                       err_msg=f"{key} {stat}")
    # every JAX path the port's modules mirror is there (flax's nn.Sequential
    # inside the CBAM MLP is a function of the port's, not a module)
    missing = {k for k in jax_r if k not in port_r and "Sequential" not in k}
    assert not missing, sorted(missing)[:5]


def test_observe_ranges_of_chosen_paths_are_those_of_the_whole_run(setup, neck_ranges):
    _, port_r, port = neck_ranges
    keys = calibration_paths(int8_neck._range_key_map(3))
    chosen = observe_ranges(port, setup["batches"], paths=keys)
    assert set(chosen) == keys
    for key in keys:
        assert chosen[key] == port_r[key]


def _assert_bitwise(port_state, prefix, jax_flat):
    got = {k[len(prefix):]: v.numpy() for k, v in port_state.items() if k.startswith(prefix)}
    assert sorted(got) == sorted(jax_flat)
    for name, want in jax_flat.items():
        want = np.asarray(want)
        assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name


def test_quantize_neck_variables_bitwise_equal_to_jax(setup, neck_ranges):
    jax_r, _, port = neck_ranges
    cfg = JaxConfig(**CFG)
    want = jneck.quantize_neck_variables(setup["fused"], jax_r, cfg)
    got = int8_neck.quantize_neck_variables(port.state_dict(), jax_r, ModelConfig(**CFG))
    _assert_bitwise(got, "neck.", want["params"]["neck"])
    rest = {k for k in got if not k.startswith("neck.")}
    assert rest == {k for k in port.state_dict() if not k.startswith("neck.")}


def test_quantize_early_variables_bitwise_equal_to_jax(setup, early_ranges):
    jax_r, _, port, _ = early_ranges
    want = jstage.quantize_early_variables(setup["packed_vars"], jax_r, JaxConfig(**CFG))
    got = int8_stage.quantize_early_variables(port.state_dict(), jax_r, ModelConfig(**CFG))
    _assert_bitwise(got, "backbone.int8_early.", want["params"]["backbone"]["int8_early"])
    for gone in ("stem", "down1", "csp1", "down2", "csp2"):
        assert not any(k.startswith(f"backbone.{gone}.") for k in got)


def test_quantize_stem_variables_bitwise_equal_to_jax(setup, early_ranges):
    port = early_ranges[2]
    want = jax_quantize_stem(jax_fold_input_scale(setup["packed_vars"]))
    got = quantize_stem_variables(fold_input_scale(port.state_dict()))
    _assert_bitwise(got, "backbone.stem.", want["params"]["backbone"]["stem"])


# (batch, H, W, Cin, kh, kw, Cout, stride, padding): JAX's conv shapes, and widths
# whose depth (kh kw Cin) or width (Cout) is no multiple of 8, and m <= 16 rows
INT8_CONVS = [
    (2, 8, 8, 48, 3, 3, 16, 1, ((1, 1), (1, 1))),   # the packed stem
    (2, 8, 8, 16, 2, 2, 8, 1, ((1, 0), (1, 0))),    # packed down1
    (2, 9, 7, 8, 3, 3, 16, 2, ((1, 1), (1, 1))),    # a stride-2 down
    (2, 6, 6, 24, 1, 1, 12, 1, ((0, 0), (0, 0))),   # a 1x1 (no im2col)
    (1, 5, 6, 2, 3, 3, 5, 1, ((1, 1), (1, 1))),     # k = 18, n = 5: both padded
    (1, 3, 3, 3, 1, 1, 3, 1, ((0, 0), (0, 0))),     # m = 9 rows, k = 3, n = 3
]


@pytest.mark.parametrize("shape", INT8_CONVS, ids=lambda s: "x".join(map(str, s[:7])))
def test_int8_conv_int32_product_equals_jax(shape):
    b, h, w, cin, kh, kw, cout, stride, pad = shape
    rng = np.random.default_rng(sum(shape[:7]))
    x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
    k = rng.integers(-127, 128, (kh, kw, cin, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    for route in (int8_stage.int8_conv, int8_stage.int8_conv_mm, int8_stage.int8_conv_plain):
        got = route(xt, kt, stride, pad)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), route.__name__


def test_qconv_epilogue_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (2, 8, 8, 16)).astype(np.int8)
    k = rng.integers(-127, 128, (3, 3, 16, 24)).astype(np.int8)
    res = rng.integers(-127, 128, (2, 8, 8, 24)).astype(np.int8)
    ws = rng.uniform(1e-4, 1e-3, 24).astype(np.float32)
    bias = rng.normal(0, 0.5, 24).astype(np.float32)
    s_in, s_out, s_res = (np.float32(v) for v in (0.02, 0.05, 0.03))
    for out_s in (s_out, None):
        want = np.asarray(jstage._qconv(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(s_in), jnp.asarray(ws),
            jnp.asarray(bias), padding=((1, 1), (1, 1)),
            out_scale=None if out_s is None else jnp.asarray(out_s),
            residual_q=jnp.asarray(res), residual_scale=jnp.asarray(s_res)).astype(jnp.float32))
        got = int8_stage._qconv(
            torch.from_numpy(x), torch.from_numpy(k), torch.tensor(s_in), torch.from_numpy(ws),
            torch.from_numpy(bias), padding=((1, 1), (1, 1)),
            out_scale=None if out_s is None else torch.tensor(out_s),
            residual_q=torch.from_numpy(res), residual_scale=torch.tensor(s_res))
        if out_s is None:
            assert got.dtype == torch.bfloat16  # bf16 where no scale follows, as JAX
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=0)
        else:
            assert got.dtype == torch.int8
            diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def _assert_logits_match_jax(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        diff = np.abs(g.astype(np.float32) - w)
        assert (diff > 1e-5 * scale + 1e-6).mean() <= 0.01, diff.max()
        assert diff.max() <= 0.05 * scale, diff.max()


def _assert_jax_neck_gates(got, ref):
    for g, r in zip(got, ref):
        corr = np.corrcoef(r.ravel(), g.ravel())[0, 1]
        assert corr > 0.995, corr
        assert np.max(np.abs(r - g)) < 0.5, np.max(np.abs(r - g))


def test_int8_neck_detector_matches_jax_and_jax_gates(setup, neck_ranges):
    jax_r, port_r, port = neck_ranges
    q_vars = jneck.quantize_neck_variables(setup["fused"], jax_r, JaxConfig(**CFG))
    jax_int8 = JaxModule(config=JaxConfig(**CFG), int8_neck=True)
    port_int8 = _port({"int8_neck": True}, q_vars)
    x = setup["batches"][0]
    _assert_logits_match_jax(_run_port(port_int8, x), _jit_apply(jax_int8)(q_vars, x))

    # the port's own path, calibrated by the port, against the port's float model
    own = SkyEyeDetectorModule(ModelConfig(**CFG), int8_neck=True).eval()
    own.load_state_dict(int8_neck.quantize_neck_variables(
        port.state_dict(), port_r, ModelConfig(**CFG)), strict=True)
    _assert_jax_neck_gates(_run_port(own, x), _run_port(port, x))


def test_int8_neck_module_alone_matches_jax(setup, neck_ranges):
    """Int8Neck on the same float features: the dequantized outputs of the two
    sides are equal but for single requant steps."""
    jax_r, _, port = neck_ranges
    q_vars = jneck.quantize_neck_variables(setup["fused"], jax_r, JaxConfig(**CFG))
    port_int8 = _port({"int8_neck": True}, q_vars)
    with torch.no_grad():
        feats = port.backbone(torch.from_numpy(setup["batches"][1]).permute(0, 3, 1, 2))
        got = [t.permute(0, 2, 3, 1).numpy() for t in port_int8.neck(feats)]
    jax_mod = jneck.Int8Neck(in_channels=tuple(f.shape[1] for f in feats), num_blocks=3,
                             dtype=jnp.float32)
    want = jax.jit(lambda v, f: jax_mod.apply(v, f))(
        {"params": q_vars["params"]["neck"]},
        [jnp.asarray(f.permute(0, 2, 3, 1).numpy()) for f in feats])
    _assert_logits_match_jax(got, want)


def test_int8_early_stage_matches_jax_and_jax_gates(setup, early_ranges):
    jax_r, port_r, port_packed, jax_packed = early_ranges
    q_vars = jstage.quantize_early_variables(setup["packed_vars"], jax_r, JaxConfig(**CFG))
    jax_int8 = JaxModule(config=JaxConfig(**CFG), packed_stem=True, int8_early=True)
    port_int8 = _port({"packed_stem": True, "int8_early": True}, q_vars)
    x = setup["packed_batches"][0]
    _assert_logits_match_jax(_run_port(port_int8, x), _jit_apply(jax_int8)(q_vars, x))

    own = SkyEyeDetectorModule(ModelConfig(**CFG), packed_stem=True, int8_early=True).eval()
    own.load_state_dict(int8_stage.quantize_early_variables(
        port_packed.state_dict(), port_r, ModelConfig(**CFG)), strict=True)
    for r, g in zip(_run_port(port_packed, x), _run_port(own, x)):  # test_int8_stage's gates
        r, g = r.ravel(), g.ravel()
        cos = float(np.dot(r, g) / (np.linalg.norm(r) * np.linalg.norm(g) + 1e-9))
        rel = float(np.abs(r - g).mean() / (np.abs(r).mean() + 1e-9))
        assert cos > 0.99 and rel < 0.15, (cos, rel)
    # a raw frame is packed on the device: the same logits
    for a, b in zip(_run_port(own, setup["batches"][0]), _run_port(own, x)):
        np.testing.assert_array_equal(a, b)


def test_int8_stem_matches_jax_exactly_on_its_input_and_jax_gates(setup, early_ranges):
    port_packed = early_ranges[2]
    serving = jax_fold_input_scale(setup["packed_vars"])
    q_vars = jax_quantize_stem(serving)
    frames = np.random.default_rng(7).integers(0, 256, (2, SIZE, SIZE, 3), np.uint8)
    packed = s2d4_host(frames)
    jax_int8 = JaxModule(config=JaxConfig(**CFG), packed_stem=True, int8_stem=True)
    port_int8 = _port({"packed_stem": True, "int8_stem": True}, q_vars)
    want = _jit_apply(jax_int8)(q_vars, packed)
    _assert_logits_match_jax(_run_port(port_int8, packed), want)

    # test_int8_stem's gates: the int8 stem against the float packed stem
    float_stem = SkyEyeDetectorModule(ModelConfig(**CFG), packed_stem=True).eval()
    float_stem.load_state_dict(fold_input_scale(port_packed.state_dict()), strict=True)
    ref = _run_port(float_stem, packed.astype(np.float32))
    for r, g in zip(ref, _run_port(port_int8, packed)):
        assert np.max(np.abs(r - g)) < 0.15, np.max(np.abs(r - g))
        assert np.corrcoef(r.ravel(), g.ravel())[0, 1] > 0.9999


def test_int8_stem_exact_against_the_dequantized_kernel():
    """Only the weights quantize: with the dequantized kernel put in the float
    conv, the int8 product and its +128 correction give the same, the border
    ring (where the correction varies) included (test_int8_stem's bound)."""
    rng = np.random.default_rng(0)
    k = (rng.normal(0, 1, (3, 3, 48, 32)) * 0.05).astype(np.float32)
    bias = rng.normal(0, 1, 32).astype(np.float32)
    ws = (np.abs(k).reshape(-1, 32).max(0) / 127.0).astype(np.float32)
    kq = np.clip(np.round(k / ws), -127, 127).astype(np.int8)
    k_deq = kq.astype(np.float32) * ws
    stem = Int8PackedStem(48, 32, dtype=torch.float32).eval()
    stem.load_state_dict({"kernel_q": torch.from_numpy(kq), "w_scale": torch.from_numpy(ws),
                          "bias": torch.from_numpy(bias),
                          "tap_sums": torch.from_numpy(128.0 * k_deq.sum(axis=2))})
    x = torch.from_numpy(rng.integers(0, 256, (2, 48, 16, 16)).astype(np.uint8))
    with torch.no_grad():
        got = stem(x)
        ref = torch.nn.functional.conv2d(x.float(), torch.from_numpy(k_deq).permute(3, 2, 0, 1),
                                         padding=1) + torch.from_numpy(bias)[:, None, None]
        ref = ref * torch.sigmoid(ref)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-3, rtol=1e-4)
    for edge in ((slice(None), slice(None), 0), (Ellipsis, -1)):  # top row, right column
        np.testing.assert_allclose(got[edge].numpy(), ref[edge].numpy(), atol=2e-3, rtol=1e-4)


def test_facade_quantize_int8_matches_jax_idempotent_and_serves(setup):
    fused = setup["fused"]
    jdet = JaxDetector(cfg=JaxConfig(**CFG), img_size=SIZE, conf_thres=0.01)
    jdet.variables = jax.tree_util.tree_map(jnp.asarray, fused)
    jdet._bn_fused = True
    det = SkyEyeDetector(cfg=ModelConfig(**CFG), img_size=SIZE, conf_thres=0.01,
                         state_dict=from_jax_variables(_flat(fused)), device="cpu")
    rng = np.random.default_rng(5)
    calib = [rng.integers(0, 256, (72, 96, 3), np.uint8) for _ in range(4)]
    jdet.quantize_int8(calib, mode="neck")
    det.quantize_int8(calib, mode="neck")
    assert det._int8_neck and det.model.int8_neck
    want = _flat(jdet.variables["params"]["neck"])
    got = {k[5:]: v.numpy() for k, v in det.model.state_dict().items() if k.startswith("neck.")}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name.startswith("s_"):  # from the two sides' ranges
            np.testing.assert_allclose(got[name], w, rtol=1e-5, err_msg=name)
        else:
            assert np.array_equal(got[name], w), name
    frame = rng.integers(0, 256, (80, 100, 3), np.uint8)
    res = det([frame])  # the quantized detector serves
    assert len(res.xyxy) == 1 and res.xyxy[0].shape[1] == 6
    state = det.model
    det.quantize_int8(calib)  # a second call changes nothing
    assert det.model is state
    with pytest.raises(ValueError):
        det.quantize_int8(calib, mode="stem")


@pytest.mark.parametrize("variant", [{"enhanced": True}, {"transformer_heads": True}],
                         ids=["enhanced", "transformer"])
def test_int8_neck_composes_with_the_variants_as_in_jax(variant):
    """The int8 neck under the enhanced cross-attentions and the transformer head:
    the detector against JAX's on the same quantized weights (fixed ranges, as
    ``bench.py`` synthesizes them)."""
    cfg = {**CFG, "width_multiple": 0.25, **variant}
    module = JaxModule(config=JaxConfig(**cfg))
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.RandomState(17)
    flat = {}
    for path, s in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.normal(0, np.sqrt(2.0 / np.prod(s.shape[:-2]) / s.shape[-1]), s.shape)
        else:
            init = 1.0 if leaf in ("scale", "var") else 0.0
            v = np.abs(init + 0.05 * rng.normal(0, 1, s.shape)) + 0.05
        flat[path] = v.astype(np.float32)
    fused = jax_fuse_conv_bn(traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()}))
    ranges = {k: {"pctl": 4.0, "absmax": 6.0} for k in calibration_paths(jneck._range_key_map(3))}
    q_vars = jneck.quantize_neck_variables(fused, ranges, JaxConfig(**cfg))
    port = SkyEyeDetectorModule(ModelConfig(**cfg), int8_neck=True).eval()
    port.load_state_dict(from_jax_variables(_flat(q_vars)), strict=True)
    x = np.random.default_rng(9).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = _jit_apply(JaxModule(config=JaxConfig(**cfg), int8_neck=True))(q_vars, x)
    _assert_logits_match_jax(_run_port(port, x), want)
