"""``utils/profiling.py`` of the PyTorch port against the JAX package's.

``model_info``'s parameter tensors and parameters equal JAX's ``model_info``;
its GFLOPs (``FlopCounterMode``: convolutions and matrix products) equal JAX's
``flops_by_trace`` (the same count from the jaxpr) within 1e-6 relative, with
K4 counted by its custom op's formula; in the enhanced variant, but for the
cross-attentions' contractions, which JAX writes as einsums and resizes by
matrix products and the port as products, sums and ``F.interpolate``. JAX's
``model_info`` itself reports XLA's cost analysis: on the plain config here it
lies within 0.85-1.0 of the port's count (a recorded departure). ``scale_img``
against JAX's on the same batch: 1e-5 (float32 resampling weights of two
libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.config import ModelConfig as JaxConfig
from skyeye_tpu.models import SkyEyeDetectorModule as JaxModule
from skyeye_tpu.utils import profiling as jprof
from skyeye_tpu_torch.config import ModelConfig
from skyeye_tpu_torch.models import attention
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.utils import profiling as tprof
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

BASE = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.25}
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(cfg_kw):
    cfg = {**BASE, **cfg_kw}
    module = JaxModule(config=JaxConfig(**cfg))
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.RandomState(0)
    flat = {p: rng.normal(0, 0.1, s.shape).astype(np.float32) + (p.endswith("var") * 1.0)
            for p, s in traverse_util.flatten_dict(shapes, sep="/").items()}
    variables = traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    port = SkyEyeDetectorModule(ModelConfig(**cfg)).eval()
    port.load_state_dict(from_jax_variables(flat), strict=True)
    return module, variables, port


def _trace(module, variables):
    return jprof.flops_by_trace(lambda x: module.apply(variables, x, train=False),
                                jnp.zeros((1, SIZE, SIZE, 3)))


@pytest.mark.parametrize("cfg_kw", [{}, {"enhanced": True}, {"transformer_heads": True}],
                         ids=["plain", "enhanced", "transformer"])
def test_model_info_equals_jax(cfg_kw):
    module, variables, port = _pair(cfg_kw)
    got = tprof.model_info(port, SIZE)
    want = jprof.model_info(module, variables, SIZE)
    assert (got["layers"], got["parameters"]) == (want["layers"], want["parameters"])
    assert tprof.count_params(port) == got["parameters"] == jprof.count_params(
        variables["params"])
    trace = _trace(module, variables)
    if cfg_kw.get("enhanced"):
        # JAX's cross-attentions contract by einsum (the region logits and sums)
        # and resize by matrix products (jax.image.resize): dot_generals the trace
        # counts. The port computes those with products, sums and F.interpolate,
        # which the counter does not count: the whole gap lies in those modules.
        trace -= _cross_attention_gap(variables, port)
    assert abs(got["gflops"] * 1e9 - trace) <= 1e-6 * trace
    if not cfg_kw:  # XLA's cost analysis (JAX's own model_info) on this config
        assert 0.85 <= want["gflops"] / got["gflops"] <= 1.0


def _cross_attention_gap(variables, port):
    from skyeye_tpu.models.attention import CrossLayerAttention

    with torch.no_grad():
        p3, p4, p5 = port.neck(port.backbone(torch.zeros((1, 3, SIZE, SIZE))))
    gap = 0.0
    for name, q, k in (("cross_attn_p5_p4", p4, p5), ("cross_attn_p4_p3", p3, p4)):
        mod = CrossLayerAttention(query_channels=q.shape[1], key_channels=k.shape[1],
                                  region_size=2, heads=4)
        params = {"params": variables["params"][name]}
        jax_flops = jprof.flops_by_trace(lambda a, b: mod.apply(params, a, b),
                                         jnp.zeros(q.permute(0, 2, 3, 1).shape),
                                         jnp.zeros(k.permute(0, 2, 3, 1).shape))
        gap += jax_flops - tprof.flops_of(getattr(port, name), q, k)
    return gap


def test_k4_counted_by_its_formula_as_jax_counts_its_einsums(monkeypatch):
    module, variables, port = _pair({"transformer_heads": True})
    trace = _trace(module, variables)
    monkeypatch.setattr(attention, "FLASH_MIN_TOKENS", 1)  # the K4 op on 4 tokens
    x = torch.zeros((1, 3, SIZE, SIZE))
    assert tprof.flops_of(port, x) == pytest.approx(trace, rel=1e-6)


@pytest.mark.parametrize("ratio,same_shape", [(0.5, False), (0.67, True), (1.5, False)])
def test_scale_img_matches_jax(ratio, same_shape):
    img = np.random.default_rng(3).uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    want = np.asarray(jprof.scale_img(jnp.asarray(img), ratio, same_shape))
    got = tprof.scale_img(torch.from_numpy(img), ratio, same_shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert tprof.scale_img(torch.from_numpy(img), 1.0) is not None


def test_timing_profile_trace_and_devices(tmp_path):
    port = _pair({})[2]
    assert isinstance(tprof.time_sync(), float)
    assert tprof.bench_fn(lambda a: a * 2, torch.ones(4), n=3) >= 0
    rows = tprof.profile(torch.zeros((1, 3, 32, 32)), [port, torch.nn.functional.relu], n=1)
    assert [r["name"] for r in rows] == ["SkyEyeDetectorModule", "relu"]
    assert rows[0]["params"] == tprof.count_params(port) and rows[0]["gflops"] > 0
    assert rows[1]["gflops"] is None
    with tprof.trace(tmp_path / "trace") as d:
        port(torch.zeros((1, 3, 32, 32)))
    assert (d / "trace.json").stat().st_size > 0
    assert tprof.select_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for name in ("", "cuda", "cuda:0"):  # the card by default; none here
            with pytest.raises(RuntimeError, match="CUDA"):
                tprof.select_device(name)

    class A:
        pass

    a, b = A(), A()
    b.x, b.y, b._z = 1, 2, 3
    tprof.copy_attr(a, b, exclude=("y",))
    assert a.x == 1 and not hasattr(a, "y") and not hasattr(a, "_z")


def test_facade_model_info_and_apply_follow_jax():
    from skyeye_tpu_torch.api import SkyEyeDetector

    det = SkyEyeDetector(cfg=ModelConfig(**BASE), img_size=SIZE, device="cpu")
    info = det.model_info()
    assert info["img_size"] == SIZE and info == tprof.model_info(det.model, SIZE)
    x = np.random.default_rng(0).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    outs = det.apply(x)
    with torch.no_grad():
        want = det.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [o.shape for o in outs] == [(1, 8, 8, 3, 8), (1, 4, 4, 3, 8), (1, 2, 2, 3, 8)]
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
    with pytest.raises(ValueError, match="BatchNorm"):
        det.apply(x, train=True)
