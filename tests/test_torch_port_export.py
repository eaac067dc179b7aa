"""The PyTorch port's export against the JAX package's.

``export_torch`` must write what ``skyeye_tpu/cli/export.py::export_torch``
writes for the same weights: the same keys in the same order, each tensor bit
for bit, the same config and the same count of skipped leaves (plain, enhanced
and transformer detectors, the fused-CSP and int8-neck serving forms). JAX's
``load_model`` reads the port's file back to the very weights, and its logits
equal the port's within 1e-4 relative and 1e-4 x max|logit| absolute (float32
convolutions of two libraries). ``cli.export`` runs on the CPU with every
format; its ``torch.export`` program, loaded back, gives the decoded output of
the model bit for bit (the same kernels in one process), and keeps K4 as one
node.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.cli import export as jax_export
from skyeye_tpu.config import ModelConfig as JaxConfig
from skyeye_tpu.models import SkyEyeDetectorModule as JaxModule
from skyeye_tpu.ops.fused_csp import fuse_csp_variables
from skyeye_tpu.ops.int8_neck import _range_key_map, quantize_neck_variables
from skyeye_tpu.utils.checkpoint import fuse_conv_bn as jax_fuse_conv_bn
from skyeye_tpu.utils.checkpoint import load_model as jax_load_model
from skyeye_tpu_torch.cli import export as port_export
from skyeye_tpu_torch.config import ModelConfig
from skyeye_tpu_torch.models import attention
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.ops.calibrate import calibration_paths
from skyeye_tpu_torch.utils.checkpoint import (export_torch, from_jax_variables, fuse_conv_bn,
                                               load_model, reference_state_dict)

BASE = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.25}
VARIANTS = {
    "plain": ({}, {}),
    "enhanced": ({"enhanced": True}, {}),
    "transformer": ({"transformer_heads": True}, {}),
    "fused_csp": ({}, {"fused_csp": True}),
    "int8_neck": ({}, {"int8_neck": True}),
}
SIZE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _seeded(cfg, seed):
    module = JaxModule(config=JaxConfig(**cfg))
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.RandomState(seed)
    flat = {}
    for path, s in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            v = rng.uniform(0.6, 1.4, s.shape)
        elif leaf == "kernel":
            v = rng.normal(0, 1, s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        else:
            v = rng.normal(0, 0.1, s.shape)
        flat[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def _variant(name):
    """(JAX module, its variables, the port's module on the same weights)."""
    cfg_kw, mode = VARIANTS[name]
    cfg = {**BASE, **cfg_kw}
    variables = _seeded(cfg, 3)
    if mode:
        variables = jax_fuse_conv_bn(variables)
    if mode.get("fused_csp"):
        variables = fuse_csp_variables(variables)
    if mode.get("int8_neck"):
        ranges = {k: {"pctl": 4.0, "absmax": 6.0} for k in calibration_paths(_range_key_map(3))}
        variables = quantize_neck_variables(variables, ranges, JaxConfig(**cfg))
    port = SkyEyeDetectorModule(ModelConfig(**cfg), **mode).eval()
    port.load_state_dict(from_jax_variables(_flat(variables)), strict=True)
    return JaxModule(config=JaxConfig(**cfg), **mode), variables, port


def _jax_skipped(variables):
    """The leaves JAX's export_torch skips (no reference key), counted with its own map."""
    count = 0
    for coll in ("params", "batch_stats"):
        for path in traverse_util.flatten_dict(variables.get(coll, {})):
            count += jax_export._flax_to_torch_key(list(path[:-1])) is None
    return count


@pytest.mark.parametrize("name", list(VARIANTS))
def test_export_torch_equals_jax_key_for_key_and_bit_for_bit(name, tmp_path):
    jax_module, variables, port = _variant(name)
    jax_export.export_torch(jax_module, variables, tmp_path / "jax.pt")
    export_torch(port, tmp_path / "port.pt")
    want = torch.load(tmp_path / "jax.pt", weights_only=False)
    got = torch.load(tmp_path / "port.pt", weights_only=False)
    assert got["config"] == want["config"]
    assert list(got["state_dict"]) == list(want["state_dict"])
    for key, w in want["state_dict"].items():
        g = got["state_dict"][key]
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), key
    assert reference_state_dict(port)[1] == _jax_skipped(variables)


def test_jax_load_model_reads_the_ports_file_to_the_ports_logits(tmp_path):
    _, variables, port = _variant("plain")
    export_torch(port, tmp_path / "port.pt")
    module, loaded, config = jax_load_model(str(tmp_path / "port.pt"))
    assert config.to_dict() == port.config.to_dict()
    want = _flat(variables)
    got = _flat(loaded)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jax_out = jax.jit(lambda v, a: module.apply(v, a, train=False))(loaded, x)
    with torch.no_grad():
        port_out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(port_out, jax_out):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    # and the port reads it back to the same state
    again = load_model(tmp_path / "port.pt", device="cpu")
    for key, value in port.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key


def test_cli_export_runs_every_format_on_the_cpu_and_keeps_k4_as_one_node(tmp_path, monkeypatch):
    monkeypatch.setattr(attention, "FLASH_MIN_TOKENS", 1)  # P5 of a 64 px frame: 4 tokens
    _, _, port = _variant("transformer")
    weights = export_torch(port, tmp_path / "weights.pt")
    out = tmp_path / "exports"
    port_export.main(["--weights", str(weights), "--formats", "torch_export", "checkpoint",
                      "torch", "--img-size", str(SIZE), "--batch", "2", "--output", str(out),
                      "--device", "cpu"])
    program, checkpoint, reference = out / "model.pt2", out / "checkpoint.pt", out / "model.pt"
    served = load_model(weights, device="cpu")
    served.load_state_dict(fuse_conv_bn(served.state_dict()), strict=True)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, SIZE, SIZE, 3))
                         .astype(np.float32))
    exported = torch.export.load(str(program))
    targets = [str(n.target) for n in exported.graph.nodes]
    assert targets.count("skyeye.flash_attention.default") == 1
    assert not any("einsum" in t for t in targets)  # not the plain version in its place
    with torch.no_grad():
        want = port_export.DecodedForward(served, SIZE)(x)
        got = exported.module()(x)
    assert got.shape == (2, 3 * (8 * 8 + 4 * 4 + 2 * 2), 8) and torch.equal(got, want)
    reread = load_model(checkpoint, device="cpu")
    for key, value in served.state_dict().items():
        assert torch.equal(reread.state_dict()[key], value), key
    assert list(torch.load(reference, weights_only=False)["state_dict"]) == list(
        reference_state_dict(served)[0])
    opt = port_export.parse_opt(["--weights", "w.pt"])
    assert opt.formats == ["torch_export", "checkpoint"] and opt.device == "cuda"


@pytest.mark.parametrize("jax_name,port_name", [("stablehlo", "torch_export"),
                                                ("orbax", "checkpoint")])
def test_cli_export_names_the_ports_format_for_jaxs(jax_name, port_name, tmp_path):
    with pytest.raises(ValueError, match=port_name):
        port_export.run("skyeye_s", formats=[jax_name], output=str(tmp_path), device="cpu")
