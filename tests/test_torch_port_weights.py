"""Reference-layout ``.pt`` weights in the PyTorch port against the JAX package.

Each ``.pt`` is written on the spot by the JAX package's own
``skyeye_tpu.cli.export.export_torch`` from seeded flax variables (no weights
are downloaded). ``skyeye_tpu.SkyEyeDetector(weights=...)`` and the port's
``SkyEyeDetector(weights=...)`` load it with ``fuse=True`` (BatchNorm folded)
and serve the same BGR uint8 frames: counts and classes equal, in keep order,
boxes within 1e-2 px and scores within 1e-4, the tolerances of
``tests/test_torch_port_slice.py``. The conversion itself (names, layouts, the
Focus stem's 3x3-over-space-to-depth kernel into the fused 6x6 one) must give
JAX's values exactly.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import skyeye_tpu.models.detector as jdet
from skyeye_tpu.models import blocks as jblocks
from skyeye_tpu.api import SkyEyeDetector as JaxDetector
from skyeye_tpu.cli.export import export_torch
from skyeye_tpu.utils import checkpoint as jckpt
from skyeye_tpu_torch import SkyEyeDetector
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.utils import checkpoint as tckpt

BASE = {"nc": 6, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5}
CONFIGS = {
    "skyeye_s": {**BASE, "variant": "s"},
    "enhanced": {**BASE, "variant": "l", "enhanced": True},
}


def _variables(module, seed):
    """Seeded weights for every flax leaf (BN statistics too); the head's obj/cls
    biases where YOLOv5 puts them, so detections are sparse, as a trained
    detector's, and not near-ties everywhere."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(seed)
    flat = {}
    for path, v in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "var":
            flat[path] = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            flat[path] = rng.uniform(0.8, 1.2, v.shape)
        elif leaf == "kernel":
            flat[path] = rng.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            flat[path] = rng.normal(0, 0.5, v.shape)
    nc = module.config.nc
    for level, stride in enumerate((8, 16, 32)):
        bias = flat[f"params/head/pred{level}/bias"].reshape(3, nc + 5)
        bias[:, 4] += np.log(8 / (640 / stride) ** 2)
        bias[:, 5:] += np.log(0.6 / (nc - 0.99))
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _export(tmp_path, name, cfg, seed=5):
    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg))
    flat = _variables(module, seed)
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})
    path = tmp_path / f"{name}.pt"
    export_torch(module, tree, path)
    return path, flat


def _flat(variables):
    """flax {params, batch_stats} -> {"params/...": numpy}, for from_jax_variables."""
    return {f"{c}/{k}": np.asarray(v) for c in ("params", "batch_stats")
            for k, v in traverse_util.flatten_dict(variables.get(c, {}), sep="/").items()}


def _frames():
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (72, 128, 3), np.uint8) for _ in range(2)]
    frames.append(rng.randint(0, 256, (100, 60, 3), np.uint8))
    return [np.clip(f.astype(np.int32) // 32 * 32 + 16, 0, 255).astype(np.uint8) for f in frames]


@pytest.fixture(scope="module", params=list(CONFIGS))
def exported(request, tmp_path_factory):
    name = request.param
    return name, *_export(tmp_path_factory.mktemp(name), name, CONFIGS[name])


@pytest.mark.parametrize("approx_topk", [False, True])
def test_both_facades_serve_the_same_detections_from_one_pt(exported, approx_topk):
    _, path, _ = exported
    ref = JaxDetector(weights=str(path), img_size=128, conf_thres=0.005, fuse=True,
                      approx_topk=approx_topk)
    port = SkyEyeDetector(str(path), img_size=128, conf_thres=0.005, fuse=True,
                          approx_topk=approx_topk, device="cpu")
    assert port.config.enhanced == ref.config.enhanced
    frames = _frames()
    want, got = ref(frames), port(frames)
    assert sum(len(d) for d in got.xyxy) > 0
    for g, w in zip(got.xyxy, want.xyxy):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)


def test_loaded_weights_are_the_exported_ones_and_folded_as_jax_folds(exported):
    _, path, flat = exported
    _, jvars, _ = jckpt.load_model(str(path), fuse=True)  # JAX's load of the file, folded
    want = tckpt.from_jax_variables(_flat(jvars))
    got = SkyEyeDetector(str(path), fuse=True, device="cpu").model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
    # unfolded, the file gives back the exported weights exactly
    unfolded = SkyEyeDetector(str(path), fuse=False, device="cpu").model.state_dict()
    exact = tckpt.from_jax_variables(flat)
    for key in exact:
        assert torch.equal(unfolded[key], exact[key]), key


def test_conversion_equals_jax_and_rebuilds_the_fused_stem(exported, tmp_path):
    _, path, flat = exported
    raw = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
    # the file holds the reference's 3x3 kernel over the 12-channel s2d image
    assert tuple(raw["backbone.backbone.stage1.0.conv.conv.weight"].shape)[1:] == (12, 3, 3)
    want = tckpt.from_jax_variables(_flat(jckpt.convert_torch_state_dict(raw)))
    got = tckpt.convert_torch_state_dict(raw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    stem = got["backbone.stem.conv.weight"]
    assert tuple(stem.shape)[1:] == (3, 6, 6)
    assert torch.equal(stem, tckpt.from_jax_variables(flat)["backbone.stem.conv.weight"])
    k_s2d = np.arange(3 * 3 * 12 * 2, dtype=np.float32).reshape(3, 3, 12, 2)
    np.testing.assert_array_equal(tckpt.fused_stem_kernel(k_s2d), jblocks.fused_stem_kernel(k_s2d))


def _as_module(state_dict):
    """A bare nn.Module tree whose state_dict is ``state_dict``: the reference's
    ``{"model": module}`` convention."""
    root = torch.nn.Module()
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        m = root
        for p in path:
            if p not in m._modules:
                m.add_module(p, torch.nn.Module())
            m = m._modules[p]
        m.register_buffer(leaf, value.clone())
    return root


def test_three_wrapper_conventions_load_alike(tmp_path):
    path, _ = _export(tmp_path, "skyeye_s", CONFIGS["skyeye_s"])
    saved = torch.load(path, map_location="cpu", weights_only=False)
    sd = saved["state_dict"]
    want, meta = tckpt.load_torch_checkpoint(path)
    assert meta["config"]["base_channels"] == 16
    for name, obj in (("bare", sd), ("module", {"model": _as_module(sd), "epoch": 3})):
        p = tmp_path / f"{name}.pt"
        torch.save(obj, p)
        got, meta = tckpt.load_torch_checkpoint(p)
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert meta == ({} if name == "bare" else {"epoch": 3})


def test_a_transformer_pt_loads_by_shape_and_logs_what_stays_at_init(tmp_path, caplog):
    """export_torch drops head/transformer*: those leaves keep the seeded init,
    every other one is the file's, and the load says so."""
    cfg = {**BASE, "variant": "l", "transformer_heads": True}
    path, flat = _export(tmp_path, "transformer", cfg)
    caplog.set_level(logging.INFO, logger="skyeye_tpu_torch")
    state = SkyEyeDetector(str(path), fuse=False, device="cpu", seed=3).model.state_dict()
    seeded = tdet.create_detector(cfg, device="cpu", seed=3).state_dict()
    exact = tckpt.from_jax_variables(flat)
    left = sorted(k for k in state if k.startswith("head.transformer2."))
    assert left and all(torch.equal(state[k], seeded[k]) for k in left)
    assert all(torch.equal(state[k], exact[k]) for k in exact if k not in left)
    n_total = sum(not k.endswith("num_batches_tracked") for k in state)
    n_left = sum(not k.endswith("num_batches_tracked") for k in left)
    assert f"loaded {n_total - n_left}/{n_total} tensors" in caplog.text
    assert "head.transformer2.attn.qkv" in caplog.text and "seeded init" in caplog.text


def test_names_resolve_as_configs_and_other_sources_raise(tmp_path):
    det = SkyEyeDetector("skyeye_s", device="cpu")
    assert det.config.width_multiple == 0.5 and det.config.base_channels == 64
    bn = det.model.backbone.stem.bn  # folded: fuse=True is the default with weights=
    assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
    with pytest.raises(ValueError, match="orbax"):
        SkyEyeDetector(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        SkyEyeDetector(str(tmp_path / "missing_s.pt"), device="cpu")


@pytest.mark.parametrize("stem", ["yolo_s", "best_m", "weights_l", "last", "skyeye_x"])
def test_guess_variant_matches_jax(stem):
    assert tckpt._guess_variant(stem) == jckpt._guess_variant(stem)
