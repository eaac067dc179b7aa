"""Configuration, box ops and letterbox of the PyTorch port against the JAX package."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import importlib

from skyeye_tpu import config as jcfg
from skyeye_tpu_torch import config as tcfg
from skyeye_tpu_torch.ops import boxes as tboxes
from skyeye_tpu_torch.ops import letterbox as tlb

jboxes = importlib.import_module("skyeye_tpu.ops.boxes")
jlb = importlib.import_module("skyeye_tpu.ops.letterbox")  # the package exports a same-named function

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs" / "models"
YAMLS = sorted(CONFIG_DIR.glob("*.yaml"))


def test_constants_match_jax():
    assert tcfg.DEFAULT_ANCHORS == jcfg.DEFAULT_ANCHORS
    assert tcfg.STRIDES == jcfg.STRIDES
    assert tcfg.VARIANTS == jcfg.VARIANTS


def test_literals_cover_the_shipped_configs():
    assert len(YAMLS) == 5
    assert sorted(tcfg.MODEL_CONFIGS) == [p.stem for p in YAMLS]


@pytest.mark.parametrize("path", YAMLS, ids=[p.stem for p in YAMLS])
def test_config_values_match_jax(path):
    ref = jcfg.ModelConfig.from_yaml(path).to_dict()
    assert tcfg.load_model_config(path.stem).to_dict() == ref  # the literal
    assert tcfg.ModelConfig.from_yaml(path).to_dict() == ref    # the YAML file
    assert tcfg.load_model_config(str(path)).to_dict() == ref


@pytest.mark.parametrize("variant", ["s", "m", "l", "skyeye_m"])
def test_from_variant_and_dict_match_jax(variant):
    assert (tcfg.ModelConfig.from_variant(variant, nc=7).to_dict()
            == jcfg.ModelConfig.from_variant(variant, nc=7).to_dict())
    raw = {"nc": 3, "base_channels": 16, "anchors": [[1, 2, 3, 4, 5, 6]] * 3}
    assert tcfg.ModelConfig.from_dict(raw).to_dict() == jcfg.ModelConfig.from_dict(raw).to_dict()


@pytest.mark.parametrize("in_shape,out_shape", [((45, 80), (64, 64)), ((90, 61), (64, 96)),
                                                (30, 30), ((1080, 1920), (128, 128))])
def test_letterbox_matches_jax(in_shape, out_shape):
    if isinstance(in_shape, int):  # upscaling a square frame
        in_shape, out_shape = (in_shape, in_shape), (64, 64)
    frames = np.random.RandomState(sum(in_shape)).randint(0, 256, (2, *in_shape, 3), np.uint8)
    assert tlb.letterbox_params(in_shape, out_shape) == jlb.letterbox_params(in_shape, out_shape)
    ref = np.asarray(jlb.letterbox_batch_jax(jnp.asarray(frames), out_shape))
    got = tlb.letterbox_batch(torch.from_numpy(frames), out_shape)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # pixel values 0..255; the lerps may round once more or less than XLA's
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)


def _boxes(seed, n):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 300, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(-5, 90, (n, 2))], -1).astype(np.float32)


@pytest.mark.parametrize("fn,args", [
    ("xywh2xyxy", ()), ("xyxy2xywh", ()), ("clip_boxes", ((200, 250),)),
    ("scale_boxes", ((640, 640), None, (480, 720))),
    ("scale_boxes", ((640, 640), None, (480, 720), ((0.5, 0.5), (3.0, 7.0)))),
])
def test_box_ops_match_jax(fn, args):
    b = _boxes(1, 40)
    if fn == "scale_boxes":
        img1, _, img0, *ratio_pad = args
        ref = jboxes.scale_boxes(img1, jnp.asarray(b), img0, *ratio_pad)
        got = tboxes.scale_boxes(img1, torch.from_numpy(b), img0, *ratio_pad)
    else:
        ref = getattr(jboxes, fn)(jnp.asarray(b), *args)
        got = getattr(tboxes, fn)(torch.from_numpy(b), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)


def test_box_iou_matches_jax():
    a, b = _boxes(2, 30), _boxes(3, 17)
    ref = jboxes.box_iou(jnp.asarray(a), jnp.asarray(b))
    got = tboxes.box_iou(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (30, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_default_hyp_matches_jax():
    assert tcfg.DEFAULT_HYP == jcfg.DEFAULT_HYP


@pytest.mark.parametrize("values", [
    {"lr0": 1e-5, "momentum": 0.9, "mosaic": 0, "warmup_epochs": 2},
    {"lr0": 0.02, "hsv_h": 0.0, "anchor_t": 3.5, "new_key": 7},
])
def test_hyp_files_read_as_jax_reads_them(values, tmp_path):
    """A hyp file written by PyYAML and one by ``dump_flat_yaml``: the port's flat
    reader gives JAX's ``load_hyp`` numbers; PyYAML reads the port's file back."""
    import yaml

    by_yaml, by_port = tmp_path / "a.yaml", tmp_path / "b.yaml"
    by_yaml.write_text(yaml.safe_dump(values))
    by_port.write_text(tcfg.dump_flat_yaml(values))
    assert tcfg.load_hyp(by_yaml) == jcfg.load_hyp(by_yaml)
    assert tcfg.load_hyp(by_port) == jcfg.load_hyp(by_port)
    assert yaml.safe_load(by_port.read_text()) == values
    assert tcfg.load_hyp(None) == jcfg.load_hyp(None)


@pytest.mark.parametrize("line", ["lr0: 1e-5", "lr0: fast", "lr0: [1, 2]", "  lr0: 0.1"])
def test_hyp_reader_refuses_what_is_not_a_flat_number(line, tmp_path):
    path = tmp_path / "h.yaml"
    path.write_text(line + "\n")
    with pytest.raises(ValueError):
        tcfg.load_hyp(path)


def test_run_helpers_match_jax():
    from skyeye_tpu.utils import autoanchor as jaa
    from skyeye_tpu.utils import general as jgen
    from skyeye_tpu_torch.utils import autoanchor as taa
    from skyeye_tpu_torch.utils import general as tgen

    rng = np.random.default_rng(0)
    labels = [np.column_stack([rng.integers(0, 5, n), rng.uniform(0.05, 0.9, (n, 4))])
              for n in (3, 0, 7, 2)]
    np.testing.assert_array_equal(tgen.labels_to_class_weights(labels, 6),
                                  jgen.labels_to_class_weights(labels, 6))
    wh = rng.uniform(4, 200, (60, 2))
    anchors = np.asarray(tcfg.DEFAULT_ANCHORS)
    assert taa.check_anchors(wh, anchors, (8, 16, 32)) == jaa.check_anchors(
        wh, anchors, (8, 16, 32))
    np.testing.assert_array_equal(taa.kmean_anchors(wh, n=9, iterations=30, seed=3),
                                  jaa.kmean_anchors(wh, n=9, iterations=30, seed=3))
    assert taa.anchor_fitness(wh, anchors[0] * 8) == jaa.anchor_fitness(wh, anchors[0] * 8)
