"""Tiled 4K inference in the PyTorch port against the JAX package's.

``tile_grid`` and ``slice_tiles`` must be equal; ``merge_tile_detections`` and
``detect_tiled`` index for index: counts and classes equal, in keep order,
scores within 1e-6 (merge: the same float32 values) or 1e-4 (end to end: a
small network's float32 forward, as ``tests/test_torch_port_slice.py``), boxes
within 1e-4 px (merge) or 1e-2 px (end to end). The port's K1 wrapper runs
its plain version on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.models import detector as jdet
from skyeye_tpu.ops import tiling as jtiling
from skyeye_tpu_torch.models import detector as tdet
from skyeye_tpu_torch.ops import tiling as ttiling
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables


@pytest.mark.parametrize("hw,tile,overlap", [
    ((2160, 3840), 1280, 0.2),   # the served 4K frame: 2 x 4 tiles
    ((640, 640), 1280, 0.2),     # smaller than a tile
    ((100, 300), 64, 0.25),
    ((1080, 1920), 640, 0.5),
    ((64, 96), 64, 0.0),
])
def test_tile_grid_equals_jax(hw, tile, overlap):
    np.testing.assert_array_equal(ttiling.tile_grid(hw, tile, overlap),
                                  jtiling.tile_grid(hw, tile, overlap))
    assert ttiling.tile_grid(hw, tile, overlap).dtype == np.int32


def test_served_grid_has_eight_tiles():
    assert ttiling.tile_grid((2160, 3840), 1280, 0.2).shape == (8, 2)


def test_slice_tiles_equals_jax():
    frames = np.random.RandomState(0).randint(0, 256, (2, 20, 30, 3)).astype(np.uint8)
    origins = jtiling.tile_grid((20, 30), 12, 0.25)
    ref = np.asarray(jtiling.slice_tiles(jnp.asarray(frames), origins, 12))
    got = ttiling.slice_tiles(torch.from_numpy(frames), origins, 12).numpy()
    np.testing.assert_array_equal(got, ref)


def _tile_detections(seed, t, b, md):
    """Per-tile detections in tile pixels, sorted by score as NMS leaves them,
    with a count per tile; boxes clustered so tiles overlap in frame space."""
    rng = np.random.RandomState(seed)
    det = np.zeros((t * b, md, 6), np.float32)
    n = rng.randint(0, md + 1, t * b).astype(np.int32)
    n[1] = 0  # an empty tile
    for i in range(t * b):
        c = rng.uniform(0, 48, (md, 2))
        wh = rng.uniform(4, 20, (md, 2))
        det[i, :, :2], det[i, :, 2:4] = c - wh / 2, c + wh / 2
        det[i, :, 4] = np.sort(rng.uniform(0.05, 1, md))[::-1]
        det[i, :, 5] = rng.randint(0, 3, md)
        det[i, n[i]:] = rng.normal(0, 5, (md - n[i], 6))  # garbage past the count
    det[0, 3, 4] = det[0, 2, 4]  # a tied score
    return det, n


@pytest.mark.parametrize("iou,max_det", [(0.45, 40), (0.3, 8), (0.7, 200)])
def test_merge_tile_detections_matches_jax(iou, max_det):
    origins = jtiling.tile_grid((64, 96), 48, 0.3)
    t, b, md = origins.shape[0], 2, 30
    det, n = _tile_detections(int(iou * 100), t, b, md)
    ref = jtiling.merge_tile_detections(jnp.asarray(det), jnp.asarray(n), origins, batch=b,
                                        iou_thres=iou, max_det=max_det)
    got = ttiling.merge_tile_detections(torch.from_numpy(det), torch.from_numpy(n), origins,
                                        batch=b, iou_thres=iou, max_det=max_det)
    (rd, rn), (gd, gn) = [np.asarray(r) for r in ref], [g.numpy() for g in got]
    np.testing.assert_array_equal(gn, rn)
    assert gn.dtype == np.int32 and gd.shape == rd.shape == (b, max_det, 6)
    np.testing.assert_array_equal(gd[..., 5], rd[..., 5])
    np.testing.assert_allclose(gd[..., 4], rd[..., 4], rtol=0, atol=1e-6)
    np.testing.assert_allclose(gd[..., :4], rd[..., :4], rtol=0, atol=1e-4)


def _variables(module, seed, nc):
    """Seeded weights for every flax leaf; the head's obj/cls biases where YOLOv5
    puts them, so detections are sparse, as a trained detector's."""
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
    for level, stride in enumerate((8, 16, 32)):
        bias = flat[f"params/head/pred{level}/bias"].reshape(3, nc + 5)
        bias[:, 4] += np.log(8 / (640 / stride) ** 2)
        bias[:, 5:] += np.log(0.6 / (nc - 0.99))
    return {k: v.astype(np.float32) for k, v in flat.items()}


def test_detect_tiled_matches_jax_end_to_end():
    """Two frames of 80 x 112 in tiles of 64 at overlap 0.25 (2 x 3 tiles each),
    a small detector on the same weights on both sides."""
    cfg = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.25}
    jmod = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(cfg))
    flat = _variables(jmod, 7, cfg["nc"])
    jvars = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                          for k, v in flat.items()})
    tmod = tdet.create_detector(cfg, device="cpu")
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    rng = np.random.RandomState(8)
    frames = (rng.randint(0, 8, (2, 10, 14, 3)) * 32 + 16).astype(np.uint8)
    frames = frames.repeat(8, axis=1).repeat(8, axis=2)  # blocks: structure, not noise
    kw = dict(tile=64, overlap=0.25, conf_thres=0.01, iou_thres=0.45, max_det=50,
              max_det_tile=40)
    ref = jtiling.detect_tiled(jmod, jvars, tmod.config.anchors, jnp.asarray(frames), **kw)
    got = ttiling.detect_tiled(tmod, tmod.config.anchors, torch.from_numpy(frames), **kw)
    (rd, rn), (gd, gn) = [np.asarray(r) for r in ref], [g.numpy() for g in got]
    assert gd.shape == (2, 50, 6) and gn.sum() > 0
    np.testing.assert_array_equal(gn, rn)
    np.testing.assert_array_equal(gd[..., 5], rd[..., 5])
    np.testing.assert_allclose(gd[..., 4], rd[..., 4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gd[..., :4], rd[..., :4], rtol=0, atol=1e-2)


def test_detect_tiled_reports_its_stages_in_order():
    cfg = {"nc": 3, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.25}
    tmod = tdet.create_detector(cfg, device="cpu")
    frames = torch.zeros((1, 64, 96, 3), dtype=torch.uint8)
    seen = []
    det, n = ttiling.detect_tiled(tmod, tmod.config.anchors, frames, tile=64, overlap=0.25,
                                  max_det=32, max_det_tile=32, on_stage=seen.append)
    assert seen == ["slice", "model", "decode", "nms", "merge"]
    assert tuple(det.shape) == (1, 32, 6) and n.dtype == torch.int32
