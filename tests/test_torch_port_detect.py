"""``skyeye_tpu_torch.cli.detect.run`` and the ``Results`` drawing methods against JAX's.

A narrow skyeye_s (base width 16, nc 6) from one seeded ``.pt`` that JAX's
``export_torch`` writes, served at 160 px on a folder of 3 JPEG frames and a
PNG (cv2-written, odd sizes). Both packages' ``cli.detect.run`` run with
``--save-txt --save-conf --save-crop``, and again with ``--classes`` and
``--agnostic-nms``; the port on the CPU (its plain NMS), JAX on the CPU
(its late cut with ``approx_max_k``, exact there, as the port's cut is):
- the same files, under the same names;
- ``labels/*.txt``: the same lines, classes equal, coordinates and
  confidences within 1e-4 relative;
- ``crops/<name>/*.jpg``: the same bytes (the crop arrays equal, tolerance 0,
  and the port's encoder writes cv2's bytes);
- annotated images, decoded by cv2: equal (tolerance 0) outside the label
  boxes and the outlines' anti-aliased fringe (``test_torch_port_visualization``'s
  rule), taken to whole 16x16 JPEG MCUs and one MCU around them (a pixel that
  differs changes its MCU's decode, and fancy upsampling reads the next MCU's
  chroma).
``predict_files`` (JAX's without its native library, the path the port
takes), ``Results.pandas``, ``render``, ``save`` and ``crop`` are held against
JAX's on the same files at the same tolerances.
"""
import logging
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import skyeye_tpu.data.native as jax_native
import skyeye_tpu.models.detector as jdet
from skyeye_tpu.api import SkyEyeDetector as JaxDetector
from skyeye_tpu.cli import detect as jax_detect
from skyeye_tpu.cli.export import export_torch
from skyeye_tpu_torch import SkyEyeDetector
from skyeye_tpu_torch.cli import detect as port_detect
from test_torch_port_visualization import fringe

NC, IMG = 6, 160
CFG = {"nc": NC, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5,
       "variant": "s"}
FRAMES = [((240, 400), "jpg"), ((320, 448), "jpg"), ((37, 53), "png"), ((400, 300), "jpg")]
REL = 1e-4
MCU = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _variables(module, seed):
    """Seeded weights for every flax leaf; the objectness and class biases set
    so that each frame has some ten boxes over a few classes at conf 0.25."""
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
        bias = flat[f"params/head/pred{level}/bias"].reshape(3, NC + 5)
        bias[:, 4] += np.log(8 / (640 / stride) ** 2) + 4.5
        bias[:, 5:] += np.log(0.6 / (NC - 0.99))
    return {k: v.astype(np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("detect")
    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG))
    flat = _variables(module, seed=5)
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})
    weights = root / "skyeye_s_narrow.pt"
    export_torch(module, tree, weights)
    src = root / "src"
    src.mkdir()
    rng = np.random.RandomState(7)
    for i, ((h, w), suffix) in enumerate(FRAMES):
        coarse = rng.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
        im = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_NEAREST)
        im = np.clip(im + rng.normal(0, 6, im.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(src / f"frame{i}.{suffix}"), im)
    return dict(root=root, weights=str(weights), src=src)


def _runs(setup, name, **kw):
    common = dict(weights=setup["weights"], source=str(setup["src"]), imgsz=(IMG, IMG),
                  save_txt=True, save_conf=True, save_crop=True, exist_ok=True, name=name, **kw)
    jax_dir = jax_detect.run(project=str(setup["root"] / "jax"), **common)
    port_dir = port_detect.run(project=str(setup["root"] / "port"), device="cpu", **common)
    return Path(jax_dir), Path(port_dir)


@pytest.fixture(scope="module")
def default_runs(setup):
    return _runs(setup, "default")


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _labels(path: Path):
    return np.loadtxt(path, ndmin=2)


def _boxes_of(label_rows, shape):
    """Pixel xyxy of normalized xywh label rows."""
    h, w = shape
    x, y, bw, bh = (label_rows[:, i] for i in range(1, 5))
    return np.stack([(x - bw / 2) * w, (y - bh / 2) * h, (x + bw / 2) * w, (y + bh / 2) * h], 1)


def _mcu_mask(mask):
    """Each 16x16 MCU that holds a pixel of mask, and one MCU around it."""
    h, w = mask.shape
    gh, gw = -(-h // MCU), -(-w // MCU)
    grid = np.zeros((gh * MCU, gw * MCU), bool)
    grid[:h, :w] = mask
    cells = grid.reshape(gh, MCU, gw, MCU).any(axis=(1, 3))
    grown = cells.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grown |= np.roll(np.roll(cells, dy, 0), dx, 1) & _in_bounds(cells.shape, dy, dx)
    return grown.repeat(MCU, 0).repeat(MCU, 1)[:h, :w]


def _in_bounds(shape, dy, dx):
    ok = np.ones(shape, bool)
    if dy > 0:
        ok[:dy] = False
    elif dy < 0:
        ok[dy:] = False
    if dx > 0:
        ok[:, :dx] = False
    elif dx < 0:
        ok[:, dx:] = False
    return ok


def _drawn_mask(shape, dets, names, lw):
    """The pixels where the two packages' drawings may differ, for detections
    (x1, y1, x2, y2, conf, cls), widened by a pixel: boxes read back from the
    label files' 6 digits may land a pixel off."""
    mask = np.zeros(shape, bool)
    for x1, y1, x2, y2, conf, cls in dets:
        mask |= fringe(shape, [x1, y1, x2, y2], lw, f"{names[int(cls)]} {conf:.2f}")
    grown = mask.copy()
    grown[1:] |= mask[:-1]
    grown[:-1] |= mask[1:]
    grown[:, 1:] |= grown[:, :-1].copy()
    grown[:, :-1] |= grown[:, 1:].copy()
    return grown


def _hold_runs(jax_dir, port_dir, src, lw=3):
    assert _files(port_dir) == _files(jax_dir)
    label_files = sorted((jax_dir / "labels").glob("*.txt"))
    assert label_files, "no detections at all: the seeded head is off"
    names = [str(i) for i in range(NC)]
    for f in label_files:
        want, got = _labels(f), _labels(port_dir / "labels" / f.name)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=REL, atol=0)
    for f in sorted((jax_dir / "crops").rglob("*.jpg")):
        assert (port_dir / f.relative_to(jax_dir)).read_bytes() == f.read_bytes(), f
    compared = 0
    for f in sorted(src.iterdir()):
        want = cv2.imread(str(jax_dir / f.name))
        got = cv2.imread(str(port_dir / f.name))
        assert got.shape == want.shape == cv2.imread(str(f)).shape
        rows = _labels(jax_dir / "labels" / f"{f.stem}.txt") if (
            jax_dir / "labels" / f"{f.stem}.txt").exists() else np.zeros((0, 6))
        dets = np.concatenate([_boxes_of(rows, want.shape[:2]), rows[:, 5:6], rows[:, :1]], 1)
        mask = _drawn_mask(want.shape[:2], dets, names, lw)
        if f.suffix == ".jpg":
            mask = _mcu_mask(mask)
        compared += (~mask).sum()
        np.testing.assert_array_equal(got[~mask], want[~mask], err_msg=f.name)
    assert compared > 10000, "the comparison covers too few pixels"


def test_detect_matches_jax(default_runs, setup):
    jax_dir, port_dir = default_runs
    assert sum(len(_labels(p)) for p in (jax_dir / "labels").glob("*.txt")) >= 8
    assert len({int(c) for p in (jax_dir / "labels").glob("*.txt")
                for c in _labels(p)[:, 0]}) >= 2
    _hold_runs(jax_dir, port_dir, setup["src"])


def test_detect_with_classes_and_agnostic_nms_matches_jax(setup, default_runs):
    """One class kept (the rarer of the default run's), class-blind NMS, and
    thinner lines."""
    seen = np.concatenate([_labels(p)[:, 0] for p in (default_runs[0] / "labels").glob("*.txt")])
    values, counts = np.unique(seen.astype(int), return_counts=True)
    classes = [int(values[np.argmin(counts)])]
    jax_dir, port_dir = _runs(setup, "classes", classes=classes, agnostic_nms=True,
                              line_thickness=2)
    for p in (port_dir / "labels").glob("*.txt"):
        assert set(_labels(p)[:, 0].astype(int)) <= set(classes)
    _hold_runs(jax_dir, port_dir, setup["src"], lw=2)


def test_detect_logs_and_refusals(setup, caplog, tmp_path):
    caplog.set_level(logging.INFO, logger="skyeye_tpu_torch")
    out = port_detect.run(weights=setup["weights"], source=str(setup["src"] / "frame0.jpg"),
                          imgsz=(IMG, IMG), project=str(tmp_path), name="one", device="cpu",
                          nosave=True, exact_nms=True, augment=True, visualize=True, update=True)
    assert not any(p.is_file() for p in Path(out).rglob("*"))  # nothing to save
    text = caplog.text
    assert "image 1/1 " in text and "Speed: " in text and "(1, 3, 160, 160)" in text
    opt = port_detect.parse_opt(["--source", "x", "--img-size", "320", "--classes", "0", "2"])
    assert opt.imgsz == [320, 320] and opt.classes == [0, 2] and opt.device == "cuda"
    for kw in ({"view_img": True}, {"source": "0"}, {"source": "rtsp://camera/1"}):
        args = {"weights": setup["weights"], "source": str(setup["src"]),
                "project": str(tmp_path), "device": "cpu", **kw}
        with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1 item 14"):
            port_detect.run(**args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_detect.run(weights=setup["weights"], source=str(setup["src"]),
                            project=str(tmp_path))


@pytest.fixture(scope="module")
def results(setup):
    paths = [str(p) for p in sorted(setup["src"].iterdir())]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "native_available", lambda: False)
    try:
        jax_res = JaxDetector(weights=setup["weights"], img_size=IMG).predict_files(paths)
    finally:
        mp.undo()
    port_res = SkyEyeDetector(weights=setup["weights"], img_size=IMG,
                              device="cpu").predict_files(paths)
    return jax_res, port_res


def test_predict_files_and_pandas_match_jax(results):
    jax_res, port_res = results
    assert port_res.paths == jax_res.paths and len(port_res) == len(jax_res)
    assert sum(len(d) for d in jax_res.xyxy) >= 8
    for g, w in zip(port_res.xyxy, jax_res.xyxy):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :5], w[:, :5], rtol=REL, atol=1e-3)
    for g, w in zip(port_res.pandas(), jax_res.pandas()):
        assert list(g.columns) == list(w.columns)
        assert list(g["name"]) == list(w["name"])
        np.testing.assert_allclose(g.iloc[:, :6].to_numpy(float), w.iloc[:, :6].to_numpy(float),
                                   rtol=REL, atol=1e-3)


def test_render_save_and_crop_match_jax(results, tmp_path):
    jax_res, port_res = results
    rendered = port_res.render()
    for i, (g, w) in enumerate(zip(rendered, jax_res.render())):
        lw = max(round(sum(w.shape[:2]) / 2 * 0.003), 2)
        mask = _drawn_mask(w.shape[:2], jax_res.xyxy[i], jax_res.names, lw)
        np.testing.assert_array_equal(g[~mask], w[~mask])
    saved = port_res.save(tmp_path / "port")
    want_saved = jax_res.save(tmp_path / "jax")
    assert [p.name for p in saved] == [p.name for p in want_saved]
    for i, (g, w) in enumerate(zip(saved, want_saved)):
        got, want = cv2.imread(str(g)), cv2.imread(str(w))
        lw = max(round(sum(want.shape[:2]) / 2 * 0.003), 2)
        mask = _drawn_mask(want.shape[:2], jax_res.xyxy[i], jax_res.names, lw)
        if g.suffix == ".jpg":
            mask = _mcu_mask(mask)
        np.testing.assert_array_equal(got[~mask], want[~mask], err_msg=g.name)
    got_crops = port_res.crop(tmp_path / "port_crops")
    want_crops = jax_res.crop(tmp_path / "jax_crops")
    assert len(got_crops) == len(want_crops) > 0
    for g, w in zip(got_crops, want_crops):
        np.testing.assert_array_equal(g, w)
    assert _files(tmp_path / "port_crops") == _files(tmp_path / "jax_crops")
    for f in (tmp_path / "jax_crops").rglob("*.jpg"):
        assert (tmp_path / "port_crops" / f.relative_to(tmp_path / "jax_crops")).read_bytes() \
            == f.read_bytes()
    port_res.show()  # logs that the port has no display, as JAX does without one
