"""The port's validation end to end against JAX's, on the same weights and files.

skyeye_s at base width 16 (nc 4) with seeded weights, carried to the port by
``utils/checkpoint.py::from_jax_variables``; 10 PNG frames of mixed aspect
written with cv2, labelled from JAX's own detections at conf 0.25 on them
(boxes jittered by a few seeded pixels, a fifth dropped, two strays added an
image), so that the mAP is neither 0 nor 1. ``skyeye_tpu_torch.cli.validate``
(``device="cpu"``) and ``skyeye_tpu.cli.validate`` (its native C++ decoder
switched off, so that both decode and resize as the Python path does) run in the
reference protocol at conf 0.001, IoU 0.6, multi-label, max_nms 8192, square
and rect. Tolerances: per image the same detection count, and one to one the
same class, the box within 1e-3 px and the score within 1e-5 (detections whose
scores lie within float32 noise of each other may swap places); P, R, mAP@.5, mAP@.5:.95 and the
per-class maps within 1e-4; the txt and JSON dumps at those tolerances; COCO
AP and AP50 within 1e-4. At ``rect=False`` both also run on their native
paths (JAX's C++ library, the port's ``data/native.py``), at the same
tolerances.
"""
import json
import logging
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import skyeye_tpu.cli.validate as jax_validate
import skyeye_tpu.data.native as jax_native
import skyeye_tpu.models.detector as jdet
import skyeye_tpu_torch.data.native as port_native
from skyeye_tpu.api import SkyEyeDetector as JaxDetector
from skyeye_tpu.cli.export import export_torch
from skyeye_tpu_torch.cli import validate as port_validate
from skyeye_tpu_torch.models.detector import create_detector
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables, save_model

NC = 4
CFG = {"nc": NC, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5,
       "variant": "s"}
SHAPES = [(120, 200), (120, 200), (150, 200), (200, 150), (160, 160), (90, 240),
          (200, 130), (140, 190), (256, 200), (100, 180)]
IMG, BATCH = 160, 4
BOX_TOL, SCORE_TOL, METRIC_TOL = 1e-3, 1e-5, 1e-4
OBJ_BIAS, JITTER = -2.4, 2.0  # objectness logit shift of the seeded head; label jitter, px


def _variables(module, seed):
    """Seeded numpy weights for every flax leaf. The head's objectness bias sits
    where some 60-70 boxes an image clear conf 0.25 (the labels' source)."""
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
    for level in range(3):
        flat[f"params/head/pred{level}/bias"].reshape(3, NC + 5)[:, 4] += OBJ_BIAS
    return {k: v.astype(np.float32) for k, v in flat.items()}


def _write_images(root: Path, rng):
    (root / "images" / "val").mkdir(parents=True)
    (root / "labels" / "val").mkdir(parents=True)
    for i, (h, w) in enumerate(SHAPES):
        coarse = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
        im = np.ascontiguousarray(coarse.repeat(8, 0).repeat(8, 1)[:h, :w])
        cv2.imwrite(str(root / "images" / "val" / f"im{i:02d}.png"), im)


def _write_labels(root: Path, detector, rng):
    """Labels from the detector's boxes at conf 0.25, jittered, some dropped,
    two strays added an image."""
    n_labels = []
    for i, (h, w) in enumerate(SHAPES):
        frame = cv2.imread(str(root / "images" / "val" / f"im{i:02d}.png"))
        lines = []
        for x1, y1, x2, y2, _, cls in detector(frame).xyxy[0]:
            # boxes the facade clipped to the frame are slivers: not labels
            if rng.uniform() < 0.2 or min(x1, y1) <= 0 or x2 >= w or y2 >= h:
                continue
            x1, y1, x2, y2 = np.clip(np.array([x1, y1, x2, y2]) + rng.normal(0, JITTER, 4), 0,
                                     [w, h, w, h])
            if x2 - x1 >= 1 and y2 - y1 >= 1:
                lines.append(f"{int(cls)} {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} "
                             f"{(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f}")
        for _ in range(2):
            cx, cy, bw, bh = rng.uniform(0.2, 0.8, 2).tolist() + rng.uniform(0.05, 0.3, 2).tolist()
            lines.append(f"{rng.randint(NC)} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (root / "labels" / "val" / f"im{i:02d}.txt").write_text("\n".join(lines) + "\n")
        n_labels.append(len(lines))
    return n_labels


def _recording(module):
    """Wrap ``module.process_batch`` so each image's (detections, labels) is kept."""
    seen, real = [], module.process_batch

    def record(detections, labels, iouv):
        seen.append((np.array(detections), np.array(labels)))
        return real(detections, labels, iouv)

    return seen, record


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("valset")
    rng = np.random.RandomState(0)
    _write_images(root, rng)
    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG))
    flat = _variables(module, seed=3)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    mp = pytest.MonkeyPatch()
    mp.setattr(jdet, "create_detector", lambda *a, **k: (module, variables))
    try:
        detector = JaxDetector(cfg=CFG, img_size=IMG, conf_thres=0.25, approx_topk=False)
    finally:
        mp.undo()
    n_labels = _write_labels(root, detector, rng)
    assert sum(n_labels) > 5 * len(SHAPES), n_labels
    port_model = create_detector(CFG, device="cpu")
    port_model.load_state_dict(from_jax_variables(flat), strict=True)
    data = {"path": str(root), "val": "images/val", "nc": NC,
            "names": [f"class{i}" for i in range(NC)]}
    return dict(root=root, module=module, variables=variables, port_model=port_model,
                data=data)


def _run_jax(bench, tmp_path_factory, native=False, **kw):
    """JAX's validate; ``native``: its loader's native path (where its library
    loads) or, by default, its Python path."""
    mp = pytest.MonkeyPatch()
    if not native:
        mp.setattr(jax_native, "native_available", lambda: False)
    seen, record = _recording(jax_validate)
    mp.setattr(jax_validate, "process_batch", record)
    save_dir = tmp_path_factory.mktemp("jax_val")
    try:
        out = jax_validate.validate(bench["data"], batch_size=BATCH, img_size=IMG, plots=False,
                                    save_txt=True, save_json=True, save_dir=save_dir,
                                    project=str(save_dir), name="exp", **kw)
    finally:
        mp.undo()
    return out, seen, save_dir if "model" in kw else save_dir / "exp"


def _run_port(tmp_path_factory, data, native=False, **kw):
    mp = pytest.MonkeyPatch()
    mp.setattr(port_native, "ENABLED", native)
    seen, record = _recording(port_validate)
    mp.setattr(port_validate, "process_batch", record)
    save_dir = tmp_path_factory.mktemp("port_val")
    try:
        out = port_validate.validate(data, batch_size=BATCH, img_size=IMG, plots=False,
                                     save_txt=True, save_json=True, save_dir=save_dir,
                                     project=str(save_dir), name="exp", device="cpu", **kw)
    finally:
        mp.undo()
    return out, seen, save_dir if "model" in kw else save_dir / "exp"


def _one_to_one(got, want, exact, tol):
    """Each row of ``got`` has its own row of ``want`` equal in the ``exact``
    columns and within ``tol`` (one per other column) elsewhere. Rows whose
    scores lie within float32 noise of each other (1e-7 apart here) may come in
    either order: the two frameworks' convolutions differ in the last bits."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    rest = [c for c in range(got.shape[1]) if c not in exact]
    free = np.ones(len(want), bool)
    for row in got:
        ok = free & (want[:, exact] == row[exact]).all(axis=1) & (
            np.abs(want[:, rest] - row[rest]) <= np.asarray(tol)).all(axis=1)
        assert ok.any(), f"no counterpart for {row}"
        free[np.argmax(ok)] = False


def _hold(got, want):
    (g_res, g_maps, g_speed), g_seen, g_dir = got
    (w_res, w_maps, _), w_seen, w_dir = want
    assert len(g_res) == len(w_res) == 7 and g_res[4:] == (0.0, 0.0, 0.0)
    np.testing.assert_allclose(np.array(g_res[:4], float), np.array(w_res[:4], float),
                               rtol=0, atol=METRIC_TOL)
    assert 0 < w_res[2] < 1 and 0 < w_res[3] < 1, w_res  # neither 0 nor 1
    np.testing.assert_allclose(g_maps, w_maps, rtol=0, atol=METRIC_TOL)
    assert all(np.isfinite(g_speed)) and g_speed[2] > 0

    assert len(g_seen) == len(w_seen) == len(SHAPES)
    for (gd, gl), (wd, wl) in zip(g_seen, w_seen):
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd[:, 4], wd[:, 4], rtol=0, atol=SCORE_TOL)
        _one_to_one(gd, wd, [5], [BOX_TOL] * 4 + [SCORE_TOL])
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-6)

    g_txt = sorted((g_dir / "labels").glob("*.txt"))
    assert [p.name for p in g_txt] == [p.name for p in sorted((w_dir / "labels").glob("*.txt"))]
    for p in g_txt:
        # normalized xywh with 6 significant digits, of canvases 90 px or more
        _one_to_one(np.loadtxt(p, ndmin=2), np.loadtxt(w_dir / "labels" / p.name, ndmin=2),
                    [0], [BOX_TOL / 90 + 1e-6] * 4)

    g_json = json.loads((g_dir / "predictions.json").read_text())
    w_json = json.loads((w_dir / "predictions.json").read_text())
    rows = [[[d["image_id"], d["category_id"], *d["bbox"], d["score"]] for d in dump]
            for dump in (g_json, w_json)]
    # both round to 3 and 5 decimals: at most one rounding step further apart
    _one_to_one(*rows, [0, 1], [BOX_TOL + 1e-3 + 1e-9] * 4 + [SCORE_TOL + 1e-5 + 1e-12])
    g_coco = json.loads((g_dir / "coco_eval.json").read_text())
    w_coco = json.loads((w_dir / "coco_eval.json").read_text())
    for key in ("AP", "AP50", "AP75", "AR"):
        assert abs(g_coco[key] - w_coco[key]) <= METRIC_TOL, key


def test_default_validate_on_both_native_paths_matches_jax(bench, tmp_path_factory, monkeypatch):
    """The CLIs' default, ``rect=False``: both loaders decode and letterbox in
    their native prep (no INTER_AREA pre-resize), one call a batch."""
    calls = {"jax": 0, "port": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(jax_native, "prep_batch", counted("jax", jax_native.prep_batch))
    monkeypatch.setattr(port_native, "prep_batch", counted("port", port_native.prep_batch))
    want = _run_jax(bench, tmp_path_factory, native=True, rect=False,
                    model=(bench["module"], bench["variables"], bench["module"].config))
    got = _run_port(tmp_path_factory, bench["data"], native=True, rect=False,
                    model=bench["port_model"])
    assert calls["jax"] == calls["port"] == -(-len(SHAPES) // BATCH)
    _hold(got, want)


@pytest.mark.parametrize("rect", [False, True], ids=["square", "rect"])
def test_validate_matches_jax(bench, tmp_path_factory, rect):
    want = _run_jax(bench, tmp_path_factory, rect=rect,
                    model=(bench["module"], bench["variables"], bench["module"].config))
    got = _run_port(tmp_path_factory, bench["data"], rect=rect, model=bench["port_model"])
    _hold(got, want)
    # the multi-label cut hands K1 every candidate at conf 0.001: 3 x 525 anchors x 4
    # classes per image at 160 px, under max_nms 8192
    assert max(len(d) for d, _ in got[1]) > 50


def test_validate_through_a_weights_file_matches_jax(bench, tmp_path_factory):
    """weights= a reference-layout .pt (written by JAX's export_torch): both load it
    and fold BatchNorm."""
    pt = export_torch(bench["module"], bench["variables"],
                      tmp_path_factory.mktemp("weights") / "skyeye_s.pt")
    want = _run_jax(bench, tmp_path_factory, rect=False, weights=str(pt))
    got = _run_port(tmp_path_factory, bench["data"], rect=False, weights=str(pt))
    _hold(got, want)


def test_pipeline_depth_and_the_cli_give_the_same_figures(bench, tmp_path_factory, caplog):
    first = _run_port(tmp_path_factory, bench["data"], rect=True, model=bench["port_model"])
    synchronous = _run_port(tmp_path_factory, bench["data"], rect=True,
                            model=bench["port_model"], pipeline_depth=1)
    np.testing.assert_array_equal(np.array(first[0][0]), np.array(synchronous[0][0]))
    # the port's own .pt (save_model), read back by weights= and BN-folded
    pt = save_model(bench["port_model"], tmp_path_factory.mktemp("cli") / "skyeye_s.pt")
    yaml_path = bench["root"] / "data.yaml"
    yaml_path.write_text(f"path: {bench['root']}\nval: images/val\nnc: {NC}\n"
                         f"names: [{', '.join(f'class{i}' for i in range(NC))}]\n")
    caplog.set_level(logging.INFO)
    res, maps, _ = port_validate.main(
        ["--data", str(yaml_path), "--weights", str(pt), "--img-size", str(IMG),
         "--batch-size", str(BATCH), "--rect", "--device", "cpu", "--no-plots",
         "--project", str(tmp_path_factory.mktemp("cli_runs"))])
    np.testing.assert_allclose(np.array(res[:4], float), np.array(first[0][0][:4], float),
                               rtol=0, atol=METRIC_TOL)
    assert "Speed:" in caplog.text and "mAP@.5" in caplog.text


def test_left_out_arguments_and_a_missing_card_raise(bench):
    for kw, pattern in (({"paced_ingest_ms": 1.0}, "relay"),
                        ({"approx_topk": True}, "approximate")):
        with pytest.raises(NotImplementedError, match=pattern):
            port_validate.validate(bench["data"], model=bench["port_model"], device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_validate.validate(bench["data"], model=bench["port_model"])
