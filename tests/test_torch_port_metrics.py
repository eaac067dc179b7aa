"""The port's evaluation metrics against JAX's, on the same seeded arrays.

``skyeye_tpu_torch.utils.metrics`` and ``coco_eval`` are numpy copies of
``skyeye_tpu.utils.metrics`` and ``coco_eval``; every output must equal JAX's
to 1e-12 (box IoU, AP, the per-class AP table and its operating point, IoU
matching, the confusion matrix and its printout, the COCO eval's figures).
"""
import numpy as np
import pytest

from skyeye_tpu.utils import coco_eval as jax_coco
from skyeye_tpu.utils import metrics as jax_metrics
from skyeye_tpu_torch.utils import coco_eval, metrics

TOL = 1e-12
SEEDS = range(6)


def _boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def _image(rng, nc=4):
    """Labels (m, 5) [cls, xyxy] and detections (n, 6) [xyxy, conf, cls]: some
    jittered copies of labels (right and wrong class), some strays."""
    m = rng.randint(0, 12)
    labels = np.concatenate([rng.randint(0, nc, (m, 1)), _boxes(rng, m)], 1)
    copies = labels[rng.uniform(size=m) < 0.8]
    det_boxes = copies[:, 1:] + rng.normal(0, 4, (len(copies), 4))
    det_cls = np.where(rng.uniform(size=len(copies)) < 0.85, copies[:, 0],
                       rng.randint(0, nc, len(copies)))
    stray = rng.randint(0, 6)
    boxes = np.concatenate([det_boxes, _boxes(rng, stray)])
    cls = np.concatenate([det_cls, rng.randint(0, nc, stray)])
    conf = rng.uniform(0.001, 1.0, len(boxes))
    conf[rng.uniform(size=len(conf)) < 0.1] = 0.5  # ties
    det = np.concatenate([boxes, conf[:, None], cls[:, None]], 1).astype(np.float32)
    return det, labels.astype(np.float32)


def _stats(seed, n_images=20):
    rng = np.random.RandomState(seed)
    iouv = np.linspace(0.5, 0.95, 10)
    stats = []
    for _ in range(n_images):
        det, labels = _image(rng)
        correct = jax_metrics.process_batch(det, labels, iouv)
        stats.append((correct, det[:, 4], det[:, 5], labels[:, 0]))
    return [np.concatenate(s) for s in zip(*stats)]


@pytest.mark.parametrize("seed", SEEDS)
def test_box_iou_and_process_batch_match_jax(seed):
    rng = np.random.RandomState(seed)
    iouv = np.linspace(0.5, 0.95, 10)
    for _ in range(10):
        det, labels = _image(rng)
        np.testing.assert_allclose(metrics.box_iou_np(labels[:, 1:], det[:, :4]),
                                   jax_metrics.box_iou_np(labels[:, 1:], det[:, :4]),
                                   rtol=0, atol=TOL)
        np.testing.assert_array_equal(metrics.process_batch(det, labels, iouv),
                                      jax_metrics.process_batch(det, labels, iouv))


@pytest.mark.parametrize("seed", SEEDS)
def test_compute_ap_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 50)
    recall = np.sort(rng.uniform(0, 1, n))
    precision = rng.uniform(0, 1, n)
    for got, want in zip(metrics.compute_ap(recall, precision),
                         jax_metrics.compute_ap(recall, precision)):
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_ap_per_class_matches_jax(seed):
    tp, conf, pred_cls, target_cls = _stats(seed)
    got = metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    want = jax_metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert 0 < want[5].mean() < 1


def test_ap_per_class_plot_warns_and_returns_the_numbers(caplog, tmp_path):
    tp, conf, pred_cls, target_cls = _stats(0)
    got = metrics.ap_per_class(tp, conf, pred_cls, target_cls, plot=True, save_dir=tmp_path)
    want = jax_metrics.ap_per_class(tp, conf, pred_cls, target_cls)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert "ROADMAP.md" in caplog.text and not list(tmp_path.iterdir())


@pytest.mark.parametrize("seed", SEEDS)
def test_confusion_matrix_matches_jax(seed, capsys):
    rng = np.random.RandomState(seed)
    ours, theirs = metrics.ConfusionMatrix(nc=4), jax_metrics.ConfusionMatrix(nc=4)
    for i in range(15):
        det, labels = _image(rng)
        if i == 3:
            det = det[:0]  # no detections: every label a background FN
        if i == 4:
            det[:, 5] = 7  # classes the dataset does not have: dropped
        ours.process_batch(det, labels)
        theirs.process_batch(det, labels)
    np.testing.assert_array_equal(ours.matrix, theirs.matrix)
    for g, w in zip(ours.tp_fp(), theirs.tp_fp()):
        np.testing.assert_array_equal(g, w)
    ours.print()
    printed = capsys.readouterr().out
    theirs.print()
    assert printed == capsys.readouterr().out


def test_confusion_matrix_plot_warns(caplog, tmp_path):
    cm = metrics.ConfusionMatrix(nc=2)
    cm.plot(save_dir=tmp_path, names=["a", "b"])
    assert "ROADMAP.md" in caplog.text and not list(tmp_path.iterdir())


def _coco_lists(seed):
    rng = np.random.RandomState(seed)
    gt, dt = [], []
    for image_id in range(1, 13):
        det, labels = _image(rng)
        for cls, x1, y1, x2, y2 in labels.tolist():
            gt.append({"image_id": image_id, "category_id": int(cls),
                       "bbox": [x1, y1, x2 - x1, y2 - y1]})
        for x1, y1, x2, y2, conf, cls in det.tolist():
            dt.append({"image_id": image_id, "category_id": int(cls),
                       "bbox": [round(x1, 3), round(y1, 3), round(x2 - x1, 3),
                                round(y2 - y1, 3)], "score": round(conf, 5)})
    if seed % 2:
        gt[0]["iscrowd"] = 1
    return gt, dt


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("area_rng", ["all", "small", "medium"])
def test_evaluate_coco_matches_jax(seed, area_rng):
    gt, dt = _coco_lists(seed)
    got = coco_eval.evaluate_coco(gt, dt, area_rng=area_rng)
    want = jax_coco.evaluate_coco(gt, dt, area_rng=area_rng)
    for key in ("AP", "AP50", "AP75", "AR"):
        assert abs(got[key] - want[key]) <= TOL, key
    assert got["per_class"].keys() == want["per_class"].keys()
    for cat in want["per_class"]:
        assert abs(got["per_class"][cat] - want["per_class"][cat]) <= TOL


def test_gt_from_labels_matches_jax():
    rng = np.random.RandomState(0)
    labels = [np.concatenate([rng.randint(0, 3, (n, 1)), rng.uniform(0.1, 0.9, (n, 4))], 1)
              for n in (0, 3, 5)]
    shapes = [(640, 480), (200, 100), (33, 77)]
    assert coco_eval.gt_from_labels(labels, shapes) == jax_coco.gt_from_labels(labels, shapes)
