"""Greedy NMS of the PyTorch port against the JAX package, index for index.

The port's plain K1/K2 (skyeye_tpu_torch/ops/nms_kernel.py, what a CPU tensor
runs) must keep the same indices in the same order as
``skyeye_tpu.ops.nms._greedy_nms`` and as the Pallas kernels run in interpret
mode; the full NMS (cut + suppression) must equal JAX's ``approx_topk=False``
path. Inputs are made with numpy from a seed and fed to both packages.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyeye_tpu.ops import nms as jnms
from skyeye_tpu.ops.pallas.nms_kernel import pallas_batched_greedy_nms, pallas_greedy_nms
from skyeye_tpu_torch.ops import nms as tnms
from skyeye_tpu_torch.ops import nms_kernel


def _candidates(rng, b, k, n_cls=4, invalid_frac=0.3):
    """Clustered class-offset boxes, so suppression happens often, and scores
    with a share of invalid (-1) slots."""
    centers = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    centers = np.round(centers / 40) * 40 + rng.normal(0, 6, (b, k, 2))
    wh = rng.uniform(20, 80, (b, k, 2))
    cls = rng.randint(0, n_cls, (b, k))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    boxes = (boxes + (cls * 7680.0)[..., None]).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, (b, k)).astype(np.float32)
    scores[rng.uniform(size=(b, k)) < invalid_frac] = -1.0
    return boxes, scores


def _special_cases():
    """An all-invalid row, identical boxes, and tied scores."""
    rng = np.random.RandomState(3)
    boxes, scores = _candidates(rng, 5, 200)
    scores[1] = -1.0                                   # all invalid
    boxes[2, :50] = boxes[2, 0]                        # identical boxes
    scores[3, :60] = np.float32(0.5)                   # ties, overlapping and not
    boxes[3, 30:60] = boxes[3, :30]
    scores[4] = np.float32(0.7)                        # every score tied
    return boxes, scores


CASES = {
    # name: (B, k, iou, max_det)
    "k1000_b3": (3, 1000, 0.45, 100),
    "k300_b5_iou07": (5, 300, 0.7, 64),
    "k130_b9": (9, 130, 0.45, 32),
    "k1_b1": (1, 1, 0.45, 4),
}


def _case(name):
    if name == "special":
        boxes, scores = _special_cases()
        return boxes, scores, 0.5, 48
    b, k, iou, md = CASES[name]
    boxes, scores = _candidates(np.random.RandomState(sum(map(ord, name))), b, k)
    return boxes, scores, iou, md


ALL = list(CASES) + ["special"]


def _jax_lax(boxes, scores, iou, md):
    idx, valid = jax.vmap(lambda b, s: jnms._greedy_nms(b, s, iou, md))(
        jnp.asarray(boxes), jnp.asarray(scores))
    return np.asarray(idx), np.asarray(valid)


@pytest.mark.parametrize("name", ALL)
def test_plain_batched_matches_jax_greedy(name):
    boxes, scores, iou, md = _case(name)
    idx, valid = nms_kernel.batched_greedy_nms_plain(torch.from_numpy(boxes),
                                                     torch.from_numpy(scores), iou, md)
    ref_idx, ref_valid = _jax_lax(boxes, scores, iou, md)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool


@pytest.mark.parametrize("name", ["k1000_b3", "k130_b9", "special"])
def test_plain_batched_matches_pallas_batched_interpret(name):
    boxes, scores, iou, md = _case(name)
    idx, valid = nms_kernel.batched_greedy_nms_plain(torch.from_numpy(boxes),
                                                     torch.from_numpy(scores), iou, md)
    ref_idx, ref_valid = pallas_batched_greedy_nms(
        jnp.asarray(boxes), jnp.asarray(scores), max_det=md, iou_thres=iou, interpret=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("row", [0, 1, 2, 3, 4])
def test_plain_single_matches_pallas_single_interpret(row):
    boxes, scores, iou, md = _case("special")
    idx, valid = nms_kernel.greedy_nms_plain(torch.from_numpy(boxes[row]),
                                             torch.from_numpy(scores[row]), iou, md)
    ref_idx, ref_valid = pallas_greedy_nms(jnp.asarray(boxes[row]), jnp.asarray(scores[row]),
                                           max_det=md, iou_thres=iou, interpret=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    lax_idx, lax_valid = jnms._greedy_nms(jnp.asarray(boxes[row]), jnp.asarray(scores[row]),
                                          iou, md)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(lax_idx))


def test_wrappers_run_the_plain_version_on_cpu_without_counting():
    boxes, scores, iou, md = _case("k300_b5_iou07")
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    nms_kernel.reset_launch_counts()
    idx, valid = nms_kernel.batched_greedy_nms(tb, ts, iou, md)
    ref_idx, ref_valid = nms_kernel.batched_greedy_nms_plain(tb, ts, iou, md)
    assert torch.equal(idx, ref_idx) and torch.equal(valid, ref_valid)
    idx1, valid1 = nms_kernel.greedy_nms(tb[2], ts[2], iou, md)
    assert torch.equal(idx1, ref_idx[2]) and torch.equal(valid1, ref_valid[2])
    assert nms_kernel.LAUNCHES == {"batched_greedy_nms": 0, "greedy_nms": 0}


def test_candidate_limit_matches_the_kernel_source():
    """The wrapper's MAX_CANDIDATES is what csrc/nms.cu holds per image."""
    src = (Path(nms_kernel.__file__).resolve().parent.parent / "csrc" / "nms.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    items = int(re.search(r"constexpr int kMaxItems = (\d+);", src).group(1))
    assert nms_kernel.MAX_CANDIDATES == threads * items


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    boxes, scores = _candidates(np.random.RandomState(0), 2, 8)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    if bad == "dtype":
        tb = tb.double()
    elif bad == "shape":
        ts = ts[:, :7]
    elif bad == "contiguity":
        tb = torch.from_numpy(np.ascontiguousarray(boxes.transpose(1, 0, 2))).transpose(0, 1)
    else:
        tb, ts = tb[0], ts[0]
    with pytest.raises((TypeError, ValueError)):
        nms_kernel.batched_greedy_nms(tb, ts, 0.45, 10)


def _decoded(seed, b=3, n=700, nc=5):
    """Decoded predictions (B, N, 5 + nc): clustered xywh, post-sigmoid obj/cls."""
    rng = np.random.RandomState(seed)
    xy = np.round(rng.uniform(0, 320, (b, n, 2)) / 24) * 24 + rng.normal(0, 4, (b, n, 2))
    wh = rng.uniform(8, 60, (b, n, 2))
    obj = rng.uniform(0, 1, (b, n, 1)) ** 0.5
    cls = rng.uniform(0, 1, (b, n, nc))
    pred = np.concatenate([xy, wh, obj, cls], -1).astype(np.float32)
    pred[:, :5, 5:] = pred[:, :1, 5:]                     # tied class scores
    return pred


NMS_MODES = [
    dict(multi_label=False, agnostic=False),
    dict(multi_label=True, agnostic=False),
    dict(multi_label=False, agnostic=True),
    dict(multi_label=False, agnostic=False, classes=(1, 3)),
    dict(multi_label=True, agnostic=False, classes=(0, 2, 4)),
]


@pytest.mark.parametrize("mode", range(len(NMS_MODES)))
@pytest.mark.parametrize("conf,max_nms", [(0.25, 1024), (0.001, 4096)])
def test_nms_batched_matches_jax_exact_cut(mode, conf, max_nms):
    kw = dict(NMS_MODES[mode])
    classes = kw.pop("classes", None)
    pred = _decoded(10 + mode)
    nc = pred.shape[-1] - 5
    jmask = tmask = None
    if classes is not None:
        jmask = jnp.zeros((nc,), bool).at[jnp.asarray(classes)].set(True)
        tmask = torch.zeros(nc, dtype=torch.bool)
        tmask[list(classes)] = True
    ref_det, ref_n = jnms.nms_batched(jnp.asarray(pred), conf_thres=conf, iou_thres=0.45,
                                      max_det=100, max_nms=max_nms, class_mask=jmask,
                                      approx_topk=False, **kw)
    det, n = tnms.nms_batched(torch.from_numpy(pred), conf_thres=conf, iou_thres=0.45,
                              max_det=100, max_nms=max_nms, class_mask=tmask, **kw)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    ref_det = np.asarray(ref_det)
    np.testing.assert_array_equal(det[..., 5].numpy(), ref_det[..., 5])  # classes, in order
    np.testing.assert_allclose(det[..., :5].numpy(), ref_det[..., :5], rtol=0, atol=1e-4)


@pytest.mark.parametrize("api", ["nms_batched", "non_max_suppression"])
def test_more_candidates_than_the_register_path_holds_match_jax(api):
    """max_nms 8192, above MAX_CANDIDATES: 2 images of 2000 boxes x 5 classes,
    multi-label at conf 0.001, so the greedy NMS gets 8192 candidates, nearly all
    valid, and keeps the same detections in the same order as JAX's exact cut."""
    pred = _decoded(41, b=2, n=2000)
    conf, max_nms = 0.001, 8192
    scores = pred[..., 5:] * pred[..., 4:5]
    assert ((scores > conf).reshape(2, -1).sum(1) > 2 * nms_kernel.MAX_CANDIDATES).all()
    kw = dict(conf_thres=conf, iou_thres=0.45, multi_label=True, max_det=100, max_nms=max_nms)
    if api == "nms_batched":
        ref_det, ref_n = jnms.nms_batched(jnp.asarray(pred), approx_topk=False, **kw)
        det, n = tnms.nms_batched(torch.from_numpy(pred), **kw)
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
        ref, got = [np.asarray(ref_det)], [det.numpy()]
    else:
        ref = jnms.non_max_suppression(pred, **kw)
        got = tnms.non_max_suppression(pred, **kw)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g[..., 5], r[..., 5])  # classes, in order
        np.testing.assert_allclose(g[..., :5], r[..., :5], rtol=0, atol=1e-4)


@pytest.mark.parametrize("multi_label", [False, True])
def test_nms_single_matches_jax(multi_label):
    pred = _decoded(21, b=1)[0]
    ref_det, ref_n = jnms.nms_single(jnp.asarray(pred), conf_thres=0.2, iou_thres=0.5,
                                     multi_label=multi_label, max_det=50, max_nms=512,
                                     approx_topk=False)
    det, n = tnms.nms_single(torch.from_numpy(pred), conf_thres=0.2, iou_thres=0.5,
                             multi_label=multi_label, max_det=50, max_nms=512)
    assert int(n) == int(ref_n)
    np.testing.assert_allclose(det.numpy(), np.asarray(ref_det), rtol=0, atol=1e-4)


@pytest.mark.parametrize("classes", [None, [0, 4]])
def test_non_max_suppression_matches_jax(classes):
    pred = _decoded(31)
    ref = jnms.non_max_suppression(pred, conf_thres=0.3, iou_thres=0.45, classes=classes,
                                   max_det=60, max_nms=1024)
    got = tnms.non_max_suppression(pred, conf_thres=0.3, iou_thres=0.45, classes=classes,
                                   max_det=60, max_nms=1024)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


def test_serving_budgets_match_jax():
    assert (tnms.SERVING_MAX_NMS, tnms.EVAL_MAX_NMS, tnms._MAX_WH) == (
        jnms.SERVING_MAX_NMS, jnms.EVAL_MAX_NMS, jnms._MAX_WH)
    for conf in (0.001, 0.0999, 0.1, 0.25):
        assert tnms.serving_max_nms(conf) == jnms.serving_max_nms(conf)
