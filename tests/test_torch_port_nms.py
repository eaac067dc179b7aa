"""Greedy NMS of the PyTorch port against the JAX package, index for index.

The port's plain K1/K2 (skyeye_tpu_torch/ops/nms_kernel.py, what a CPU tensor
runs) must keep the same indices in the same order as
``skyeye_tpu.ops.nms._greedy_nms`` and as the Pallas kernels run in interpret
mode; the full NMS (cut + suppression) must equal JAX's ``approx_topk=False``
path. The plain versions of the kernels' three stages (order, mask, walk)
composed must do the same. Inputs are made with numpy from a seed and fed to
both packages.
"""
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


# -- NaN, inf and signed zeros: the cases where the first CUDA kernel left JAX ----

def _nan_cases():
    """name -> (boxes, scores, iou, max_det), each the semantics of one rule:
    a row with a NaN score keeps nothing (JAX's argmax picks the NaN, which is
    not > 0); a NaN coordinate makes every IoU of its box NaN, which suppresses
    nothing; +inf ranks first and ties by index; -0.0 and +0.0 are never kept; a
    box of infinite width and zero height has a NaN area, so its IoU with a box
    it does not touch is 0 / NaN."""
    cases = {}
    # three disjoint boxes, the middle score NaN
    boxes = np.array([[[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50]]], np.float32)
    cases["nan_score_tiny"] = (boxes, np.array([[0.9, np.nan, 0.5]], np.float32), 0.45, 8)
    boxes = np.array([[[0, 0, 10, 10], [np.nan, 1, 9, 9], [1, 1, np.nan, 11],
                       [0, 0, 10, 10.5], [50, 50, 60, 60]]], np.float32)
    scores = np.array([[0.9, 0.8, 0.7, 0.6, 0.5]], np.float32)
    cases["nan_box_five"] = (boxes, scores, 0.45, 8)
    # seeded: one NaN score in the middle row, NaN coordinates in every row
    rng = np.random.RandomState(7)
    boxes, scores = _candidates(rng, 3, 300)
    scores[1, 150] = np.nan
    boxes[rng.uniform(size=boxes.shape) < 0.02] = np.nan
    cases["nan_seeded_b3_k300"] = (boxes, scores, 0.45, 100)
    # +inf scores (tied), signed zeros, a NaN-area box, a NaN-score row
    rng = np.random.RandomState(8)
    boxes, scores = _candidates(rng, 4, 200)
    scores[0, [5, 17, 40]] = np.inf
    scores[0, [6, 7]] = np.float32(-0.0)
    scores[0, [8, 9]] = np.float32(0.0)
    boxes[0, 10] = [100.0, 100.0, np.inf, 100.0]
    scores[0, 10] = np.float32(0.99)
    boxes[1, 3, 1] = np.nan
    scores[2, 199] = np.nan
    boxes[3, :20] = boxes[3, 0]
    scores[3, :20] = np.inf
    cases["inf_zeros_nan_b4_k200"] = (boxes, scores, 0.5, 64)
    return cases


NAN_CASES = _nan_cases()


@pytest.mark.parametrize("name", list(NAN_CASES))
def test_plain_matches_jax_on_nan_inf_and_zero_scores(name):
    boxes, scores, iou, md = NAN_CASES[name]
    idx, valid = nms_kernel.batched_greedy_nms_plain(torch.from_numpy(boxes),
                                                     torch.from_numpy(scores), iou, md)
    ref_idx, ref_valid = _jax_lax(boxes, scores, iou, md)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)


@pytest.mark.parametrize("name", list(NAN_CASES))
def test_plain_matches_pallas_batched_interpret_on_nan_cases(name):
    boxes, scores, iou, md = NAN_CASES[name]
    idx, valid = nms_kernel.batched_greedy_nms_plain(torch.from_numpy(boxes),
                                                     torch.from_numpy(scores), iou, md)
    ref_idx, ref_valid = pallas_batched_greedy_nms(
        jnp.asarray(boxes), jnp.asarray(scores), max_det=md, iou_thres=iou, interpret=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("name,keep", [("nan_score_tiny", []), ("nan_box_five", [0, 1, 2, 4])])
def test_nan_rows_keep_what_jax_and_the_pallas_kernel_keep(name, keep):
    boxes, scores, iou, md = NAN_CASES[name]
    idx, valid = nms_kernel.greedy_nms_plain(torch.from_numpy(boxes[0]),
                                             torch.from_numpy(scores[0]), iou, md)
    ref_idx, ref_valid = pallas_greedy_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                                           max_det=md, iou_thres=iou, interpret=True)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert idx[valid].tolist() == keep


# -- the kernels' three stages, in plain PyTorch --------------------------------

def _stage_case(name):
    if name in NAN_CASES:
        return NAN_CASES[name]
    if name == "iou0_b3_k300":
        boxes, scores = _candidates(np.random.RandomState(9), 3, 300)
        return boxes, scores, 0.0, 100
    if name == "iou_negative_b2_k150":
        # below 0 every pair suppresses, except where the IoU is NaN
        boxes, scores, _, _ = NAN_CASES["inf_zeros_nan_b4_k200"]
        return boxes[:2, :150].copy(), scores[:2, :150].copy(), -0.5, 40
    if name == "b2_k8192":
        boxes, scores = _candidates(np.random.RandomState(10), 2, 8192, n_cls=12,
                                    invalid_frac=0.1)
        return boxes, scores, 0.45, 300
    return _case(name)


STAGE_CASES = ALL + list(NAN_CASES) + ["iou0_b3_k300", "iou_negative_b2_k150", "b2_k8192"]


def _plain_stages(boxes, scores, iou, md):
    order = nms_kernel.nms_order_plain(torch.from_numpy(boxes), torch.from_numpy(scores))
    mask = nms_kernel.nms_mask_plain(order.sorted_boxes, order.n_pos, iou)
    return order, mask, nms_kernel.nms_walk_plain(mask, order.order, order.n_pos,
                                                  order.has_nan, md)


@pytest.mark.parametrize("name", STAGE_CASES)
def test_plain_stages_compose_to_jax(name):
    boxes, scores, iou, md = _stage_case(name)
    _, _, (idx, valid) = _plain_stages(boxes, scores, iou, md)
    ref_idx, ref_valid = _jax_lax(boxes, scores, iou, md)
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool


def test_plain_order_and_mask_hold_their_contract():
    """The order: positives by score descending, then index; n_pos and has_nan.
    The mask: zero outside ``mask_defined``, bit (r, c) = JAX's IoU > thr."""
    boxes, scores, iou, _ = NAN_CASES["inf_zeros_nan_b4_k200"]
    order, mask, _ = _plain_stages(boxes, scores, iou, 8)
    b, k = scores.shape
    assert order.n_pos.tolist() == [int((s > 0).sum()) for s in scores]
    assert order.has_nan.tolist() == [int(np.isnan(s).any()) for s in scores]
    for i in range(b):
        n = int(order.n_pos[i])
        want = sorted(np.flatnonzero(scores[i] > 0), key=lambda j: (-scores[i, j], j))
        assert order.order[i, :n].tolist() == [int(j) for j in want]
        np.testing.assert_array_equal(order.sorted_boxes[i, :n].numpy(), boxes[i, want])
    defined = nms_kernel.mask_defined(order.n_pos, k)
    assert mask.shape == (b, k, nms_kernel.words_per_row(k))
    assert not bool(mask[~defined].any())
    # row 0: every bit against the JAX formula, one pair at a time
    sb = order.sorted_boxes[0].numpy()
    n = int(order.n_pos[0])
    words = mask[0].numpy().view(np.uint64)
    with np.errstate(invalid="ignore"):  # the NaN-area box
        area = np.clip(sb[:, 2] - sb[:, 0], 0, None) * np.clip(sb[:, 3] - sb[:, 1], 0, None)
        for r in range(0, n, 7):
            for c in range(r + 1, n):
                iw = np.clip(np.minimum(sb[c, 2], sb[r, 2]) - np.maximum(sb[c, 0], sb[r, 0]),
                             0, None)
                ih = np.clip(np.minimum(sb[c, 3], sb[r, 3]) - np.maximum(sb[c, 1], sb[r, 1]),
                             0, None)
                inter = np.float32(iw * ih)
                hit = inter / (area[c] + area[r] - inter + np.float32(1e-7)) > np.float32(iou)
                assert bool((words[r, c // 64] >> np.uint64(c % 64)) & np.uint64(1)) == bool(hit)


def test_stage_wrappers_run_the_plain_stages_on_cpu():
    boxes, scores, iou, md = _case("special")
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    nms_kernel.reset_launch_counts()
    order = nms_kernel.nms_order(tb, ts)
    mask = nms_kernel.nms_mask(order.sorted_boxes, order.n_pos, iou)
    idx, valid = nms_kernel.nms_walk(mask, order.order, order.n_pos, order.has_nan, md)
    ref_idx, ref_valid = nms_kernel.batched_greedy_nms_plain(tb, ts, iou, md)
    assert torch.equal(idx, ref_idx) and torch.equal(valid, ref_valid)
    assert nms_kernel.LAUNCHES == {"batched_greedy_nms": 0, "greedy_nms": 0}


def _crowded(seed, b, k):
    """Rows 0 and 1 as ``_candidates`` gives them; rows 2 on from 40 tight
    clusters of one class, so few are kept and the walk runs past 4 max_det."""
    rng = np.random.RandomState(seed)
    boxes, scores = _candidates(rng, b, k)
    centers = rng.uniform(0, 600, (40, 2))[rng.randint(0, 40, (b - 2, k))]
    centers = centers + rng.normal(0, 2, (b - 2, k, 2))
    boxes[2:] = np.concatenate([centers - 30, centers + 30], -1).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("name", ["b2_k8192", "crowded_b4_k3000", "special"])
def test_first_pass_walk_decides_the_images_it_marks_done(name):
    """The kernels' first pass: the mask's square of positions below
    ``walk_limit`` and a walk over those positions. An image is done when that
    walk keeps max_det or has no more candidates, and then it keeps what the
    whole walk keeps; the others take the second pass."""
    if name == "crowded_b4_k3000":
        (boxes, scores), iou, md = _crowded(12, 4, 3000), 0.45, 100
    else:
        boxes, scores, iou, md = _stage_case(name)
    order, mask, (idx, valid) = _plain_stages(boxes, scores, iou, md)
    limit = nms_kernel.walk_limit(scores.shape[1], md)
    square = mask.clone()
    square[:, limit:] = 0
    square[:, :, -(-limit // 64):] = 0
    first_idx, first_valid = nms_kernel.nms_walk_plain(
        square, order.order, order.n_pos.clamp(max=limit), order.has_nan, md)
    done = (first_valid.sum(dim=1) == md) | (order.n_pos <= limit)
    assert torch.equal(first_idx[done], idx[done]) and torch.equal(first_valid[done], valid[done])
    if name == "crowded_b4_k3000":  # the crowded rows need the second pass
        assert done.tolist() == [True, True, False, False]


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_words", "n_pos_shape", "boxes_dtype"])
def test_stage_wrappers_reject_what_the_kernels_do_not_take(bad):
    boxes, scores, iou, md = _case("k130_b9")
    order, mask, _ = _plain_stages(boxes, scores, iou, md)
    walk_args = [mask, order.order, order.n_pos, order.has_nan]
    mask_args = [order.sorted_boxes, order.n_pos]
    if bad == "mask_dtype":
        walk_args[0] = mask.int()
    elif bad == "mask_words":
        walk_args[0] = mask[..., :1].contiguous()
    elif bad == "n_pos_shape":
        walk_args[2] = order.n_pos[:-1]
    else:
        mask_args[0] = order.sorted_boxes.double()
    with pytest.raises(ValueError):
        if bad == "boxes_dtype":
            nms_kernel.nms_mask(*mask_args, iou)
        else:
            nms_kernel.nms_walk(*walk_args, md)


@pytest.mark.parametrize("k", [1, 64, 65, 4096, 6001, 8192])
def test_scratch_size_rule(k):
    """What one call on the card allocates: one buffer holding the order stage's
    four outputs, the walk's done flags and a (B, k, ceil(k / 64)) mask of 64-bit
    words, each part on a 256-byte boundary; the mask is 32 MiB at B 16, k 4096."""
    b = 16
    nw = -(-k // 64)
    layout = nms_kernel.scratch_layout(b, k)
    assert {name: (shape, dtype) for name, (_, shape, dtype) in layout.items()} == {
        "sorted_boxes": ((b, k, 4), torch.float32), "order": ((b, k), torch.int32),
        "n_pos": ((b,), torch.int32), "has_nan": ((b,), torch.int32),
        "done": ((b,), torch.int32), "mask": ((b, k, nw), torch.int64)}
    end = 0
    for offset, shape, dtype in layout.values():  # in order, aligned, not overlapping
        assert offset % 256 == 0 and offset >= end
        end = offset + int(np.prod(shape)) * dtype.itemsize
    assert nms_kernel.scratch_bytes(b, k) == end
    mask_bytes = b * k * nw * 8
    assert end - layout["mask"][0] == mask_bytes
    assert mask_bytes == {1: 128, 64: 8192, 65: 16640, 4096: 32 << 20, 6001: 72_204_032,
                          8192: 128 << 20}[k]
    assert layout["mask"][0] < b * k * 20 + 5 * 256  # the rest: 20 bytes a candidate


@pytest.mark.parametrize("k,max_det,limit", [(1, 300, 1), (1024, 300, 1024), (4096, 300, 1280),
                                             (4096, 1000, 4096), (8192, 1000, 4096),
                                             (8192, 100, 1024)])
def test_walk_limit_rule(k, max_det, limit):
    """The first pass covers 4 max_det sorted positions (at least 1024) in whole
    256-position tiles, or all k: the served k 4096 input's walks end near
    position 530 at max_det 300."""
    assert nms_kernel.walk_limit(k, max_det) == limit


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
    """max_nms 8192, twice the 4096 candidates an image of the greedy kernel's
    register path once held: 2 images of 2000 boxes x 5 classes, multi-label at
    conf 0.001, so the greedy NMS gets 8192 candidates, nearly all valid, and
    keeps the same detections in the same order as JAX's exact cut."""
    pred = _decoded(41, b=2, n=2000)
    conf, max_nms = 0.001, 8192
    scores = pred[..., 5:] * pred[..., 4:5]
    assert ((scores > conf).reshape(2, -1).sum(1) > 2 * 4096).all()
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
