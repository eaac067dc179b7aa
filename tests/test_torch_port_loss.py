"""The port's detection losses against the JAX package's, on the same inputs.

``build_targets_level`` is compared exactly; ``ComputeLoss`` (the gather form
and the dense form, with and without per-image weights, empty targets, one
class, colliding assignments) and ``AerialDetectionLoss`` by value (1e-5
relative) and by the gradient w.r.t. each level's logits (1e-5 x max|g| of
``jax.grad``); ``bbox_iou`` for every ``iou_type``, and the CIoU gradient with
its stopped ``alpha``. Inputs are numpy from seeds; everything is float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyeye_tpu.config import DEFAULT_ANCHORS
from skyeye_tpu.losses import detection as jloss
from skyeye_tpu.ops.boxes import bbox_iou as jbbox_iou
from skyeye_tpu_torch.losses import detection as tloss
from skyeye_tpu_torch.ops.boxes import bbox_iou as tbbox_iou

REL = 1e-5
GRID = ((8, 8), (4, 4), (2, 2))  # a 64 px input at strides 8, 16, 32

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _targets(seed, M=12, B=2, nc=4, n_valid=9, wh=(0.03, 0.5)):
    rng = np.random.default_rng(seed)
    t = np.zeros((M, 6), np.float32)
    t[:, 0] = rng.integers(0, B, M)
    t[:, 1] = rng.integers(0, nc, M)
    t[:, 2:4] = rng.uniform(0.05, 0.95, (M, 2))
    t[:, 4:6] = rng.uniform(*wh, (M, 2))
    valid = np.zeros(M, bool)
    valid[:n_valid] = True
    return t, valid


def _logits(seed, B=2, nc=4, na=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (B, h, w, na, nc + 5)).astype(np.float32) for h, w in GRID]


def _colliding(seed, nc=4):
    """Targets of one image in one cell with anchor-compatible sizes: the
    (image, anchor, cell) slots collide, within a level and across offsets."""
    t, valid = _targets(seed, M=8, nc=nc, n_valid=8)
    t[:, 0] = 0
    t[:4, 2:4] = [0.41, 0.37]
    t[:4, 4:6] = [[0.2, 0.25], [0.21, 0.24], [0.19, 0.26], [0.2, 0.25]]
    t[4:6, 2:4] = [0.40, 0.36]
    return t, valid


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_targets_level_equal(level, seed):
    t, valid = _targets(seed, wh=(0.4, 1.0) if level == 2 else (0.03, 0.5))
    anchors = np.asarray(DEFAULT_ANCHORS, np.float32)[level]
    want = jloss.build_targets_level(jnp.asarray(t), jnp.asarray(valid), jnp.asarray(anchors),
                                     GRID[level], 4.0)
    got = tloss.build_targets_level(torch.from_numpy(t), torch.from_numpy(valid),
                                    torch.from_numpy(anchors), GRID[level], 4.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["mask"].any()


CASES = {
    "gather": dict(dense=False, weight=False),
    "gather_img_weight": dict(dense=False, weight=True),
    "dense": dict(dense=True, weight=False),
    "dense_img_weight": dict(dense=True, weight=True),
    "gather_empty_targets": dict(dense=False, weight=False, empty=True),
    "dense_empty_targets": dict(dense=True, weight=False, empty=True),
    "gather_nc1": dict(dense=False, weight=False, nc=1),
    "gather_colliding": dict(dense=False, weight=False, collide=True),
    "dense_colliding": dict(dense=True, weight=False, collide=True),
    "gather_no_focal_smoothing": dict(dense=False, weight=True,
                                      hyp={"fl_gamma": 0.0, "label_smoothing": 0.1}),
}


def _both_losses(case, seed=3):
    c = CASES[case]
    nc = c.get("nc", 4)
    t, valid = _colliding(seed, nc) if c.get("collide") else _targets(seed, nc=nc)
    if c.get("empty"):
        valid[:] = False
    preds = _logits(seed + 10, nc=nc)
    w = np.array([1.0, 0.0], np.float32) if c["weight"] else None
    hyp = c.get("hyp")
    jl = jloss.ComputeLoss(jnp.asarray(DEFAULT_ANCHORS), nc, hyp=hyp, dense=c["dense"])
    tl = tloss.ComputeLoss(DEFAULT_ANCHORS, nc, hyp=hyp, dense=c["dense"])

    def jfn(ps):
        kw = {} if w is None else {"img_weight": jnp.asarray(w)}
        return jl(ps, jnp.asarray(t), jnp.asarray(valid), **kw)

    (jv, jaux), jg = jax.value_and_grad(jfn, has_aux=True)([jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    kw = {} if w is None else {"img_weight": torch.from_numpy(w)}
    tv, taux = tl(tp, torch.from_numpy(t), torch.from_numpy(valid), **kw)
    tv.backward()
    return (float(jv), np.asarray(jaux), [np.asarray(g) for g in jg],
            float(tv), taux.numpy(), [p.grad.numpy() for p in tp])


@pytest.mark.parametrize("case", list(CASES))
def test_compute_loss_value_and_gradient_match_jax(case):
    jv, jaux, jg, tv, taux, tg = _both_losses(case)
    assert np.isfinite(tv)
    np.testing.assert_allclose(tv, jv, rtol=REL)
    np.testing.assert_allclose(taux, jaux, rtol=REL, atol=1e-7)
    for level, (g, want) in enumerate(zip(tg, jg)):
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g - want).max())
        assert err <= REL * scale, (case, level, err, scale)


def test_colliding_assignments_accumulate_into_one_gathered_row():
    """Duplicate (image, anchor, cell) gathers add their gradients into one row
    in both frameworks: the colliding case has rows with two or more matches."""
    t, valid = _colliding(3)
    asg = tloss.build_targets_level(torch.from_numpy(t), torch.from_numpy(valid),
                                    torch.tensor(DEFAULT_ANCHORS[1]), GRID[1], 4.0)
    m = asg["mask"]
    keys = torch.stack([asg["b"], asg["gj"], asg["gi"], asg["a"]], 1)[m]
    assert len(torch.unique(keys, dim=0)) < len(keys)


@pytest.mark.parametrize("seed", [0, 1])
def test_aerial_loss_matches_jax(seed):
    t, valid = _targets(seed, M=10)
    t[:, 4:6] = np.random.default_rng(seed).uniform(0.1, 0.6, (10, 2))  # match the anchors
    preds = _logits(seed + 20)
    jl = jloss.AerialDetectionLoss(jnp.asarray(DEFAULT_ANCHORS), 4)
    tl = tloss.AerialDetectionLoss(DEFAULT_ANCHORS, 4)
    (jv, jaux), jg = jax.value_and_grad(
        lambda ps: jl(ps, jnp.asarray(t), jnp.asarray(valid)), has_aux=True)(
        [jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    tv, taux = tl(tp, torch.from_numpy(t), torch.from_numpy(valid))
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=REL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(jaux), rtol=REL, atol=1e-7)
    for g, want in zip(tp, jg):
        want = np.asarray(want)
        assert float(np.abs(g.grad.numpy() - want).max()) <= REL * float(np.abs(want).max())


def _boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    wh = rng.uniform(0.5, 4, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("iou_type", ["standard", "giou", "diou", "ciou"])
@pytest.mark.parametrize("fmt", ["xywh", "xyxy"])
def test_bbox_iou_matches_jax(iou_type, fmt):
    a, b = _boxes(0), _boxes(1)
    if fmt == "xyxy":
        a[:, 2:] += a[:, :2]
        b[:, 2:] += b[:, :2]
    want = np.asarray(jbbox_iou(jnp.asarray(a), jnp.asarray(b), format=fmt, iou_type=iou_type))
    got = tbbox_iou(torch.from_numpy(a), torch.from_numpy(b), format=fmt,
                    iou_type=iou_type).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ciou_gradient_stops_alpha_as_jax_does():
    a, b = _boxes(2), _boxes(3)
    jg = jax.grad(lambda x: jnp.sum(jbbox_iou(x, jnp.asarray(b), "xywh", "ciou")))(
        jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    tbbox_iou(ta, torch.from_numpy(b), "xywh", "ciou").sum().backward()
    want = np.asarray(jg)
    np.testing.assert_allclose(ta.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # with alpha inside the gradient the result differs: the stop is what matches
    ta2 = torch.from_numpy(a).requires_grad_(True)
    box1, box2 = tbbox_iou.__globals__["xywh2xyxy"](ta2), tbbox_iou.__globals__["xywh2xyxy"](
        torch.from_numpy(b))
    w1, h1 = box1[:, 2] - box1[:, 0], box1[:, 3] - box1[:, 1] + 1e-7
    w2, h2 = box2[:, 2] - box2[:, 0], box2[:, 3] - box2[:, 1] + 1e-7
    iou = tbbox_iou(ta2, torch.from_numpy(b), "xywh", "standard")
    v = (4 / np.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    rest = tbbox_iou(ta2, torch.from_numpy(b), "xywh", "diou")
    (rest - v * (v / (v - iou + 1 + 1e-7))).sum().backward()
    assert float(np.abs(ta2.grad.numpy() - want).max()) > 1e-4 * float(np.abs(want).max())


def test_masked_mean_denominator_counts_the_broadcast_axes():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    m = torch.tensor([1.0, 0.0])
    got = float(tloss.masked_mean(x, m))
    want = float(jloss.masked_mean(jnp.asarray(x.numpy()), jnp.asarray(m.numpy())))
    assert got == pytest.approx(want) == pytest.approx(float(x[0].mean()))
