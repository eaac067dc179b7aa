"""Late decode in the PyTorch port against the JAX package's, index for index.

The same seeded raw logits (B, H, W, na, nc + 5) per level go through
``skyeye_tpu.ops.late_decode`` with ``approx_topk=False`` (the exact cut) and
through ``skyeye_tpu_torch.ops.late_decode``; on the CPU the port's K1 wrapper
runs its plain version. Candidates and detections must sit in the same slots:
classes and counts equal, scores within 1e-6 and boxes within 1e-4 px (the
same float32 operations; sigmoid may differ in the last bit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyeye_tpu.ops import late_decode as jld
from skyeye_tpu_torch.config import DEFAULT_ANCHORS
from skyeye_tpu_torch.ops import late_decode as tld

INPUT = (128, 192)  # levels 16 x 24, 8 x 12, 4 x 6
NC = 6


def _logits(seed, b=3, dtype=np.float32):
    rng = np.random.RandomState(seed)
    outs = []
    for s in (8, 16, 32):
        h, w = INPUT[0] // s, INPUT[1] // s
        o = rng.normal(0, 1, (b, h, w, 3, NC + 5))
        o[..., 4] = rng.normal(-3, 2.5, (b, h, w, 3))   # sparse objects
        o[..., 5:] = rng.normal(-1, 2, (b, h, w, 3, NC))
        outs.append(o.astype(dtype))
    return outs


def _tied(outs):
    """Image 0: every P3 anchor gets the same obj/cls logits (more ties than the
    quota holds, so the cut keeps the lowest indices); image 1: nothing passes."""
    outs = [o.copy() for o in outs]
    outs[0][0, ..., 4:] = outs[0][0, 0, 0, 0, 4:]
    outs[0][0, ..., 4] = 2.0
    for o in outs:
        o[1, ..., 4] = -20.0
    return outs


CASES = {
    "conf0.25": dict(conf_thres=0.25),
    "conf0.001": dict(conf_thres=0.001),
    "conf0.001_max_nms256": dict(conf_thres=0.001, max_nms=256),
    "agnostic": dict(conf_thres=0.01, agnostic=True),
    "class_mask": dict(conf_thres=0.01, class_mask=[True, False, True, False, False, True]),
}


def _both(outs, max_det=300, **kw):
    kw.setdefault("max_nms", 1024)
    mask = kw.pop("class_mask", None)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.tensor(mask)
    ref = jld.late_decode_nms([jnp.asarray(o) for o in outs], jnp.asarray(DEFAULT_ANCHORS),
                              INPUT, max_det=max_det, approx_topk=False, class_mask=jmask, **kw)
    got = tld.late_decode_nms([torch.from_numpy(o) for o in outs], DEFAULT_ANCHORS, INPUT,
                              max_det=max_det, class_mask=tmask, **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def _assert_same_detections(ref, got):
    (rd, rn), (gd, gn) = ref, got
    np.testing.assert_array_equal(gn, rn)
    assert gd.shape == rd.shape
    np.testing.assert_array_equal(gd[..., 5], rd[..., 5])
    np.testing.assert_allclose(gd[..., 4], rd[..., 4], rtol=0, atol=1e-6)
    np.testing.assert_allclose(gd[..., :4], rd[..., :4], rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tied", [False, True])
def test_late_decode_nms_matches_jax(case, tied):
    outs = _logits(1)
    if tied:
        outs = _tied(outs)
    ref, got = _both(outs, **CASES[case])
    if tied:
        assert got[1][1] == 0  # the empty image
    assert got[1].sum() > 0
    _assert_same_detections(ref, got)


@pytest.mark.parametrize("case", ["conf0.001", "class_mask"])
def test_candidates_match_jax_slot_for_slot(case):
    kw = dict(CASES[case])
    mask = kw.pop("class_mask", None)
    outs = _tied(_logits(2))
    ref = jld.topk_candidates([jnp.asarray(o) for o in outs], jnp.asarray(DEFAULT_ANCHORS), INPUT,
                              max_nms=1024, approx_topk=False,
                              class_mask=None if mask is None else jnp.asarray(mask), **kw)
    got = tld.topk_candidates([torch.from_numpy(o) for o in outs], DEFAULT_ANCHORS, INPUT,
                              max_nms=1024,
                              class_mask=None if mask is None else torch.tensor(mask), **kw)
    (rb, rs, rc), (gb, gs, gc) = [np.asarray(r) for r in ref], [g.numpy() for g in got]
    assert gs.shape == rs.shape == (3, sum(tld.level_quotas([1152, 288, 72], 1024)))
    np.testing.assert_array_equal(gs == -1.0, rs == -1.0)
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gs, rs, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gb, rb, rtol=0, atol=1e-4)


def test_bf16_logits_are_cut_in_float32_as_in_jax():
    outs = _logits(3)
    ref = jld.late_decode_nms([jnp.asarray(o, jnp.bfloat16) for o in outs],
                              jnp.asarray(DEFAULT_ANCHORS), INPUT, conf_thres=0.01,
                              approx_topk=False)
    got = tld.late_decode_nms([torch.from_numpy(o).to(torch.bfloat16) for o in outs],
                              DEFAULT_ANCHORS, INPUT, conf_thres=0.01)
    _assert_same_detections([np.asarray(r) for r in ref], [g.numpy() for g in got])


@pytest.mark.parametrize("counts,max_nms", [
    ([76800, 19200, 4800], 4096), ([76800, 19200, 4800], 1024), ([1152, 288, 72], 1024),
    ([288, 72, 18], 4096), ([100, 50], 128), ([4800, 1200, 300], 300)])
def test_level_quotas_match_jax(counts, max_nms):
    assert tld.level_quotas(counts, max_nms) == jld.level_quotas(counts, max_nms)
