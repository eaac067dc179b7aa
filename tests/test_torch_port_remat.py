"""``remat``: activations recomputed in the backward pass, at JAX's levels.

The port's ``remat`` ("block": each CSP and SPP block of the backbone and the
neck; "stage": the backbone's four stages and the whole neck) runs through
``torch.utils.checkpoint``. A recompute runs the wrapped modules a second
time, so it must leave no trace: from the same weights and batch, a train
step at "" / "block" / "stage" gives the same loss, the same gradient of every
parameter and the same BatchNorm buffers (running statistics and
``num_batches_tracked``), bit for bit on the CPU; so does the transformer
variant with its dropout on, whose draws all lie in the head, outside every
wrapped region. Parameter names do not depend on the level. Then one step at
"stage" against JAX's ``remat="stage"`` from the same state, at the bounds of
``test_torch_port_train_step.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyeye_tpu.config import ModelConfig as JModelConfig
from skyeye_tpu.losses import ComputeLoss as JComputeLoss
from skyeye_tpu.models.detector import SkyEyeDetectorModule as JDetector
from skyeye_tpu.train import build_optimizer_runtime, create_train_state as jcreate
from skyeye_tpu.train import make_train_step as jmake_step
from skyeye_tpu_torch.config import ModelConfig
from skyeye_tpu_torch.losses import ComputeLoss
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import blocks as tblocks
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule, create_detector
from skyeye_tpu_torch.train import (
    RuntimeOptimizer, create_train_state, make_train_step, step_generator,
)
from skyeye_tpu_torch.utils.checkpoint import from_jax_train_state, restore_train_state

from test_torch_port_train_step import (
    ACCUM, HYP, LOSS_REL, SCHED, TINY, _batch, _jax_reference_numerics, _port_batch,
    _state_errors,
)

LEVELS = ("", "block", "stage")
VARIANTS = {"skyeye_s": {}, "transformer": {"transformer_heads": True},
            "enhanced": {"enhanced": True}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _step_at(level, variant, steps=2):
    """The state, gradients and losses after ``steps`` micro-steps at ``level``."""
    cfg = ModelConfig(**TINY, **VARIANTS[variant])
    model = create_detector(cfg, device="cpu", seed=3, remat=level)
    opt = RuntimeOptimizer(model, HYP, batch_size=16, accumulate=ACCUM)
    state = create_train_state(model, opt)
    step = make_train_step(model, ComputeLoss(cfg.anchors, cfg.nc, hyp=HYP), opt)
    losses, grads = [], []
    for s in range(steps):
        state, m = step(state, _port_batch(s))
        losses.append({k: v.clone() for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    return state, losses, grads


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_levels_give_the_same_loss_gradients_and_batchnorm_buffers(variant, monkeypatch):
    if variant == "transformer":  # through K4's autograd Function at 4 tokens
        monkeypatch.setattr(tatt, "FLASH_MIN_TOKENS", 1)
    runs = {level: _step_at(level, variant) for level in LEVELS}
    ref_state, ref_losses, ref_grads = runs[""]
    ref_sd = ref_state.model.state_dict()
    assert any(k.endswith("num_batches_tracked") for k in ref_sd)
    for level in LEVELS[1:]:
        state, losses, grads = runs[level]
        sd = state.model.state_dict()
        assert list(sd) == list(ref_sd)  # the same names
        for a, b in zip(losses, ref_losses):
            for k in b:
                assert torch.equal(a[k], b[k]), (level, k)
        for a, b in zip(grads, ref_grads):
            for k in b:
                assert torch.equal(a[k], b[k]), (level, k)
        for k, v in ref_sd.items():  # parameters after the update, and every buffer
            assert torch.equal(sd[k], v), (level, k)
        assert all(int(v) == 2 for k, v in sd.items() if k.endswith("num_batches_tracked"))
        for k, v in ref_state.ema.params.items():
            assert torch.equal(state.ema.params[k], v), (level, k)


def test_wrapped_regions_hold_no_dropout_and_leave_its_generator_alone(monkeypatch):
    """Dropout lives in the head only, which no level wraps; a step draws from
    the dropout generator the same amount at every level."""
    monkeypatch.setattr(tatt, "FLASH_MIN_TOKENS", 1)
    cfg = ModelConfig(**TINY, transformer_heads=True)
    model = create_detector(cfg, device="cpu", seed=0, remat="stage")
    for part in (model.backbone, model.neck):
        assert not any(isinstance(m, tatt.Dropout) for m in part.modules())
    assert any(isinstance(m, tatt.Dropout) for m in model.head.modules())
    seen = {}
    for level in LEVELS:
        model = create_detector(cfg, device="cpu", seed=0, remat=level).train()
        gen = step_generator(0, 0, "cpu")
        for m in model.modules():
            if isinstance(m, tatt.Dropout):
                m.generator = gen
        x = torch.from_numpy(_batch(0)["images"]).permute(0, 3, 1, 2).float() / 255
        sum(o.square().sum() for o in model(x)).backward()
        seen[level] = gen.get_state()
    assert torch.equal(seen["block"], seen[""]) and torch.equal(seen["stage"], seen[""])


def test_a_recompute_counts_as_recomputing_only_inside_the_backward():
    calls = []

    def body(x):
        calls.append(tblocks.recomputing())
        return x.sin()

    x = torch.ones(3, requires_grad=True)
    tblocks.remat(body, x).sum().backward()
    assert calls == [False, True] and not tblocks.recomputing()
    with torch.no_grad():
        tblocks.remat(body, x)
    assert calls[-1] is False and len(calls) == 3


def test_unknown_level_raises():
    with pytest.raises(ValueError, match="remat"):
        SkyEyeDetectorModule(ModelConfig(**TINY), remat="layer")


def test_stage_step_matches_jax_remat_stage():
    """Two micro-steps (one optimizer step) from JAX's initial state, JAX's
    module and the port's both at remat="stage"."""
    cfg = JModelConfig(**TINY)
    module = JDetector(config=cfg, remat="stage")
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    tx = build_optimizer_runtime(HYP, variables["params"], batch_size=16, accumulate=ACCUM)
    loss_fn = JComputeLoss(jnp.asarray(cfg.anchors), cfg.nc, hyp=HYP)
    with _jax_reference_numerics():
        jstep = jax.jit(jmake_step(module, loss_fn, tx))
        jstate = jcreate(variables, tx)
        start = jax.device_get(jstate)
        results = []
        for s in range(2):
            batch = dict(_batch(s), opt_hyperparams={
                k: np.float32(v) for k, v in SCHED(s // ACCUM).items()})
            jstate, metrics = jstep(jstate, batch)
            results.append((jax.device_get(jstate), {k: float(v) for k, v in metrics.items()}))

    model = SkyEyeDetectorModule(ModelConfig(**TINY), remat="stage")
    opt = RuntimeOptimizer(model, HYP, batch_size=16, accumulate=ACCUM)
    state = create_train_state(model, opt)
    restore_train_state(state, from_jax_train_state(start, accumulate=ACCUM))
    step = make_train_step(model, ComputeLoss(model.config.anchors, 3, hyp=HYP), opt)
    for s, (want, jm) in enumerate(results):
        state, m = step(state, _port_batch(s))
        for k in ("loss", "box", "obj", "cls"):
            assert float(m[k]) == pytest.approx(jm[k], rel=LOSS_REL["skyeye_s"]), (s, k)
        bad = {k: e for k, e in _state_errors(state, want, start).items() if e > 1.0}
        assert not bad, (s, sorted(bad.items(), key=lambda kv: -kv[1])[:5])
