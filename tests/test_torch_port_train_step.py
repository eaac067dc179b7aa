"""The port's train step against JAX's ``make_train_step``, from one mid-run
state.

JAX runs two micro-steps first (accumulate 2: one optimizer step, so the
momentum trace is not zero); its ``TrainState`` is carried into the port by
``from_jax_train_state``; then both take 3 more micro-steps on the same uint8
batches with the same runtime hyperparameters: the first accumulates, the
second is an optimizer step, the third runs on the parameters each framework
updated itself. Checked after each, per tensor: parameters, BatchNorm's
running mean and variance and the EMA within a x max|p| + c x max|p - p0|, p0
the tensor before the 3 steps (the steps' change held to c of its size); the
loss and its parts within a relative l; the EMA's counter, the step and the
accumulation counters exactly.

skyeye_s's tiny form runs in float32: a 1e-4, c 1e-3, l 1e-5. The float32
gradients of these tiny nets on noise frames are far from float64's (up to
5e-4 x max|g| in JAX and 4e-4 in the port, measured on this test's step; the
BN biases, which start at 0, are all change). On the third step l is 1e-3
and c 1e-2 for the BN statistics: they come from a forward through
parameters each framework updated itself, and the update's float32 error
moves that loss by 1.8e-4 and the P5 statistics by 2.7e-3 of their change.

The transformer variant (dropout 0 in both; the port's attention forced
through K4's autograd Function, whose CPU forward is the kernel's plain
version, where JAX takes its einsums at 4 tokens) runs in float64 on both
sides (JAX's module with ``dtype=float64`` under ``jax.enable_x64``, its
parameters float32; the port's model in float64, K4's core float32): in
float32 this tiny transformer's training is too ill-conditioned to compare
two frameworks (on the fourth batch JAX's gradients are 12% of a tensor's
max|g| away from its own float64 ones, and the port's update 8.5% of the
change away from float64's), while the float64 runs agree to 1e-4 of the
change: a 1e-5, c 1e-3, l 1e-6; on the third step l 1e-4 (JAX keeps float32
parameters and loss arithmetic: 5.1e-5 measured) and c 1e-2 for the BN
statistics.

A bf16 step is held at the bf16 bound (0.05 x max|a| + 1e-2). JAX's side
runs flax's BatchNorm with the two-pass batch variance E[(x - E[x])^2]
(``use_fast_variance=False``), the formula torch evaluates: flax's default
E[x^2] - E[x]^2 loses about 8e-4 of a P5 batch variance to float32
cancellation in this run, which then reaches every layer after it. Also:
uint8 normalisation's dtype rule, ``n_valid``, BatchNorm's running variance
against stock ``nn.BatchNorm2d``, the train-mode SPP's gradient on ties, and
dropout's generator.
"""
import contextlib

import flax.linen as fnn
import flax.linen.normalization as fnorm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.config import DEFAULT_HYP, ModelConfig as JModelConfig
from skyeye_tpu.losses import ComputeLoss as JComputeLoss
from skyeye_tpu.models import blocks as jblocks
from skyeye_tpu.models.detector import SkyEyeDetectorModule as JDetector
from skyeye_tpu.train import build_optimizer_runtime, create_train_state as jcreate
from skyeye_tpu.train import make_train_step as jmake_step
from skyeye_tpu_torch.config import ModelConfig
from skyeye_tpu_torch.losses import ComputeLoss
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import blocks as tblocks
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.train import (
    RuntimeOptimizer, create_train_state, host_schedule, make_train_step,
)
from skyeye_tpu_torch.utils.checkpoint import (
    from_jax_train_state, from_jax_variables, restore_train_state,
)

TINY = dict(nc=3, base_channels=16, depth_multiple=0.33, width_multiple=0.25)
ACCUM, B, M, SIZE = 2, 2, 8, 64
LOSS_REL = {"skyeye_s": 1e-5, "transformer": 1e-6}
LOSS_AFTER_UPDATE_REL = {"skyeye_s": 1e-3, "transformer": 1e-4}
STATE_REL = {"skyeye_s": 1e-4, "transformer": 1e-5}
CHANGE_REL = 1e-3
STATS_AFTER_UPDATE_CHANGE_REL = 1e-2
HYP = dict(DEFAULT_HYP)
SCHED = host_schedule(HYP, 3, 4, warmup_steps=2)
BF16_REL, BF16_ABS = 0.05, 1e-2

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _batch(seed, n_valid=B):
    rng = np.random.default_rng(seed)
    t = np.zeros((B, M, 6), np.float32)
    mask = np.zeros((B, M), bool)
    for b in range(B):
        for i in range(4):
            t[b, i] = [0, rng.integers(0, 3), *rng.uniform(0.25, 0.75, 2),
                       *rng.uniform(0.1, 0.35, 2)]
            mask[b, i] = True
    return {"images": rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8),
            "targets": t, "mask": mask, "n_valid": np.int32(n_valid)}


@contextlib.contextmanager
def _jax_reference_numerics():
    """While JAX traces its step: flax's Dropout as the identity, and its batch
    statistics with the two-pass variance."""
    saved_dropout, saved_stats = fnn.Dropout.__call__, fnorm._compute_stats
    fnn.Dropout.__call__ = lambda self, x, *a, **k: x
    fnorm._compute_stats = lambda *a, **k: saved_stats(*a, **{**k, "use_fast_variance": False})
    try:
        yield
    finally:
        fnn.Dropout.__call__, fnorm._compute_stats = saved_dropout, saved_stats


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_run(variant, dtype=jnp.float32):
    """JAX's state after 2 micro-steps, and its results for micro-steps 2, 3, 4
    (states as numpy). The transformer variant's module computes in float64."""
    if variant == "transformer" and dtype == jnp.float32:
        with jax.enable_x64(True):
            return _jax_run(variant, jnp.float64)
    cfg = JModelConfig(**TINY, transformer_heads=variant == "transformer")
    module = JDetector(config=cfg, dtype=dtype)
    # jitted: an eager init compiles each of its ops alone (some 480 compiles)
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    rng = np.random.default_rng(7)  # BN statistics away from the identity
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                 else rng.normal(0, 0.1, v.shape)).astype(np.float32)
             for k, v in _flat(variables["batch_stats"]).items()}
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(
                     {tuple(k.split("/")): jnp.asarray(v) for k, v in stats.items()})}
    tx = build_optimizer_runtime(HYP, variables["params"], batch_size=16, accumulate=ACCUM)
    loss_fn = JComputeLoss(jnp.asarray(cfg.anchors), cfg.nc, hyp=HYP)
    with _jax_reference_numerics():
        step = jax.jit(jmake_step(module, loss_fn, tx))
        state = jcreate(variables, tx)
        results = []
        for s in range(5):
            batch = dict(_batch(s), opt_hyperparams={
                k: np.float32(v) for k, v in SCHED(s // ACCUM).items()})
            state, metrics = step(state, batch)
            if s == 1:
                start = jax.device_get(state)
            elif s > 1:
                results.append((jax.device_get(state), {k: float(v) for k, v in metrics.items()}))
    return start, results


def _port(variant, start, dtype=None):
    """The port's state from JAX's ``start``, and its step; the transformer
    variant in float64 unless ``dtype`` says otherwise."""
    dtype = dtype or (torch.float64 if variant == "transformer" else torch.float32)
    cfg = ModelConfig(**TINY, transformer_heads=variant == "transformer")
    model = SkyEyeDetectorModule(cfg, dtype=dtype)
    if dtype == torch.float64:
        model = model.double()
    for m in model.modules():
        if isinstance(m, tatt.Dropout):
            m.p = 0.0
    opt = RuntimeOptimizer(model, HYP, batch_size=16, accumulate=ACCUM)
    state = create_train_state(model, opt)
    restore_train_state(state, from_jax_train_state(start, accumulate=ACCUM))
    step = make_train_step(model, ComputeLoss(cfg.anchors, cfg.nc, hyp=HYP), opt)
    return state, step


def _port_batch(s):
    b = _batch(s)
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    out["opt_hyperparams"] = SCHED(s // ACCUM)
    return out


def _tensors(jstate):
    """A JAX state's params, BN statistics and EMA under the port's names."""
    out = from_jax_variables({**{f"params/{k}": v for k, v in _flat(jstate.params).items()},
                              **{f"batch_stats/{k}": v
                                 for k, v in _flat(jstate.batch_stats).items()}})
    out.update({f"ema:{k}": v for k, v in from_jax_variables(
        {f"params/{k}": v for k, v in _flat(jstate.ema.params).items()}).items()})
    return {k: v for k, v in out.items() if not k.endswith("num_batches_tracked")}


def _state_errors(state, jstate, start, variant="skyeye_s", after_update=False):
    """|port - JAX| over its allowance, per tensor: > 1 fails."""
    sd = state.model.state_dict()
    got = {**sd, **{f"ema:{k}": v for k, v in state.ema.params.items()}}
    before = _tensors(start)
    errs = {}
    for k, w in _tensors(jstate).items():
        stats = k.endswith(("running_mean", "running_var"))
        c = STATS_AFTER_UPDATE_CHANGE_REL if after_update and stats else CHANGE_REL
        allowed = (STATE_REL[variant] * float(w.abs().max())
                   + c * float((w - before[k]).abs().max()))
        err = float((got[k].double() - w.double()).abs().max())
        errs[k] = err / allowed if allowed > 0 else (0.0 if err == 0 else float("inf"))
    return errs


@pytest.fixture(scope="module", params=["skyeye_s", "transformer"])
def runs(request):
    return request.param, _jax_run(request.param)


def test_three_micro_steps_match_jax_from_one_mid_run_state(runs, monkeypatch):
    variant, (start, results) = runs
    if variant == "transformer":  # through K4's autograd Function at 4 tokens
        monkeypatch.setattr(tatt, "FLASH_MIN_TOKENS", 1)
    state, step = _port(variant, start)
    assert max(_state_errors(state, start, start).values()) == 0.0
    for i, (jstate, jm) in enumerate(results):
        state, m = step(state, _port_batch(2 + i))
        after_update = i == 2  # on parameters each framework updated itself
        rel = LOSS_AFTER_UPDATE_REL[variant] if after_update else LOSS_REL[variant]
        for k in ("loss", "box", "obj", "cls"):
            assert float(m[k]) == pytest.approx(jm[k], rel=rel), (i, k)
        errs = _state_errors(state, jstate, start, variant, after_update)
        bad = {k: e for k, e in errs.items() if e > 1.0}
        assert not bad, (i, sorted(bad.items(), key=lambda kv: -kv[1])[:5])
        assert state.step == int(jstate.step) and state.ema.updates == int(jstate.ema.updates)
        inner = jstate.opt_state.inner_state
        assert state.opt.mini_step == int(inner.mini_step)
        assert state.opt.gradient_step == int(inner.gradient_step)


def test_bf16_step_at_the_bf16_bound():
    start, results = _jax_run("skyeye_s", dtype=jnp.bfloat16)
    state, step = _port("skyeye_s", start, dtype=torch.bfloat16)
    jstate, jm = results[0]
    state, m = step(state, _port_batch(2))
    assert abs(float(m["loss"]) - jm["loss"]) <= BF16_REL * abs(jm["loss"]) + BF16_ABS
    want = from_jax_variables({f"params/{k}": v for k, v in _flat(jstate.params).items()})
    sd = state.model.state_dict()
    for k, w in want.items():
        assert float((sd[k] - w).abs().max()) <= BF16_REL * float(w.abs().max()) + BF16_ABS, k


@pytest.mark.parametrize("dtype,augment,want", [
    (torch.float32, False, torch.float32),
    (torch.bfloat16, False, torch.bfloat16),
    (torch.bfloat16, True, torch.float32),
])
def test_uint8_frames_are_normalised_in_jax_dtype(dtype, augment, want):
    model = SkyEyeDetectorModule(ModelConfig(**TINY), dtype=dtype)
    seen = []
    model.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    aug = (lambda im, t, m, g: (im, t, m)) if augment else None
    opt = RuntimeOptimizer(model, HYP, batch_size=64)
    step = make_train_step(model, ComputeLoss(model.config.anchors, 3), opt, device_augment=aug)
    batch = _port_batch(0)
    batch["aug_generator"] = torch.Generator()
    step(create_train_state(model, opt), batch)
    assert seen[0].dtype == want
    images = torch.from_numpy(_batch(0)["images"])
    ref = np.asarray(jnp.asarray(images.numpy()).astype(jnp.bfloat16 if want == torch.bfloat16
                                                        else jnp.float32)
                     / jnp.asarray(255.0, jnp.bfloat16 if want == torch.bfloat16
                                   else jnp.float32)).astype(np.float32)
    got = seen[0].permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, ref)


def test_n_valid_gives_the_duplicated_rows_no_weight():
    """Rows from n_valid on (the loader's wrap-around copies) feed BatchNorm but
    not the loss: changing their targets changes nothing."""
    def run(second_row_targets):
        torch.manual_seed(0)
        model = SkyEyeDetectorModule(ModelConfig(**TINY))
        opt = RuntimeOptimizer(model, HYP, batch_size=64)
        step = make_train_step(model, ComputeLoss(model.config.anchors, 3), opt)
        batch = _port_batch(0)
        batch["targets"][1] = torch.from_numpy(second_row_targets)
        batch["n_valid"] = 1
        return step(create_train_state(model, opt), batch)[1]["loss"]

    t = _batch(0)["targets"]
    moved = t[1].copy()
    moved[:, 2:4] = 1.0 - moved[:, 2:4]
    assert float(run(t[1])) == float(run(moved))


def test_batchnorm_running_variance_is_flax_not_stock_torch():
    """P5-sized (2 x 2) at batch 2: 8 values a channel, where stock
    ``nn.BatchNorm2d`` keeps 8 / 7 of the batch variance."""
    x = np.random.default_rng(0).normal(1.0, 2.0, (2, 2, 2, 4)).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _, upd = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want = np.asarray(upd["batch_stats"]["var"])
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    port, stock = tblocks.BatchNorm2d(4, momentum=0.1), torch.nn.BatchNorm2d(4, momentum=0.1)
    port.train()(xt)
    stock.train()(xt)
    np.testing.assert_allclose(port.running_var.numpy(), want, rtol=1e-6)
    assert not np.allclose(stock.running_var.numpy(), want, rtol=1e-3)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-6)


def test_train_mode_spp_gradient_splits_ties_as_jax():
    """The train path's shift-max pools: max_pool2d's values, and on tied
    values the gradient of ``jnp.maximum`` (split), not max_pool2d's (one
    winner)."""
    x = np.zeros((1, 7, 7, 2), np.float32)
    x[0, 1:5, 2:6, 0] = 3.0  # a plateau of ties
    x[0, :, :, 1] = np.random.default_rng(1).normal(size=(7, 7))
    w = np.random.default_rng(2).normal(size=(1, 7, 7, 2)).astype(np.float32)

    def jpool(v):
        return jnp.sum(jblocks._maxpool_same_shiftmax(v, 5) * w)

    want = np.asarray(jax.grad(jpool)(jnp.asarray(x)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = tblocks.maxpool_same_shiftmax(xt, 5)
    torch.testing.assert_close(out, torch.nn.functional.max_pool2d(xt, 5, 1, 2))
    (out * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6,
                               atol=1e-6)


def test_train_mode_spp_block_gradients_match_jax_on_tied_maxima():
    """SPPBlock in train mode against JAX's on an input whose 1x1 conv output has
    plateaus of exactly tied maxima (as letterbox and mosaic fill give at P5):
    the output, BN's batch statistics, and the gradients of every parameter and
    of the input. ``max_pool2d``'s gradient (one winner a window) fails it."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    x[:, 1:6, 2:8, :] = rng.normal(size=8).astype(np.float32)  # one vector on a plateau
    g = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    jmod = jblocks.SPPBlock(out_channels=8)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    r = np.random.RandomState(5)
    flat = {k: (r.uniform(0.5, 1.5, v.shape) if k.endswith("/var") else
                r.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1])) if k.endswith("kernel")
                else r.normal(0, 0.1, v.shape)).astype(np.float32)
            for k, v in traverse_util.flatten_dict(shapes, sep="/").items()}
    tree = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                         for k, v in flat.items()})

    def loss(params, xj):
        out, upd = jmod.apply({"params": params, "batch_stats": tree["batch_stats"]}, xj,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(g)), (out, upd)

    with _jax_reference_numerics():
        (_, (jout, jupd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            tree["params"], jnp.asarray(x))
    tmod = tblocks.SPPBlock(8, 8)
    tmod.load_state_dict(from_jax_variables(flat), strict=True)
    tmod.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = tmod(xt)
    (out * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    want = from_jax_variables({**{f"params/{k}": np.asarray(v) for k, v in _flat(gp).items()},
                               **{f"batch_stats/{k}": np.asarray(v)
                                  for k, v in _flat(jupd["batch_stats"]).items()}})
    for name, p in tmod.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    for name, b in tmod.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(gx), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(gx)).max()))
    windows = torch.nn.functional.unfold(torch.nn.functional.pad(
        tmod.cv1(xt.detach()), (2,) * 4, value=float("-inf")), 5).view(2, 4, 25, -1)
    assert int(((windows == windows.amax(2, keepdim=True)).sum(2) > 1).sum()) > 0  # ties


def test_dropout_draws_from_its_generator_only():
    d = tatt.Dropout(0.5).train()
    x = torch.ones(1000)
    with pytest.raises(RuntimeError, match="generator"):
        d(x)
    d.generator = torch.Generator().manual_seed(3)
    a = d(x)
    d.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, d(x)) and set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(d.eval()(x), x)
