"""The port's optimizer, schedules and EMA against the JAX package's.

The decay mask and the bias group are compared over every parameter of
skyeye_s and skyeye_l_transformer (flax paths carried to the port's names by
``from_jax_variables``); the schedules value for value; 8 micro-steps of
``RuntimeOptimizer`` against ``build_optimizer_runtime`` on the same
gradients and the same runtime hyperparameters (SGD and Adam, accumulate 1 and
4): parameters within 1e-6 x max|p| per tensor (float32, sums in another
order); the EMA and its counter.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from skyeye_tpu.config import DEFAULT_HYP, ModelConfig as JModelConfig
from skyeye_tpu.models.detector import SkyEyeDetectorModule as JDetector
from skyeye_tpu.train import ema as jema
from skyeye_tpu.train import optimizer as jopt
from skyeye_tpu.train import schedules as jsched
from skyeye_tpu_torch.config import ModelConfig, load_model_config
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.train import ema as tema
from skyeye_tpu_torch.train import optimizer as topt
from skyeye_tpu_torch.train import schedules as tsched
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

TINY = dict(nc=3, base_channels=16, depth_multiple=0.33, width_multiple=0.25)

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _flax_shapes(cfg_dict):
    module = JDetector(config=JModelConfig(**cfg_dict))
    return jax.eval_shape(lambda k, x: module.init(k, x, train=False), jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3)))


def _port_key(path, shape):
    (key,) = [k for k in from_jax_variables({f"params/{path}": np.zeros(shape, np.float32)})]
    return key


@pytest.mark.parametrize("name", ["skyeye_s", "skyeye_l_transformer"])
def test_decay_mask_and_bias_group_equal_jax_over_every_parameter(name):
    cfg = load_model_config(name)
    jcfg = {k: getattr(cfg, k) for k in ("nc", "base_channels", "depth_multiple",
                                         "width_multiple", "transformer_heads")}
    params = _flax_shapes(jcfg)["params"]
    mask = traverse_util.flatten_dict(jopt.decay_mask(params), sep="/")
    labels = traverse_util.flatten_dict(jopt.bias_labels(params), sep="/")
    shapes = traverse_util.flatten_dict(params, sep="/")
    groups = topt.parameter_groups(SkyEyeDetectorModule(cfg))
    assert len(groups) == len(shapes)
    for path, leaf in shapes.items():
        key = _port_key(path, leaf.shape)
        assert groups[key] == (labels[path], bool(mask[path])), (path, key)
    assert {g for g, _ in groups.values()} == {"bias", "other"}
    assert any(d for _, d in groups.values()) and not all(d for _, d in groups.values())


@pytest.mark.parametrize("cos_lr", [True, False])
def test_schedules_equal_jax(cos_lr):
    hyp = dict(DEFAULT_HYP, lr0=0.02, lrf=0.05)
    epochs, spe, warm = 7, 9, 13
    th = tsched.host_schedule(hyp, epochs, spe, cos_lr=cos_lr, warmup_steps=warm)
    jh = jsched.host_schedule(hyp, epochs, spe, cos_lr=cos_lr, warmup_steps=warm)
    tm = tsched.make_lr_schedule(hyp, epochs, spe, cos_lr=cos_lr, warmup_steps=warm)
    jm = jsched.make_lr_schedule(hyp, epochs, spe, cos_lr=cos_lr, warmup_steps=warm)
    for step in range(0, epochs * spe + 1, 3):
        assert th(step) == jh(step)
        assert tm(step) == pytest.approx(float(jm(step)), rel=1e-6)
    assert tsched.host_schedule(hyp, 5, 10)(0) == jsched.host_schedule(hyp, 5, 10)(0)


def _random_params(seed):
    rng = np.random.default_rng(seed)
    shapes = traverse_util.flatten_dict(_flax_shapes(TINY)["params"], sep="/")
    return {p: rng.normal(0, 0.2, s.shape).astype(np.float32) for p, s in shapes.items()}


def _port_model(flat_params):
    m = SkyEyeDetectorModule(ModelConfig(**TINY))
    sd = m.state_dict()
    sd.update(from_jax_variables({f"params/{k}": v for k, v in flat_params.items()}))
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
@pytest.mark.parametrize("accumulate", [1, 4])
def test_micro_steps_match_build_optimizer_runtime(adam, accumulate):
    hyp = dict(DEFAULT_HYP)
    flat = _random_params(0)
    jparams = traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                            for k, v in flat.items()})
    tx = jopt.build_optimizer_runtime(hyp, jparams, adam=adam, batch_size=16,
                                      accumulate=accumulate)
    opt_state = tx.init(jparams)

    @jax.jit
    def jstep(params, opt_state, grads, hp):
        opt_state = opt_state._replace(
            hyperparams={k: jnp.asarray(hp[k], jnp.float32) for k in opt_state.hyperparams})
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    model = _port_model(flat)
    topt_ = topt.RuntimeOptimizer(model, hyp, adam=adam, batch_size=16, accumulate=accumulate)
    named = dict(model.named_parameters())
    keys = {p: _port_key(p, v.shape) for p, v in flat.items()}
    sched = tsched.host_schedule(hyp, 3, 4, warmup_steps=3)
    rng = np.random.default_rng(1)
    changed = []
    for step in range(8):
        g = {p: rng.normal(0, 1, v.shape).astype(np.float32) for p, v in flat.items()}
        hp = sched(step // accumulate)
        jparams, opt_state = jstep(
            jparams, opt_state,
            traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                          for k, v in g.items()}), hp)
        for p, v in from_jax_variables({f"params/{k}": x for k, x in g.items()}).items():
            named[p].grad = v
        before = named[keys["head/pred0/bias"]].detach().clone()
        topt_.set_hyperparams(hp)
        changed.append(topt_.step(model))
        assert changed[-1] == (not torch.equal(before, named[keys["head/pred0/bias"]]))
        want = from_jax_variables({f"params/{k}": np.asarray(v) for k, v in
                                   traverse_util.flatten_dict(jparams, sep="/").items()})
        for k, w in want.items():
            got = named[k].detach()
            tol = 1e-6 * float(w.abs().max())
            assert float((got - w).abs().max()) <= tol, (step, k)
    assert changed == [(s + 1) % accumulate == 0 for s in range(8)]
    assert topt_.gradient_step == 8 // accumulate


def test_optimizer_state_round_trips_and_refuses_another_configuration():
    model = _port_model(_random_params(2))
    a = topt.RuntimeOptimizer(model, DEFAULT_HYP, batch_size=16, accumulate=4)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    for _ in range(5):
        a.step(model)
    b = topt.RuntimeOptimizer(model, DEFAULT_HYP, batch_size=16, accumulate=4)
    b.load_state_dict(a.state_dict())
    assert (b.mini_step, b.gradient_step) == (1, 1)
    assert all(torch.equal(a.trace[k], b.trace[k]) for k in a.trace)
    with pytest.raises(ValueError):
        topt.RuntimeOptimizer(model, DEFAULT_HYP, adam=True, accumulate=4).load_state_dict(
            a.state_dict())


def test_accumulation_steps_and_weight_decay_rescale():
    assert topt.accumulation_steps(16) == jopt.accumulation_steps(16) == 4
    assert topt.accumulation_steps(100) == jopt.accumulation_steps(100) == 1
    model = _port_model(_random_params(3))
    o = topt.RuntimeOptimizer(model, DEFAULT_HYP, batch_size=8)
    assert o.accumulate == 8 and o.weight_decay == pytest.approx(DEFAULT_HYP["weight_decay"])


def test_ema_and_its_counter_equal_jax():
    flat = _random_params(4)
    model = _port_model(flat)
    keys = {p: _port_key(p, v.shape) for p, v in flat.items()}
    jparams = {k: jnp.asarray(v) for k, v in flat.items()}
    js = jema.ema_init(jparams)
    ts = tema.ema_init(model)
    rng = np.random.default_rng(5)
    for _ in range(6):
        new = {k: v + rng.normal(0, 0.1, v.shape).astype(np.float32) for k, v in flat.items()}
        js = jema.ema_update(js, {k: jnp.asarray(v) for k, v in new.items()}, decay=0.99,
                             tau=3.0)
        with torch.no_grad():
            for p, v in new.items():
                dict(model.named_parameters())[keys[p]].copy_(
                    from_jax_variables({f"params/{p}": v})[keys[p]])
        tema.ema_update(ts, model, decay=0.99, tau=3.0)
        assert ts.updates == int(js.updates)
        for p in flat:
            want = from_jax_variables({f"params/{p}": np.asarray(js.params[p])})[keys[p]]
            np.testing.assert_allclose(ts.params[keys[p]].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-7)
    sd = tema.ema_weights(ts, model)
    assert set(sd) == set(model.state_dict())


@pytest.mark.parametrize("adam", [False, True], ids=["sgd", "adam"])
def test_jax_optimizer_state_carries_into_the_port_mid_accumulation(adam):
    """``from_jax_train_state`` carries the trace (or Adam's moments and count)
    and the MultiSteps accumulator and counters: from JAX's state after 5
    micro-steps (one optimizer step, one micro-step accumulated), 3 more on both
    sides end in the same parameters."""
    from skyeye_tpu.train import create_train_state as jcreate
    from skyeye_tpu_torch.train import create_train_state
    from skyeye_tpu_torch.utils.checkpoint import from_jax_train_state, restore_train_state

    hyp, accumulate = dict(DEFAULT_HYP), 4
    flat = _random_params(6)
    unflat = lambda d: traverse_util.unflatten_dict(  # noqa: E731
        {tuple(k.split("/")): jnp.asarray(v) for k, v in d.items()})
    tx = jopt.build_optimizer_runtime(hyp, unflat(flat), adam=adam, batch_size=16,
                                      accumulate=accumulate)
    jstate = jcreate({"params": unflat(flat), "batch_stats": {}}, tx)
    sched = tsched.host_schedule(hyp, 3, 4, warmup_steps=3)
    rng = np.random.default_rng(7)
    grads = [{p: rng.normal(0, 1, v.shape).astype(np.float32) for p, v in flat.items()}
             for _ in range(8)]

    @jax.jit
    def jupdate(params, opt_state, g, hp):
        opt_state = opt_state._replace(
            hyperparams={k: jnp.asarray(hp[k], jnp.float32) for k in opt_state.hyperparams})
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jstate.params, jstate.opt_state
    for step in range(8):
        if step == 5:
            start = jax.device_get(jstate._replace(params=params, opt_state=opt_state))
        params, opt_state = jupdate(params, opt_state, unflat(grads[step]),
                                    sched(step // accumulate))

    model = _port_model(flat)
    opt = topt.RuntimeOptimizer(model, hyp, adam=adam, batch_size=16, accumulate=accumulate)
    state = create_train_state(model, opt)
    restore_train_state(state, from_jax_train_state(start, accumulate=accumulate))
    assert (opt.mini_step, opt.gradient_step) == (1, 1)
    assert not adam or opt.count == 1
    named = dict(model.named_parameters())
    for step in range(5, 8):
        for k, v in from_jax_variables({f"params/{p}": x for p, x in grads[step].items()}).items():
            named[k].grad = v
        opt.set_hyperparams(sched(step // accumulate))
        opt.step(model)
    want = from_jax_variables({f"params/{k}": np.asarray(v) for k, v in
                               traverse_util.flatten_dict(params, sep="/").items()})
    for k, w in want.items():
        assert float((named[k].detach() - w).abs().max()) <= 1e-6 * float(w.abs().max()), k
