"""Spatial sharding on the port (``skyeye_tpu_torch.parallel.spatial``) against
one process and against JAX's spatial mesh, on the CPU over gloo.

The workers are spawned once for the module (``parallel.launch``, world 4, one
torch thread each) on a (data 2, spatial 2) mesh; each half of the world also
forms a (data 1, spatial 2) mesh of its own. Every worker runs every case
below and hands its results back. JAX runs in this process on its virtual
CPU devices, its train steps while the workers run the other cases (the step
cases wait for JAX's start states).

  (a) ``halo_exchange``, ``gather_spatial``, ``split_spatial``,
      ``spatial_sum`` and ``spatial_max`` at 2 and 4 ranks: the forward equals
      the rows of the padded whole tensor, and the ranks' input gradients sum
      to one process's;
  (b) each block under spatial 2 against one process on the whole batch:
      output rows within 1e-5 x max|y|, input and parameter gradients within
      1e-5 x max|g|: ConvBlock 1x1, 3x3/1, 3x3/2, Focus, SPP (train and eval),
      CBAM, CrossLayerAttention (both modes) and the P5 head's
      TransformerLayer (on gathered tokens, through K4's route);
  (c) the model's eval forward at (data 1, spatial 2) against JAX's
      ``tests/test_parallel.py`` set-up on a (1, 2) spatial mesh; and the
      transformer and enhanced variants' training forward, partial losses and
      gradients against one process;
  (d) the train step in float64, 3 micro-steps from a JAX mid-run state (two
      micro-steps in, accumulate 2), at (data 1, spatial 2) and (data 2,
      spatial 2), at 256 px (no guard gathers) and 64 px (the guard gathers the
      deep stages), against JAX's step on a spatial mesh and against the port's
      one-process step: loss within 1e-5 relative, every parameter, BatchNorm
      statistic and EMA tensor within 1e-4 x max|w| + 1e-3 x max|change|
      (after the update 1e-3 and 1e-2 for the statistics), the ranks bitwise
      equal. JAX runs one mesh a size, (2, 2) at 256 px and (1, 2) at 64 px
      (each JAX mesh costs a compile of some 30 s here); both port meshes are
      held against it;
  (e) ``cli.train(spatial_shards=2)`` (which launches its own two workers)
      against ``cli.train`` at world 1: the same ``results.csv`` row;
  and ``remat="stage"`` under the (1, 2) mesh equal to the step without it,
  and the step with the device augmentation at (2, 2) against one process;
  and what still raises: FSDP over a spatial mesh (ROADMAP item 8c) and an
  uneven row split.
"""
import csv
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from skyeye_tpu_torch.config import DEFAULT_HYP, ModelConfig
from skyeye_tpu_torch.losses import ComputeLoss
from skyeye_tpu_torch.models import attention as tatt
from skyeye_tpu_torch.models import blocks as tblocks
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule, init_weights
from skyeye_tpu_torch.models.head import DetectionHead
from skyeye_tpu_torch.parallel import (
    Mesh, create_mesh, gather_spatial, halo_exchange, launch, shard_batch, spatial_max,
    spatial_parallel, spatial_sum, split_spatial,
)
from skyeye_tpu_torch.parallel.fsdp import full_tensors
from skyeye_tpu_torch.train import (
    RuntimeOptimizer, create_train_state, host_schedule, make_train_step,
)
from skyeye_tpu_torch.train.trainer import set_dropout_generator

TINY = dict(nc=3, base_channels=16, depth_multiple=0.33, width_multiple=0.25)
ACCUM, B, M, WORLD = 2, 4, 8, 4
SIZES = (256, 64)
MESHES = ((1, 2), (2, 2))
JAX_MESH = {256: (2, 2), 64: (1, 2)}  # JAX's mesh at each size
HYP = dict(DEFAULT_HYP)
SCHED = host_schedule(HYP, 3, 4, warmup_steps=2)
LOSS_REL, LOSS_AFTER_UPDATE_REL = 1e-5, 1e-3
STATE_REL, CHANGE_REL, STATS_AFTER_UPDATE_CHANGE_REL = 1e-4, 1e-3, 1e-2
BLOCK_REL = 1e-5
# float64 models: the sharded sums in another order only; the transformer's K4
# computes in float32 whatever the model's dtype
VARIANT_REL = {"transformer_heads": 1e-6, "enhanced": 1e-9}
N_FRAMES, IMG, CLI_BATCH = 8, 64, 4

# (above, below, fill) of the exchange cases; 6 rows run past a share of 4 (n = 4)
HALOS = ((1, 1, 0.0), (1, 0, 0.0), (2, 2, 0.0), (0, 3, 0.0), (6, 6, float("-inf")))
EXCHANGE_SHAPE = (2, 3, 16, 5)


def _batch(seed, size):
    """A global batch of B: row 1 holds no targets; from the second micro-step
    on, row 3 is a wrap-around copy (n_valid 3)."""
    rng = np.random.default_rng(seed)
    t = np.zeros((B, M, 6), np.float32)
    mask = np.zeros((B, M), bool)
    for b in range(B):
        for i in range(0 if b == 1 else 4):
            t[b, i] = [0, rng.integers(0, 3), *rng.uniform(0.2, 0.8, 2),
                       *rng.uniform(0.05, 0.35, 2)]
            mask[b, i] = True
    return {"images": rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
            "targets": t, "mask": mask, "n_valid": np.int32(3 if seed % 2 else B)}


# -- the workers' cases (torch only: the spawned workers import this module) --------


def _exchange_inputs(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=EXCHANGE_SHAPE)
    h = EXCHANGE_SHAPE[2] // n
    g = {halo: rng.normal(size=(n, 2, 3, h + halo[0] + halo[1], 5)) for halo in HALOS}
    g["gather"] = rng.normal(size=(n,) + EXCHANGE_SHAPE)
    g["split"] = rng.normal(size=(n, 2, 3, h, 5))
    g["reduce"] = rng.normal(size=(n, 2, 3))
    return x, g


def _case_exchange(group, n, rank):
    x, g = _exchange_inputs(n)
    h = x.shape[2] // n
    mine = x[:, :, rank * h:(rank + 1) * h]
    out = {}
    with spatial_parallel(group, n, rank):
        for halo in HALOS:
            t = torch.from_numpy(mine.copy()).requires_grad_(True)
            y = halo_exchange(t, *halo)
            (y.nan_to_num(neginf=0.0) * torch.from_numpy(g[halo][rank])).sum().backward()
            out[halo] = (y.detach().numpy(), t.grad.numpy())
        t = torch.from_numpy(mine.copy()).requires_grad_(True)
        y = gather_spatial(t)
        (y * torch.from_numpy(g["gather"][rank])).sum().backward()
        out["gather"] = (y.detach().numpy(), t.grad.numpy())
        t = torch.from_numpy(x.copy()).requires_grad_(True)
        y = split_spatial(t)
        (y * torch.from_numpy(g["split"][rank])).sum().backward()
        out["split"] = (y.detach().numpy(), t.grad.numpy())
        for name, fn, local in (("sum", spatial_sum, mine.sum(axis=(2, 3))),
                                ("max", spatial_max, mine.max(axis=(2, 3)))):
            t = torch.from_numpy(local.copy()).requires_grad_(True)
            y = fn(t)
            (y * torch.from_numpy(g["reduce"][rank])).sum().backward()
            out[name] = (y.detach().numpy(), t.grad.numpy())
    return out


def _block_cases():
    """name -> (builder, input shapes (N, C, H, W), train mode)."""
    cbam = lambda: tatt.CBAM(16, reduction_ratio=4)  # noqa: E731
    head = lambda: DetectionHead([8, 8, 8], 3, transformer_heads=True)  # noqa: E731
    return {
        "conv1x1": (lambda: tblocks.ConvBlock(6, 8, 1), [(2, 6, 16, 8)], True),
        "conv3x3s1": (lambda: tblocks.ConvBlock(6, 8, 3), [(2, 6, 16, 8)], True),
        "conv3x3s2": (lambda: tblocks.ConvBlock(6, 8, 3, stride=2), [(2, 6, 16, 8)], True),
        "focus": (lambda: tblocks.FocusBlock(3, 8, 3), [(2, 3, 32, 16)], True),
        "spp_train": (lambda: tblocks.SPPBlock(8, 8), [(2, 8, 16, 8)], True),
        "spp_eval": (lambda: tblocks.SPPBlock(8, 8), [(2, 8, 16, 8)], False),
        "cbam": (cbam, [(2, 16, 16, 8)], True),
        "cross_attention": (lambda: tatt.CrossLayerAttention(8, 16, region_size=2, heads=4),
                            [(2, 8, 16, 8), (2, 16, 8, 4)], True),
        "cross_attention_ref_exact": (
            lambda: tatt.CrossLayerAttention(8, 16, region_size=2, heads=4, ref_exact=True),
            [(2, 8, 16, 8), (2, 16, 8, 4)], True),
        "transformer_head": (head, [(2, 8, 32, 16), (2, 8, 16, 8), (2, 8, 16, 16)], True),
    }


def _block_module(name):
    build, shapes, train = _block_cases()[name]
    torch.manual_seed(0)
    m = build()
    init_weights(m, torch.Generator().manual_seed(1))
    with torch.no_grad():  # BatchNorm away from the identity
        for k, b in m.named_buffers():
            if k.endswith("running_var"):
                b.uniform_(0.5, 1.5)
            elif k.endswith("running_mean"):
                b.normal_(0.0, 0.1)
    set_dropout_generator(m, torch.Generator().manual_seed(2))
    return m.train(train), shapes


def _block_inputs(name):
    _, shapes, _ = _block_cases()[name]
    rng = np.random.default_rng(5)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return xs


def _block_output_grad(shapes):
    rng = np.random.default_rng(6)
    return [rng.normal(size=shape).astype(np.float32) for shape in shapes]


def _as_list(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


def _block_run(name, xs, rows):
    """The block on ``xs`` (each cut to ``rows`` of its own height: a slice of
    fractions) with its output gradient's same rows; returns outputs, input
    gradients, parameter gradients and BatchNorm statistics."""
    m, _ = _block_module(name)
    inputs = []
    for x in xs:
        h = x.shape[2]
        lo, hi = int(rows[0] * h), int(rows[1] * h)
        inputs.append(torch.from_numpy(x[:, :, lo:hi].copy()).requires_grad_(True))
    if name == "transformer_head":
        orig = tatt.FLASH_MIN_TOKENS
        tatt.FLASH_MIN_TOKENS = 1  # K4's route (its plain version on the CPU)
    try:
        y = _as_list(m(inputs) if name == "transformer_head" else m(*inputs))
    finally:
        if name == "transformer_head":
            tatt.FLASH_MIN_TOKENS = orig
    y = [t.permute(0, 3, 1, 2, 4).flatten(3) if t.dim() == 5 else t for t in y]  # rows on dim 2
    whole = _block_output_grad([(t.shape[0], t.shape[1], round(t.shape[2] / (rows[1] - rows[0])),
                                 *t.shape[3:]) for t in y])
    loss = 0.0
    for t, g in zip(y, whole):
        h = g.shape[2]
        lo, hi = int(rows[0] * h), int(rows[1] * h)
        loss = loss + (t * torch.from_numpy(g[:, :, lo:hi].copy())).sum()
    loss.backward()
    return {"y": [t.detach().numpy() for t in y], "dx": [t.grad.numpy() for t in inputs],
            "dparams": {k: p.grad.numpy() for k, p in m.named_parameters() if p.grad is not None},
            "stats": {k: b.numpy().copy() for k, b in m.named_buffers()}}


def _case_blocks(group, rank):
    out = {}
    for name in _block_cases():
        with spatial_parallel(group, 2, rank):
            out[name] = _block_run(name, _block_inputs(name), (rank / 2, (rank + 1) / 2))
    return out


def _case_forward(group, rank, spec):
    """(c): the JAX set-up's model, eval forward on this rank's rows."""
    model = SkyEyeDetectorModule(ModelConfig(**TINY))
    model.load_state_dict(torch.load(spec["forward_weights"]), strict=True)
    x = np.load(spec["forward_input"])  # NHWC
    h = x.shape[1] // 2
    xs = torch.from_numpy(x[:, rank * h:(rank + 1) * h].copy()).permute(0, 3, 1, 2)
    with torch.no_grad(), spatial_parallel(group, 2, rank):
        outs = model.eval()(xs)
    return [o.numpy() for o in outs]


def _variant_model(variant):
    cfg = ModelConfig(**TINY, **{variant: True})
    m = SkyEyeDetectorModule(cfg, dtype=torch.float64).double()
    init_weights(m, torch.Generator().manual_seed(3))
    set_dropout_generator(m, torch.Generator().manual_seed(4))
    return m.train()


VARIANTS = ("transformer_heads", "enhanced")
VARIANT_SIZE = 128


def _variant_run(variant, rows):
    """The variant's training forward, loss and backward on ``rows`` of the image."""
    m = _variant_model(variant)
    b = _batch(9, VARIANT_SIZE)
    x = torch.from_numpy(b["images"][:2].astype(np.float64) / 255.0).permute(0, 3, 1, 2)
    lo, hi = int(rows[0] * VARIANT_SIZE), int(rows[1] * VARIANT_SIZE)
    t = b["targets"][:2].copy()
    t[:, :, 0] = np.arange(2)[:, None]
    orig = tatt.FLASH_MIN_TOKENS
    tatt.FLASH_MIN_TOKENS = 1
    try:
        outs = m(x[:, :, lo:hi].contiguous())
    finally:
        tatt.FLASH_MIN_TOKENS = orig
    loss, _ = ComputeLoss(m.config.anchors, 3, hyp=HYP)(
        outs, torch.from_numpy(t.reshape(-1, 6)), torch.from_numpy(b["mask"][:2].reshape(-1)))
    loss.backward()
    return {"loss": float(loss.detach()), "outs": [o.detach().numpy() for o in outs],
            "grads": {k: p.grad.numpy() for k, p in m.named_parameters() if p.grad is not None}}


def _case_variants(group, rank):
    out = {}
    for variant in VARIANTS:
        with spatial_parallel(group, 2, rank):
            out[variant] = _variant_run(variant, (rank / 2, (rank + 1) / 2))
    return out


def _port_state(start_file, remat=""):
    from skyeye_tpu_torch.utils.checkpoint import restore_train_state

    model = SkyEyeDetectorModule(ModelConfig(**TINY), dtype=torch.float64, remat=remat).double()
    opt = RuntimeOptimizer(model, HYP, batch_size=16, accumulate=ACCUM)
    state = create_train_state(model, opt)
    restore_train_state(state, torch.load(start_file, weights_only=False))
    return state


def _state_tensors(state):
    sd = full_tensors(state.model.state_dict())
    out = {k: v.detach().clone() for k, v in sd.items() if not k.endswith("tracked")}
    out.update({f"ema:{k}": v.detach().clone() for k, v in full_tensors(state.ema.params).items()})
    return out


def _port_batch(s, size, mesh):
    b = _batch(s, size)
    arrays = {k: v for k, v in b.items() if k != "n_valid"}
    out = shard_batch(mesh, arrays, spatial=True) if mesh is not None else {
        k: torch.from_numpy(v) for k, v in arrays.items()}
    out["n_valid"] = int(b["n_valid"])
    out["opt_hyperparams"] = SCHED(s // ACCUM)
    return out


def _augment(images, targets, mask, generator, **kw):
    from skyeye_tpu_torch.data.device_aug import augment_batch_device

    return augment_batch_device(images, targets, mask, generator, hyp=dict(HYP, mixup=0.5), **kw)


def _port_steps(start_file, size, mesh, remat="", augment=False):
    state = _port_state(start_file, remat)
    model = state.model
    step = make_train_step(model, ComputeLoss(model.config.anchors, 3, hyp=HYP), state.opt,
                           mesh=mesh, device_augment=_augment if augment else None)
    results = []
    for s in range(2, 5):
        batch = _port_batch(s, size, mesh)
        if augment:  # every rank draws the global batch's numbers from one seed
            batch["aug_generator"] = torch.Generator().manual_seed(100 + s)
        state, m = step(state, batch)
        results.append(({k: float(v) for k, v in m.items()}, _state_tensors(state),
                        (state.step, state.ema.updates, state.opt.mini_step,
                         state.opt.gradient_step)))
    return results


def _pair_mesh(mesh22):
    """This half of the world as a (data 1, spatial 2) mesh: the spatial group
    of ``mesh22`` is its world."""
    singles = [dist.new_group([r]) for r in range(WORLD)]  # every rank makes every group
    mesh = Mesh([torch.device("cpu")], 1, n_spatial=2)
    mesh.group = singles[dist.get_rank()]
    mesh.spatial_group = mesh.world_group = mesh22.spatial_group
    return mesh


def _case_fsdp_raises(mesh22):
    from skyeye_tpu_torch.parallel import shard_train_state

    model = SkyEyeDetectorModule(ModelConfig(**TINY))
    state = create_train_state(model, RuntimeOptimizer(model, HYP, batch_size=16))
    try:
        shard_train_state(mesh22, state)
    except NotImplementedError as e:
        return str(e)
    return None


def _wait_for(spec, size, limit_s=900.0):
    """JAX's start state at ``size`` (a file the parent writes when JAX's run
    is done)."""
    import time

    path, t0 = Path(spec["start"][size]), time.monotonic()
    while not path.exists():
        if Path(spec["abort"]).exists() or time.monotonic() - t0 > limit_s:
            raise RuntimeError(f"no JAX start state at {size} px")
        time.sleep(0.2)
    return str(path)


def _worker(spec):
    """Every case, on one rank; a case that raises gives its traceback."""
    torch.set_num_threads(1)
    mesh22 = create_mesh(2, 2, devices=["cpu"])
    mesh14 = create_mesh(1, 4, devices=["cpu"])
    pair = _pair_mesh(mesh22)
    sp_group, sp_rank = mesh22.spatial_group, mesh22.spatial_rank
    cases = {
        "mesh": lambda: {"shape": dict(mesh22.shape), "rank": mesh22.rank,
                         "spatial_rank": sp_rank, "shape14": dict(mesh14.shape),
                         "share": {k: v.numpy() for k, v in shard_batch(
                             mesh22, {k: v for k, v in _batch(0, 64).items()
                                      if k != "n_valid"}, spatial=True).items()}},
        "exchange2": lambda: _case_exchange(sp_group, 2, sp_rank),
        "exchange4": lambda: _case_exchange(mesh14.spatial_group, 4, mesh14.spatial_rank),
        "blocks": lambda: _case_blocks(sp_group, sp_rank),
        "forward": lambda: _case_forward(sp_group, sp_rank, spec),
        "variants": lambda: _case_variants(sp_group, sp_rank),
        "fsdp": lambda: _case_fsdp_raises(mesh22),
    }
    for size in SIZES:
        for shape, mesh in (((1, 2), pair), ((2, 2), mesh22)):
            cases[("step", size, shape)] = (
                lambda size=size, mesh=mesh: _port_steps(_wait_for(spec, size), size, mesh))
    # remat's recompute runs the exchanges again, in the same order on every rank
    cases["step_remat"] = lambda: _port_steps(_wait_for(spec, 64), 64, pair, remat="stage")
    # the device augmentation: whole frames gathered over both axes, this rank's rows kept
    cases["step_augment"] = lambda: _port_steps(_wait_for(spec, 64), 64, mesh22, augment=True)
    out = {}
    for name, case in cases.items():
        try:
            out[name] = case()
        except Exception:
            out[name] = {"raised": traceback.format_exc()}
    return out


# -- the parent: JAX's side and the single-process references ---------------------------


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_spatial_run(size, shape):
    """JAX's state two micro-steps in on a spatial mesh of ``shape``, and its
    results for micro-steps 2, 3, 4 on it. The
    module computes in float64 (parameters float32), as the port's step here:
    in float32 both frameworks' steps part from their own one-device step by
    more than the allowances on these batches (a pooled maximum's winner, an
    assignment's rounding), with or without the spatial split."""
    import jax

    with jax.enable_x64(True):
        return _jax_spatial_run_x64(size, shape)


def _jax_spatial_run_x64(size, shape):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util
    from jax.sharding import NamedSharding, PartitionSpec as P

    from skyeye_tpu.config import ModelConfig as JModelConfig
    from skyeye_tpu.losses import ComputeLoss as JComputeLoss
    from skyeye_tpu.models.detector import SkyEyeDetectorModule as JDetector
    from skyeye_tpu.parallel import create_mesh as jcreate_mesh, shard_batch as jshard_batch
    from skyeye_tpu.train import build_optimizer_runtime, create_train_state as jcreate
    from skyeye_tpu.train import make_train_step as jmake_step
    from test_torch_port_train_step import _flat, _jax_reference_numerics

    cfg = JModelConfig(**TINY)
    module = JDetector(config=cfg, dtype=jnp.float64)
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    # BN statistics away from the identity, in float64: the float64 module's
    # update makes them float64 (float32 ones would compile the step twice)
    rng = np.random.default_rng(7)
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                 else rng.normal(0, 0.1, v.shape))
             for k, v in _flat(variables["batch_stats"]).items()}
    variables = {"params": variables["params"],
                 "batch_stats": traverse_util.unflatten_dict(
                     {tuple(k.split("/")): jnp.asarray(v) for k, v in stats.items()})}
    tx = build_optimizer_runtime(HYP, variables["params"], batch_size=16, accumulate=ACCUM)
    loss_fn = JComputeLoss(jnp.asarray(cfg.anchors), cfg.nc, hyp=HYP)

    mesh = jcreate_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])
    with _jax_reference_numerics(), jax.set_mesh(mesh):
        step = jax.jit(jmake_step(module, loss_fn, tx))
        state = jax.device_put(jcreate(variables, tx), NamedSharding(mesh, P()))
        results = []
        for s in range(5):
            batch = jshard_batch(mesh, dict(_batch(s, size)), spatial=True)
            batch["opt_hyperparams"] = {k: np.float32(v) for k, v in SCHED(s // ACCUM).items()}
            state, metrics = step(state, batch)
            if s == 1:
                start = jax.device_get(state)
            elif s > 1:
                results.append((jax.device_get(state), {k: float(v) for k, v in metrics.items()}))
    return start, results


def _save_start(jstart, path):
    import os

    from skyeye_tpu_torch.utils.checkpoint import from_jax_train_state

    torch.save(from_jax_train_state(jstart, accumulate=ACCUM), f"{path}.part")
    os.replace(f"{path}.part", path)  # whole when the workers see it
    return str(path)


def _jax_forward_setup():
    """``tests/test_parallel.py``'s spatial forward: the tiny model, x ~ N(0, 1)
    (4, 64, 64, 3), unsharded and on a (1, 2) spatial mesh."""
    import jax
    import jax.numpy as jnp

    from skyeye_tpu.config import ModelConfig as JModelConfig
    from skyeye_tpu.models import SkyEyeDetectorModule as JDetector
    from skyeye_tpu.parallel import batch_sharding, create_mesh as jcreate_mesh, replicated

    module = JDetector(config=JModelConfig(**TINY))
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 64, 64, 3))

    def fwd(v, xx):
        return [o.astype(jnp.float32) for o in module.apply(v, xx, train=False)]

    ref = jax.jit(fwd)(variables, x)
    mesh = jcreate_mesh(1, 2, devices=jax.devices()[:2])
    with jax.set_mesh(mesh):
        sharded = jax.jit(fwd)(jax.device_put(variables, replicated(mesh)),
                               jax.device_put(x, batch_sharding(mesh, spatial_dim=1)))
    return (jax.device_get(variables), np.asarray(x), [np.asarray(o) for o in ref],
            [np.asarray(o) for o in sharded])


def _write_frames(root: Path):
    from skyeye_tpu_torch.data.imageio import imwrite

    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(N_FRAMES):
        coarse = rng.randint(0, 256, (IMG // 8, IMG // 8, 3)).astype(np.uint8)
        imwrite(root / "images" / f"im{i}.png", coarse.repeat(8, 0).repeat(8, 1))
        lines = [f"{rng.randint(3)} {rng.uniform(0.3, 0.7):.6f} {rng.uniform(0.3, 0.7):.6f} "
                 f"{rng.uniform(0.15, 0.4):.6f} {rng.uniform(0.15, 0.4):.6f}"
                 for _ in range(0 if i == 2 else 3)]
        (root / "labels" / f"im{i}.txt").write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def _runs(tmp_path_factory):
    """The four ranks' results of every case (spawned once, on a thread of this
    process, while JAX runs its steps here) and JAX's runs."""
    import threading

    from skyeye_tpu_torch.utils.checkpoint import from_jax_variables
    from test_torch_port_train_step import _flat

    root = tmp_path_factory.mktemp("spatial")
    forward = _jax_forward_setup()
    variables, x, _, _ = forward
    flat = {f"params/{k}": v for k, v in _flat(variables["params"]).items()}
    flat.update({f"batch_stats/{k}": v for k, v in _flat(variables["batch_stats"]).items()})
    torch.save(from_jax_variables(flat), root / "forward.pt")
    np.save(root / "forward_x.npy", x)
    spec = {"start": {size: str(root / f"start{size}.pt") for size in SIZES},
            "abort": str(root / "abort"),
            "forward_weights": str(root / "forward.pt"),
            "forward_input": str(root / "forward_x.npy")}
    box = {}

    def spawn():
        try:
            box["results"] = launch(_worker, WORLD, kwargs={"spec": spec}, device="cpu",
                                    timeout_s=300)
        except BaseException as e:  # re-raised below
            box["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    steps = {}
    try:
        for size in SIZES:
            steps[size] = _jax_spatial_run(size, JAX_MESH[size])
            _save_start(steps[size][0], spec["start"][size])
    except BaseException:
        Path(spec["abort"]).touch()
        raise
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return spec, box["results"], {"steps": steps, "forward": forward}


@pytest.fixture(scope="module")
def ranks(_runs):
    spec, results, _ = _runs
    return spec, results


@pytest.fixture(scope="module")
def jax_runs(_runs):
    return _runs[2]


def _case(ranks, name):
    _, results = ranks
    out = [r[name] for r in results]
    for r, o in enumerate(out):
        assert not (isinstance(o, dict) and "raised" in o), f"rank {r}:\n{o['raised']}"
    return out


def test_mesh_is_jax_2d_mesh_and_shard_batch_gives_jax_shards(ranks):
    import jax

    from skyeye_tpu.parallel import create_mesh as jcreate_mesh, shard_batch as jshard

    jmesh = jcreate_mesh(2, 2, devices=jax.devices()[:4])
    jshards = jshard(jmesh, {k: v for k, v in _batch(0, 64).items() if k != "n_valid"},
                     spatial=True)
    devices = list(np.asarray(jmesh.devices).reshape(-1))
    for rank, got in enumerate(_case(ranks, "mesh")):
        assert got["shape"] == dict(jmesh.shape) == {"data": 2, "spatial": 2}
        assert got["shape14"] == {"data": 1, "spatial": 4}
        assert (got["rank"], got["spatial_rank"]) == divmod(rank, 2)  # JAX's reshape
        for k, arr in jshards.items():
            shard = next(s for s in arr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(got["share"][k], np.asarray(shard.data))
    # one process: a mesh of local devices, one share per (data, spatial) position
    local = create_mesh(1, n_spatial=2, devices=["cpu", "cpu"])
    assert local.shape == {"data": 1, "spatial": 2} and local.group is None
    shares = shard_batch(local, {"images": _batch(0, 64)["images"]}, spatial=True)
    assert [tuple(s["images"].shape) for s in shares] == [(B, 32, 64, 3)] * 2
    with pytest.raises(ValueError, match="multiple of 32 x 2 = 64"):
        shard_batch(local, {"images": np.zeros((B, 96, 64, 3), np.uint8)}, spatial=True)


def test_batch_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = create_mesh(1, n_spatial=2, devices=["cpu", "cpu"])
    assert mesh.n_spatial == 2
    from skyeye_tpu_torch.parallel import batch_sharding

    assert batch_sharding(mesh, spatial_dim=1) == (Shard(0), Shard(1))
    assert batch_sharding(mesh) == (Shard(0),)
    assert batch_sharding(create_mesh(1, devices=["cpu"]), spatial_dim=1) == (Shard(0),
                                                                             Replicate())


def _exchange_want(n):
    """One process's exchange: each rank's window of the padded whole tensor, and
    the gradient of the sum of every rank's loss."""
    x, g = _exchange_inputs(n)
    h = x.shape[2] // n
    want = {}
    for above, below, fill in HALOS:
        xt = torch.from_numpy(x.copy()).requires_grad_(True)
        pad = torch.nn.functional.pad(xt, (0, 0, above, below), value=0.0)
        wins = [pad[:, :, r * h:r * h + h + above + below] for r in range(n)]
        sum((w * torch.from_numpy(g[(above, below, fill)][r])).sum()
            for r, w in enumerate(wins)).backward()
        want[(above, below, fill)] = xt.grad.numpy()
    gather_grad = g["gather"].sum(axis=0)
    split_grad = [np.zeros_like(x) for _ in range(n)]
    for r in range(n):
        split_grad[r][:, :, r * h:(r + 1) * h] = g["split"][r]
    return x, g, want, gather_grad, split_grad


@pytest.mark.parametrize("n", [2, 4])
def test_halo_gather_split_match_one_process(ranks, n):
    x, g, want, gather_grad, split_grad = _exchange_want(n)
    got = _case(ranks, f"exchange{n}")[:n]  # the (1, 4) mesh, or the first (1, 2) half
    h = x.shape[2] // n
    for halo in HALOS:
        above, below, fill = halo
        dx = want[halo]
        for r in range(n):
            y = got[r][halo][0]
            top, bot = r * h - above, r * h + h + below  # rows of the whole image
            rows = np.arange(top, bot)
            inside = (rows >= 0) & (rows < x.shape[2])
            np.testing.assert_array_equal(y[:, :, inside], x[:, :, rows[inside]])
            assert (y[:, :, ~inside] == fill).all(), (halo, r)
        np.testing.assert_allclose(np.concatenate([got[r][halo][1] for r in range(n)], 2), dx,
                                   rtol=1e-12, atol=1e-12, err_msg=str(halo))
    for r in range(n):
        np.testing.assert_array_equal(got[r]["gather"][0], x)
        np.testing.assert_allclose(got[r]["gather"][1], gather_grad[:, :, r * h:(r + 1) * h],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(got[r]["split"][0], x[:, :, r * h:(r + 1) * h])
        np.testing.assert_array_equal(got[r]["split"][1], split_grad[r])
        np.testing.assert_allclose(got[r]["sum"][0], x.sum(axis=(2, 3)), rtol=1e-12)
        np.testing.assert_array_equal(got[r]["max"][0], x.max(axis=(2, 3)))
    total = g["reduce"].sum(axis=0)
    for name, local_of in (("sum", lambda r: np.ones_like(total)),
                           ("max", lambda r: (x[:, :, r * h:(r + 1) * h].max(axis=(2, 3))
                                              == x.max(axis=(2, 3))).astype(np.float64))):
        for r in range(n):
            np.testing.assert_allclose(got[r][name][1], total * local_of(r), rtol=1e-12,
                                       atol=1e-12)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", list(_block_cases()))
def test_block_under_spatial_two_matches_one_process(ranks, name):
    want = _block_run(name, _block_inputs(name), (0.0, 1.0))
    got = [r[name] for r in _case(ranks, "blocks")]
    assert all(np.array_equal(a, b) for a, b in zip(got[0]["y"][0], got[2]["y"][0]))  # halves
    for i, y in enumerate(want["y"]):
        joined = np.concatenate([got[0]["y"][i], got[1]["y"][i]], 2)
        assert _rel(joined, y) <= BLOCK_REL, (name, "output", i, _rel(joined, y))
    for i, dx in enumerate(want["dx"]):
        joined = np.concatenate([got[0]["dx"][i], got[1]["dx"][i]], 2)
        assert _rel(joined, dx) <= BLOCK_REL, (name, "input grad", i, _rel(joined, dx))
    gmax = max(float(np.abs(g).max()) for g in want["dparams"].values())
    assert set(got[0]["dparams"]) == set(want["dparams"])
    for k, g in want["dparams"].items():
        err = float(np.abs(got[0]["dparams"][k] + got[1]["dparams"][k] - g).max())
        assert err <= BLOCK_REL * gmax, (name, k, err / gmax)
    for k, s in want["stats"].items():  # the world's statistics on both ranks
        for r in (0, 1):
            np.testing.assert_allclose(got[r]["stats"][k], s, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {k}")


def test_model_forward_matches_jax_spatial_mesh(ranks, jax_runs):
    _, _, ref, sharded = jax_runs["forward"]
    got = _case(ranks, "forward")
    for level, (r, s) in enumerate(zip(ref, sharded)):
        joined = np.concatenate([got[0][level], got[1][level]], 1)  # (B, H, W, na, no)
        np.testing.assert_allclose(joined, r, rtol=1e-4, atol=1e-5, err_msg=f"level {level}")
        np.testing.assert_allclose(joined, s, rtol=1e-4, atol=1e-5, err_msg=f"level {level}")


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_forward_and_gradients_match_one_process(ranks, variant):
    want = _variant_run(variant, (0.0, 1.0))
    got = [r[variant] for r in _case(ranks, "variants")[:2]]
    rel = VARIANT_REL[variant]
    assert got[0]["loss"] + got[1]["loss"] == pytest.approx(want["loss"], rel=rel)
    for level, o in enumerate(want["outs"]):
        joined = np.concatenate([got[0]["outs"][level], got[1]["outs"][level]], 1)
        assert _rel(joined, o) <= rel, (level, _rel(joined, o))
    gmax = max(float(np.abs(g).max()) for g in want["grads"].values())
    for k, g in want["grads"].items():
        err = float(np.abs(got[0]["grads"][k] + got[1]["grads"][k] - g).max())
        assert err <= rel * gmax, (k, err / gmax)


def _tensors(jstate):
    from test_torch_port_train_step import _tensors as jtensors

    return jtensors(jstate)


def _errors(got, want, start, after_update):
    errs = {}
    for k, w in want.items():
        stats = k.endswith(("running_mean", "running_var"))
        c = STATS_AFTER_UPDATE_CHANGE_REL if after_update and stats else CHANGE_REL
        allowed = STATE_REL * float(w.abs().max()) + c * float((w - start[k]).abs().max())
        err = float((got[k].double() - w.double()).abs().max())
        errs[k] = err / allowed if allowed > 0 else (0.0 if err == 0 else float("inf"))
    return errs


def _check_against(per_rank, refs, start):
    """Each rank's 3 micro-steps against ``refs``: [(metrics, tensors)] per micro-step."""
    for i, (metrics, tensors) in enumerate(refs):
        after_update = i == 2
        rel = LOSS_AFTER_UPDATE_REL if after_update else LOSS_REL
        for rank, run in enumerate(per_rank):
            m, got, _ = run[i]
            for k in ("loss", "box", "obj", "cls"):
                assert m[k] == pytest.approx(metrics[k], rel=rel), (rank, i, k)
            bad = {k: e for k, e in _errors(got, tensors, start, after_update).items() if e > 1.0}
            assert not bad, (rank, i, sorted(bad.items(), key=lambda kv: -kv[1])[:5])
        first = per_rank[0][i][1]
        for run in per_rank[1:]:
            assert all(torch.equal(first[k], run[i][1][k]) for k in first), \
                "the ranks' states differ"


@pytest.fixture(scope="module")
def one_process(ranks):
    """The port's one-process step from each size's start."""
    spec, _ = ranks
    return {size: _port_steps(spec["start"][size], size, None) for size in SIZES}


@pytest.mark.parametrize("shape", MESHES, ids=["data1_spatial2", "data2_spatial2"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{s}px" for s in SIZES])
def test_spatial_steps_match_jax_and_one_process(ranks, jax_runs, one_process, size, shape):
    jstart, jresults = jax_runs["steps"][size]
    start = {k: torch.as_tensor(v) for k, v in _tensors(jstart).items()}
    per_rank = _case(ranks, ("step", size, shape))
    if shape == (1, 2):  # both halves of the world ran the (1, 2) mesh
        for a, b in zip(per_rank[0], per_rank[2]):
            assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        per_rank = per_rank[:2]
    jax_refs = [(jm, {k: torch.as_tensor(v) for k, v in _tensors(js).items()})
                for js, jm in jresults]
    _check_against(per_rank, jax_refs, start)
    _check_against(per_rank, [(m, t) for m, t, _ in one_process[size]], start)
    for i, (jstate, _) in enumerate(jresults):
        inner = jstate.opt_state.inner_state
        assert per_rank[0][i][2] == (int(jstate.step), int(jstate.ema.updates),
                                     int(inner.mini_step), int(inner.gradient_step))


def test_remat_composes_with_spatial_sharding(ranks, jax_runs, one_process):
    jstart, _ = jax_runs["steps"][64]
    start = {k: torch.as_tensor(v) for k, v in _tensors(jstart).items()}
    per_rank = _case(ranks, "step_remat")[:2]
    _check_against(per_rank, [(m, t) for m, t, _ in one_process[64]], start)
    plain = _case(ranks, ("step", 64, (1, 2)))[:2]
    for run, ref in zip(per_rank, plain):  # the recompute changes nothing
        for (m, t, c), (m0, t0, c0) in zip(run, ref):
            assert m == m0 and c == c0 and all(torch.equal(t[k], t0[k]) for k in t)


def test_device_augmentation_under_a_spatial_mesh_matches_one_process(ranks, jax_runs):
    spec, _ = ranks
    jstart, _ = jax_runs["steps"][64]
    start = {k: torch.as_tensor(v) for k, v in _tensors(jstart).items()}
    want = _port_steps(spec["start"][64], 64, None, augment=True)
    _check_against(_case(ranks, "step_augment"), [(m, t) for m, t, _ in want], start)


def test_fsdp_over_a_spatial_mesh_raises_naming_its_item(ranks):
    for msg in _case(ranks, "fsdp"):
        assert msg is not None and "item 8c" in msg


def _cli_kwargs(root):
    data = {"path": str(root / "data"), "train": "images", "val": "images", "nc": 3,
            "names": ["a", "b", "c"]}
    return dict(cfg=dict(TINY, variant="s"), data=data, epochs=1, batch_size=CLI_BATCH,
                img_size=IMG, accumulate=2, workers=1, project=str(root / "runs"),
                exist_ok=True, seed=0, device_aug=True, device="cpu")


def _results_rows(save_dir):
    with open(Path(save_dir) / "results.csv") as f:
        return [[float(v) for v in row] for row in list(csv.reader(f))[1:]]


def test_cli_train_spatial_shards_two_matches_world_one(tmp_path):
    from skyeye_tpu_torch.cli.train import train

    _write_frames(tmp_path / "data")
    kw = _cli_kwargs(tmp_path)
    _, two = train(**kw, name="spatial2", spatial_shards=2)
    _, one = train(**kw, name="world1")
    got, want = _results_rows(two), _results_rows(one)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0][:4], want[0][:4], rtol=1e-4)   # epoch, train losses
    np.testing.assert_allclose(got[0][4:8], want[0][4:8], atol=1e-3)  # P, R, mAPs
    np.testing.assert_allclose(got[0][8:], want[0][8:], rtol=1e-3)   # val losses, lr
    a = torch.load(Path(two) / "weights" / "last.pt", weights_only=False)
    b = torch.load(Path(one) / "weights" / "last.pt", weights_only=False)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
    from skyeye_tpu_torch.models.detector import create_detector

    init = create_detector(dict(TINY, variant="s"), num_classes=3, device="cpu",
                           seed=0).state_dict()
    for key in ("state_dict", "train_state_dict"):
        for k, w in b[key].items():
            if w.is_floating_point():
                allowed = (STATE_REL * float(w.abs().max())
                           + CHANGE_REL * float((w - init[k]).abs().max()))
                assert float((a[key][k] - w).abs().max()) <= allowed, (key, k)
    assert sorted(p.name for p in Path(two).parent.iterdir()) == ["spatial2", "world1"]
