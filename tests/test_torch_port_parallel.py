"""The port's multi-device runs (``skyeye_tpu_torch.parallel``) against JAX's
and against one process, on the CPU: two ranks in a gloo process group.

The workers are spawned once for the module (``parallel.launch``, one torch
thread each): each runs every case below and hands its results back; the
tests read them. JAX runs in this process, on two of its eight virtual CPU
devices.

  * the mesh helpers: shapes, ``local_batch_size``'s error, the rows
    ``shard_batch`` gives each rank, ``replicate_multihost`` (and its error
    when the ranks disagree), ``is_main_process``;
  * synced BatchNorm: the output, the running statistics and the input's
    gradient of each rank's half against one process on the whole batch,
    also inside a ``remat`` region (whose recompute runs the collectives
    again and leaves the statistics alone);
  * the loss: the ranks' partial losses, and their gradients, sum to
    ``ComputeLoss`` (gather and dense forms, with and without image weights)
    and to ``AerialDetectionLoss`` on the global batch, with one rank holding
    no targets;
  * the data-parallel step: 3 micro-steps from a JAX mid-run state (two
    micro-steps in, accumulate 2) against JAX's step over a 2-device data
    mesh, at the single-card step's tolerances
    (``test_torch_port_train_step.py``: loss within 1e-5 relative, every
    parameter, BatchNorm statistic and EMA tensor within 1e-4 x max|w| +
    1e-3 x max|change|; after the update, 1e-3 and 1e-2 for the statistics),
    one batch row with no targets and one wrap-around row (n_valid 3 of 4);
    the two ranks' states bitwise equal;
  * FSDP: the same 3 micro-steps against JAX's FSDP step
    (``jit_fsdp_step``), each parameter's, momentum's and EMA tensor's
    placement that of ``leaf_sharding`` (JAX's dimension, checked against
    JAX's ``leaf_sharding`` on JAX's variables), each rank holding about half
    the parameter bytes;
  * the loader: each rank's share of a global batch, with host augmentation
    and with the device augmentation of the step, equal to the single-process
    batch's rows;
  * ``cli.train`` at world 2 (plain and FSDP) against world 1;
  * ``initialize_distributed`` with explicit arguments and
    ``shard_batch_multihost``, as ``tests/test_train.py`` does for JAX;
  * ``SkyEyeDetector(mesh=)`` with 2 CPU replicas against the unmeshed
    detector (equal) and against JAX's ``mesh=`` serving on 2 virtual
    devices, index for index, at B 3 and 8.
"""
import csv
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from skyeye_tpu_torch.config import DEFAULT_HYP, ModelConfig
from skyeye_tpu_torch.losses import AerialDetectionLoss, ComputeLoss
from skyeye_tpu_torch.models import blocks as tblocks
from skyeye_tpu_torch.models.detector import SkyEyeDetectorModule
from skyeye_tpu_torch.parallel import (
    DATA_AXIS, create_mesh, data_parallel, is_main_process, jit_fsdp_step, launch,
    leaf_sharding, local_batch_size, replicate_multihost, shard_batch,
    shard_batch_multihost, shard_train_state, state_shardings,
)
from skyeye_tpu_torch.parallel.collectives import gather_rows
from skyeye_tpu_torch.parallel.fsdp import full_tensors, param_layouts
from skyeye_tpu_torch.train import (
    RuntimeOptimizer, create_train_state, host_schedule, make_train_step,
)

TINY = dict(nc=3, base_channels=16, depth_multiple=0.33, width_multiple=0.25)
ACCUM, B, M, SIZE, WORLD = 2, 4, 8, 64, 2
HYP = dict(DEFAULT_HYP)
SCHED = host_schedule(HYP, 3, 4, warmup_steps=2)
LOSS_REL, LOSS_AFTER_UPDATE_REL = 1e-5, 1e-3
STATE_REL, CHANGE_REL, STATS_AFTER_UPDATE_CHANGE_REL = 1e-4, 1e-3, 1e-2
N_FRAMES, IMG, CLI_BATCH = 8, 64, 4
MESH_BOX_ATOL, MESH_SCORE_ATOL = 1e-3, 1e-5
JAX_CONF = 0.005


def _batch(seed):
    """A global batch of B: row 1 holds no targets; from the second micro-step
    on, row 3 is a wrap-around copy (n_valid 3)."""
    rng = np.random.default_rng(seed)
    t = np.zeros((B, M, 6), np.float32)
    mask = np.zeros((B, M), bool)
    for b in range(B):
        for i in range(0 if b == 1 else 4):
            t[b, i] = [0, rng.integers(0, 3), *rng.uniform(0.25, 0.75, 2),
                       *rng.uniform(0.1, 0.35, 2)]
            mask[b, i] = True
    return {"images": rng.integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8),
            "targets": t, "mask": mask, "n_valid": np.int32(3 if seed % 2 else B)}


def _rows(rank):
    lo = rank * (B // WORLD)
    return slice(lo, lo + B // WORLD)


# -- the workers' cases (torch only: the spawned workers import this module) --------


def _case_mesh(mesh):
    rank = mesh.rank
    out = {"shape": dict(mesh.shape), "rank": rank, "main": is_main_process(),
           "local": local_batch_size(8, mesh)}
    try:
        local_batch_size(7, mesh)
    except ValueError as e:
        out["error"] = str(e)
    share = shard_batch(mesh, _batch(0))
    out["share"] = {k: v.numpy() for k, v in share.items()}
    rep = replicate_multihost(mesh, {"w": torch.arange(6.0)})
    out["replicated"] = rep["w"].numpy()
    try:
        replicate_multihost(mesh, {"w": torch.full((3,), float(rank))})
        out["disagree"] = None
    except ValueError as e:
        out["disagree"] = str(e)
    return out


def _bn_input():
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (B, 6, 5, 7)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (B, 6, 5, 7)).astype(np.float32)
    return x, g


def _bn_module():
    bn = tblocks.BatchNorm2d(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, 6))
        bn.running_var.fill_(0.8)
    return bn.train()


def _bn_run(bn, x, g, remat, group):
    x = torch.from_numpy(x).requires_grad_(True)
    with data_parallel(group):
        y = (tblocks.remat(lambda t: bn(t) * 1.0, x) if remat else bn(x))
        (y * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy(), "tracked": int(bn.num_batches_tracked),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy()}


def _case_bn(mesh):
    x, g = _bn_input()
    rows = _rows(mesh.rank)
    return {remat: _bn_run(_bn_module(), x[rows], g[rows], remat, mesh.group)
            for remat in (False, True)}


def _predictions(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (B, s, s, 3, 8)).astype(np.float32) for s in (8, 4, 2)]


def _loss_fns():
    anchors = ModelConfig(**TINY).anchors
    return {"gather": ComputeLoss(anchors, 3, hyp=HYP),
            "dense": ComputeLoss(anchors, 3, hyp=HYP, dense=True),
            "aerial": AerialDetectionLoss(anchors, 3)}


def _loss_run(name, fn, preds, batch, rows, group, weighted):
    preds = [torch.from_numpy(p[rows]).requires_grad_(True) for p in preds]
    t = batch["targets"][rows].copy()
    n = t.shape[0]
    t[:, :, 0] = np.arange(n)[:, None]
    targets, mask = torch.from_numpy(t.reshape(-1, 6)), torch.from_numpy(
        batch["mask"][rows].reshape(-1))
    start = rows.start or 0
    with data_parallel(group):
        if weighted:
            w = (torch.arange(start, start + n) < int(batch["n_valid"])).float()
            loss, aux = fn(preds, targets, mask, img_weight=w)
        else:
            loss, aux = fn(preds, targets, mask)
    loss.backward()
    return {"loss": float(loss.detach()), "aux": aux.numpy(),
            "grads": [p.grad.numpy() for p in preds]}


def _loss_cases():
    return [(name, weighted) for name in ("gather", "dense", "aerial")
            for weighted in (False, True) if not (name == "aerial" and weighted)]


def _case_loss(mesh):
    preds, batch = _predictions(4), _batch(1)
    fns = _loss_fns()
    return {(name, w): _loss_run(name, fns[name], preds, batch, _rows(mesh.rank), mesh.group, w)
            for name, w in _loss_cases()}


def _case_device_aug(mesh):
    from skyeye_tpu_torch.data.device_aug import augment_batch_device

    batch = _batch(2)
    rows = _rows(mesh.rank)
    local = [torch.from_numpy(batch[k][rows]) for k in ("images", "targets", "mask")]
    images, targets, mask = (gather_rows(t, mesh.group) for t in local)
    gen = torch.Generator().manual_seed(11)
    got = augment_batch_device(images.float() / 255.0, targets, mask, gen,
                               hyp=dict(HYP, mixup=0.5),
                               rows=torch.arange(rows.start, rows.stop))
    return [t.numpy() for t in got]


def _loader(data_dir, rank, world, augment):
    from skyeye_tpu_torch.data.dataset import create_dataloader

    loader, _ = create_dataloader(str(data_dir), img_size=IMG, batch_size=6,
                                  augment=augment, workers=1, seed=3, shuffle=True,
                                  rank=rank, world=world)
    return [dict(b) for b in loader]  # 8 frames: a full batch, then 2 real rows of 6


def _case_loader(mesh, spec):
    return {aug: _loader(spec["data_dir"], mesh.rank, mesh.size, aug) for aug in (False, True)}


def _port_state(start_file, model_cls=SkyEyeDetectorModule):
    from skyeye_tpu_torch.utils.checkpoint import restore_train_state

    model = model_cls(ModelConfig(**TINY))
    opt = RuntimeOptimizer(model, HYP, batch_size=16, accumulate=ACCUM)
    state = create_train_state(model, opt)
    restore_train_state(state, torch.load(start_file, weights_only=False))
    return state


def _state_tensors(state):
    sd = full_tensors(state.model.state_dict())
    out = {k: v.detach().clone() for k, v in sd.items() if not k.endswith("tracked")}
    out.update({f"ema:{k}": v.detach().clone() for k, v in full_tensors(state.ema.params).items()})
    return out


def _port_batch(s, rows):
    b = _batch(s)
    out = {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in b.items() if k != "n_valid"}
    out["n_valid"] = int(b["n_valid"])
    out["opt_hyperparams"] = SCHED(s // ACCUM)
    return out


def _case_step(mesh, start_file, fsdp):
    state = _port_state(start_file)
    model = state.model
    step = make_train_step(model, ComputeLoss(model.config.anchors, 3, hyp=HYP), state.opt,
                           mesh=mesh)
    out = {}
    if fsdp:
        shard_train_state(mesh, state)
        step = jit_fsdp_step(step, mesh, state)
        from torch.distributed.tensor import DTensor

        want = state_shardings(mesh, state)
        named = {f"model:{k}": p for k, p in model.named_parameters()}
        named.update({f"ema:{k}": t for k, t in state.ema.params.items()})
        named.update({f"opt.trace:{k}": t for k, t in state.opt.trace.items()})
        named.update({f"opt.acc_grads:{k}": t for k, t in state.opt.acc_grads.items()})
        out["placements"] = {
            k: (str(want[k][0]), str(t.placements[0]) if isinstance(t, DTensor) else "whole")
            for k, t in named.items()}
        local = sum((p.to_local() if isinstance(p, DTensor) else p).numel()
                    for p in model.parameters())
        out["param_fraction"] = local / sum(p.numel() for p in model.parameters())
    results = []
    for s in range(2, 5):
        state, m = step(state, _port_batch(s, _rows(mesh.rank)))
        results.append(({k: float(v) for k, v in m.items()}, _state_tensors(state),
                         (state.step, state.ema.updates, state.opt.mini_step,
                          state.opt.gradient_step)))
    out["results"] = results
    return out


def _case_cli(spec, fsdp):
    """The run directory, and the training states ``cli.train`` sharded (FSDP's
    entry point, counted)."""
    from unittest import mock

    import skyeye_tpu_torch.parallel as parallel
    from skyeye_tpu_torch.cli.train import train

    sharded, real = [], parallel.shard_train_state

    def counted(mesh, state, *a, **k):
        sharded.append(type(state).__name__)
        return real(mesh, state, *a, **k)

    with mock.patch.object(parallel, "shard_train_state", counted):
        _, save_dir = train(**spec["cli"], name=f"world{WORLD}{'_fsdp' if fsdp else ''}",
                            fsdp=fsdp)
    return str(save_dir), sharded


def _worker(spec):
    """Every case, on one rank; a case that raises gives its traceback."""
    torch.set_num_threads(1)
    mesh = create_mesh(devices=["cpu"])
    cases = {
        "mesh": lambda: _case_mesh(mesh),
        "bn": lambda: _case_bn(mesh),
        "loss": lambda: _case_loss(mesh),
        "device_aug": lambda: _case_device_aug(mesh),
        "loader": lambda: _case_loader(mesh, spec),
        "step": lambda: _case_step(mesh, spec["start"], fsdp=False),
        "fsdp": lambda: _case_step(mesh, spec["fsdp_start"], fsdp=True),
        "cli": lambda: _case_cli(spec, fsdp=False),
        "cli_fsdp": lambda: _case_cli(spec, fsdp=True),
    }
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


def _jax_mesh_run(fsdp):
    """JAX's state two micro-steps in, and its results for micro-steps 2, 3, 4,
    over a 2-device data mesh (``fsdp``: JAX's FSDP step)."""
    import jax
    import jax.numpy as jnp
    from flax import traverse_util
    from jax.sharding import NamedSharding, PartitionSpec as P

    from skyeye_tpu.config import ModelConfig as JModelConfig
    from skyeye_tpu.losses import ComputeLoss as JComputeLoss
    from skyeye_tpu.models.detector import SkyEyeDetectorModule as JDetector
    from skyeye_tpu.parallel import (
        create_mesh as jcreate_mesh, jit_fsdp_step as jfsdp_step,
        shard_batch as jshard_batch, shard_train_state as jshard_state,
    )
    from skyeye_tpu.train import build_optimizer_runtime, create_train_state as jcreate
    from skyeye_tpu.train import make_train_step as jmake_step
    from test_torch_port_train_step import _flat, _jax_reference_numerics

    cfg = JModelConfig(**TINY)
    module = JDetector(config=cfg)
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
    mesh = jcreate_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    with _jax_reference_numerics():
        raw = jmake_step(module, loss_fn, tx)
        state = jcreate(variables, tx)
        if fsdp:
            state = jshard_state(mesh, state)
            step = jfsdp_step(raw, mesh, state)
        else:
            state = jax.device_put(state, NamedSharding(mesh, P()))
            step = jax.jit(raw)
        results = []
        for s in range(5):
            b = _batch(s)
            batch = jshard_batch(mesh, {k: v for k, v in b.items()})
            batch["opt_hyperparams"] = {k: np.float32(v) for k, v in SCHED(s // ACCUM).items()}
            state, metrics = step(state, batch)
            if s == 1:
                start = jax.device_get(state)
            elif s > 1:
                results.append((jax.device_get(state),
                                {k: float(v) for k, v in metrics.items()}))
    return start, results, (mesh, state, variables)


def _save_start(jstart, path):
    from skyeye_tpu_torch.utils.checkpoint import from_jax_train_state

    torch.save(from_jax_train_state(jstart, accumulate=ACCUM), path)
    return str(path)


@pytest.fixture(scope="module")
def jax_runs():
    return {"step": _jax_mesh_run(fsdp=False), "fsdp": _jax_mesh_run(fsdp=True)}


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """The two ranks' results of every case (spawned once)."""
    root = tmp_path_factory.mktemp("parallel")
    _write_frames(root / "data")
    spec = {
        "data_dir": str(root / "data" / "images"),
        "start": _save_start(jax_runs["step"][0], root / "start.pt"),
        "fsdp_start": _save_start(jax_runs["fsdp"][0], root / "fsdp_start.pt"),
        "cli": _cli_kwargs(root),
    }
    results = launch(_worker, WORLD, kwargs={"spec": spec}, device="cpu", timeout_s=240)
    return spec, results


def _cli_kwargs(root):
    data = {"path": str(root / "data"), "train": "images", "val": "images", "nc": 3,
            "names": ["a", "b", "c"]}
    # accumulate 2: one optimizer step in the epoch, as in the step tests (a second
    # step on parameters each run updated itself grows float32's rounding past
    # the state allowance on this tiny net)
    return dict(cfg=dict(TINY, variant="s"), data=data, epochs=1, batch_size=CLI_BATCH,
                img_size=IMG, accumulate=2, workers=1, project=str(root / "runs"),
                exist_ok=True, seed=0, device="cpu")


def _case(ranks, name):
    _, results = ranks
    out = [r[name] for r in results]
    for r, o in enumerate(out):
        assert not (isinstance(o, dict) and "raised" in o), f"rank {r}:\n{o['raised']}"
    return out


def test_mesh_helpers_match_jax(ranks):
    import jax

    from skyeye_tpu.parallel import (
        create_mesh as jcreate_mesh, local_batch_size as jlocal, shard_batch as jshard,
    )

    jmesh = jcreate_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    with pytest.raises(ValueError) as jerr:
        jlocal(7, jmesh)
    jshards = jshard(jmesh, {k: v for k, v in _batch(0).items() if k != "n_valid"})
    for rank, got in enumerate(_case(ranks, "mesh")):
        assert got["shape"] == {DATA_AXIS: jmesh.shape["data"], "spatial": jmesh.shape["spatial"]}
        assert got["rank"] == rank and got["main"] == (rank == 0)
        assert got["local"] == jlocal(8, jmesh) == 4
        assert got["error"] == str(jerr.value)
        for k, arr in jshards.items():
            want = np.asarray(arr.addressable_shards[rank].data)
            np.testing.assert_array_equal(got["share"][k], want)
        np.testing.assert_array_equal(got["replicated"], np.arange(6.0))
        assert "different values" in got["disagree"]
    local = create_mesh(WORLD, devices=["cpu", "cpu"])
    assert local.shape[DATA_AXIS] == WORLD and local.group is None
    shares = shard_batch(local, _batch(0))
    assert [tuple(s["images"].shape) for s in shares] == [(2, SIZE, SIZE, 3)] * 2
    # a spatial axis: one share per (data, spatial) position, JAX's shards
    jmesh2 = jcreate_mesh(1, 2, devices=jax.devices()[:2])
    spatial = create_mesh(1, n_spatial=2, devices=["cpu", "cpu"])
    assert spatial.shape == dict(jmesh2.shape) == {DATA_AXIS: 1, "spatial": 2}
    batch = {k: v for k, v in _batch(0).items() if k != "n_valid"}
    jspatial = jshard(jmesh2, batch, spatial=True)
    for i, got in enumerate(shard_batch(spatial, batch, spatial=True)):
        for k, arr in jspatial.items():
            want = next(s for s in arr.addressable_shards if s.device == jax.devices()[i])
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want.data))
    with pytest.raises(ValueError, match="multiple of 32 x 2"):
        shard_batch(spatial, {"images": np.zeros((2, 32, 32, 3), np.uint8)}, spatial=True)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_synced_batchnorm_is_one_process_on_the_global_batch(ranks, remat):
    x, g = _bn_input()
    want = _bn_run(_bn_module(), x, g, False, None)
    got = [r[remat] for r in _case(ranks, "bn")]
    for rank, r in enumerate(got):
        rows = _rows(rank)
        np.testing.assert_allclose(r["y"], want["y"][rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["dx"], want["dx"][rows], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["mean"], want["mean"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["var"], want["var"], rtol=1e-6, atol=1e-6)
        assert r["tracked"] == want["tracked"] == 1  # the recompute left them alone
    np.testing.assert_allclose(got[0]["dw"] + got[1]["dw"], want["dw"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0]["db"] + got[1]["db"], want["db"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,weighted", _loss_cases())
def test_partial_losses_sum_to_the_global_batch_loss(ranks, name, weighted):
    preds, batch = _predictions(4), _batch(1)
    assert not batch["mask"][_rows(0)].any(axis=1).all()  # row 1: no targets
    want = _loss_run(name, _loss_fns()[name], preds, batch, slice(0, B), None, weighted)
    got = [r[(name, weighted)] for r in _case(ranks, "loss")]
    assert got[0]["loss"] + got[1]["loss"] == pytest.approx(want["loss"], rel=1e-6)
    np.testing.assert_allclose(got[0]["aux"] + got[1]["aux"], want["aux"], rtol=1e-5)
    for level in range(3):
        grad = np.concatenate([got[0]["grads"][level], got[1]["grads"][level]])
        np.testing.assert_allclose(grad, want["grads"][level], rtol=1e-5, atol=1e-9)


def _tensors(jstate):
    from test_torch_port_train_step import _tensors as jtensors

    return jtensors(jstate)


def _errors(got, jstate, jstart, after_update):
    before = _tensors(jstart)
    errs = {}
    for k, w in _tensors(jstate).items():
        stats = k.endswith(("running_mean", "running_var"))
        c = STATS_AFTER_UPDATE_CHANGE_REL if after_update and stats else CHANGE_REL
        allowed = STATE_REL * float(w.abs().max()) + c * float((w - before[k]).abs().max())
        err = float((got[k].double() - w.double()).abs().max())
        errs[k] = err / allowed if allowed > 0 else (0.0 if err == 0 else float("inf"))
    return errs


def _check_steps(jax_run, per_rank):
    jstart, jresults, _ = jax_run
    for i, (jstate, jm) in enumerate(jresults):
        after_update = i == 2
        rel = LOSS_AFTER_UPDATE_REL if after_update else LOSS_REL
        for rank, run in enumerate(per_rank):
            m, tensors, counters = run["results"][i]
            for k in ("loss", "box", "obj", "cls"):
                assert m[k] == pytest.approx(jm[k], rel=rel), (rank, i, k)
            bad = {k: e for k, e in _errors(tensors, jstate, jstart, after_update).items()
                   if e > 1.0}
            assert not bad, (rank, i, sorted(bad.items(), key=lambda kv: -kv[1])[:5])
            inner = jstate.opt_state.inner_state
            assert counters == (int(jstate.step), int(jstate.ema.updates),
                                int(inner.mini_step), int(inner.gradient_step))
        a, b = per_rank[0]["results"][i][1], per_rank[1]["results"][i][1]
        assert all(torch.equal(a[k], b[k]) for k in a), "the ranks' states differ"


def test_data_parallel_steps_match_jax_on_a_two_device_mesh(ranks, jax_runs):
    _check_steps(jax_runs["step"], _case(ranks, "step"))


def test_fsdp_steps_match_jax_fsdp_and_keep_jax_placements(ranks, jax_runs):
    per_rank = _case(ranks, "fsdp")
    _check_steps(jax_runs["fsdp"], per_rank)
    for run in per_rank:
        moved = {k: v for k, v in run["placements"].items() if v[0] != v[1] and
                 not (v[0] == "Replicate()" and v[1] == "whole")}
        assert not moved, moved
        assert 0.45 < run["param_fraction"] < 0.6, run["param_fraction"]


def test_fsdp_placements_are_jax_leaf_shardings(jax_runs):
    """Each port parameter is sharded on the dimension JAX's ``leaf_sharding``
    picks for the same flax leaf (found by tagging each JAX dimension)."""
    from flax import traverse_util

    from skyeye_tpu.parallel import leaf_sharding as jleaf
    from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

    _, _, (jmesh, _, variables) = jax_runs["step"]
    mesh = create_mesh(WORLD, devices=["cpu"] * WORLD)
    model = SkyEyeDetectorModule(ModelConfig(**TINY))
    layouts = param_layouts(model)
    params = dict(model.named_parameters())
    flat = traverse_util.flatten_dict(variables["params"], sep="/")
    checked = 0
    for path, leaf in flat.items():
        spec = jleaf(jmesh, leaf).spec
        jdim = next((d for d, a in enumerate(spec) if a == "data"), None)
        tagged = np.zeros(leaf.shape, np.float32)
        if jdim is not None:  # the sharded JAX dimension's index along it, elsewhere 0
            shape = [1] * leaf.ndim
            shape[jdim] = leaf.shape[jdim]
            tagged = tagged + np.arange(1, leaf.shape[jdim] + 1).reshape(shape)
        (name, t), = from_jax_variables({f"params/{path}": tagged}).items()
        placement = leaf_sharding(mesh, params[name], layout=layouts.get(name))[0]
        if jdim is None:
            assert str(placement) == "Replicate()", name
        else:
            varying = [d for d in range(t.dim()) if t.shape[d] > 1
                       and not torch.equal(t.narrow(d, 0, 1).expand_as(t), t)]
            assert varying == [placement.dim], (name, varying, placement)
        checked += 1
    assert checked == len(params)


@pytest.mark.parametrize("augment", [False, True], ids=["letterbox", "host_aug"])
def test_loader_shares_are_the_single_process_batch(ranks, augment):
    spec, _ = ranks
    want = _loader(spec["data_dir"], 0, 1, augment)
    got = [r[augment] for r in _case(ranks, "loader")]
    assert len(got[0]) == len(got[1]) == len(want) == 2
    for b, w in enumerate(want):
        for k in ("images", "targets", "mask", "indices"):
            np.testing.assert_array_equal(np.concatenate([got[0][b][k], got[1][b][k]]), w[k])
        assert int(got[0][b]["n_valid"]) == int(got[1][b]["n_valid"]) == int(w["n_valid"])


def test_device_augmentation_rows_are_the_single_process_rows(ranks):
    from skyeye_tpu_torch.data.device_aug import augment_batch_device

    batch = _batch(2)
    want = augment_batch_device(torch.from_numpy(batch["images"]).float() / 255.0,
                                torch.from_numpy(batch["targets"]),
                                torch.from_numpy(batch["mask"]),
                                torch.Generator().manual_seed(11), hyp=dict(HYP, mixup=0.5))
    got = _case(ranks, "device_aug")
    for k in range(3):
        np.testing.assert_array_equal(np.concatenate([got[0][k], got[1][k]]), want[k].numpy())


def _results_rows(save_dir):
    with open(Path(save_dir) / "results.csv") as f:
        return [[float(v) for v in row] for row in list(csv.reader(f))[1:]]


@pytest.mark.parametrize("fsdp", [False, True], ids=["data_parallel", "fsdp"])
def test_cli_train_at_world_two_matches_world_one(ranks, fsdp, tmp_path):
    spec, _ = ranks
    runs = _case(ranks, "cli_fsdp" if fsdp else "cli")
    assert runs[0][0] == runs[1][0]  # rank 0 named the run directory for both
    # --fsdp trains through FSDP (on every rank), the plain run does not
    assert [r[1] for r in runs] == [["TrainState"] * fsdp] * WORLD
    save_dir = Path(runs[0][0])
    from skyeye_tpu_torch.cli.train import train

    _, one = train(**dict(spec["cli"], project=str(tmp_path)), name="world1")
    got, want = _results_rows(save_dir), _results_rows(one)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0][:4], want[0][:4], rtol=1e-4)   # epoch, train losses
    np.testing.assert_allclose(got[0][4:8], want[0][4:8], atol=1e-3)  # P, R, mAPs
    np.testing.assert_allclose(got[0][8:], want[0][8:], rtol=1e-3)   # val losses, lr
    a = torch.load(save_dir / "weights" / "last.pt", weights_only=False)
    b = torch.load(one / "weights" / "last.pt", weights_only=False)
    assert set(a) == set(b) and set(a["state_dict"]) == set(b["state_dict"])
    from skyeye_tpu_torch.models.detector import create_detector

    init = create_detector(dict(TINY, variant="s"), num_classes=3, device="cpu",
                           seed=0).state_dict()
    for key in ("state_dict", "train_state_dict"):
        for k, w in b[key].items():
            if w.is_floating_point():  # the step's tolerance, on the change since the init
                allowed = (STATE_REL * float(w.abs().max())
                           + CHANGE_REL * float((w - init[k]).abs().max()))
                assert float((a[key][k] - w).abs().max()) <= allowed, (key, k)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"])
    # one run directory per run: rank 1 made none of its own
    assert sorted(p.name for p in save_dir.parent.iterdir()) == ["world2", "world2_fsdp"]


def _multihost_worker(rank, port, out_dir):
    """``tests/test_train.py::test_multiprocess_train_step`` for the port: explicit
    ``initialize_distributed``, this rank's rows through ``shard_batch_multihost``,
    one data-parallel step."""
    from skyeye_tpu_torch.parallel import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", num_processes=WORLD, process_id=rank,
                           backend="gloo", timeout_s=120)
    try:
        mesh = create_mesh()
        assert is_main_process() == (rank == 0) and mesh.size == WORLD
        loss, p0 = _one_step(mesh, shard_batch_multihost(
            mesh, {k: np.asarray(v)[_rows(rank)] for k, v in _batch(0).items()
                   if k != "n_valid"}))
        Path(out_dir, f"rank{rank}.txt").write_text(f"{loss!r} {p0!r}")
    finally:
        dist.destroy_process_group()


def _one_step(mesh, batch):
    torch.manual_seed(0)
    model = SkyEyeDetectorModule(ModelConfig(**TINY))
    opt = RuntimeOptimizer(model, HYP, batch_size=64, accumulate=1)
    state = create_train_state(model, opt)
    step = make_train_step(model, ComputeLoss(model.config.anchors, 3, hyp=HYP), opt, mesh=mesh)
    batch = dict(batch, opt_hyperparams={"lr": 0.05, "bias_lr": 0.05, "momentum": 0.9})
    state, m = step(state, batch)
    return float(m["loss"]), float(sum(p.detach().double().sum() for p in model.parameters()))


def test_initialize_distributed_and_shard_batch_multihost(tmp_path):
    import torch.multiprocessing as mp

    from skyeye_tpu_torch.parallel.launch import free_port

    mp.start_processes(_multihost_worker, args=(free_port(), str(tmp_path)), nprocs=WORLD,
                       start_method="spawn")
    got = [tuple(float(v) for v in Path(tmp_path, f"rank{r}.txt").read_text().split())
           for r in range(WORLD)]
    assert got[0] == got[1]  # one global loss, one state
    loss, p0 = _one_step(None, {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(0).items()
                               if k != "n_valid"})
    assert got[0][0] == pytest.approx(loss, rel=1e-5)
    assert got[0][1] == pytest.approx(p0, rel=1e-5)


def test_a_failing_worker_fails_the_launch():
    from skyeye_tpu_torch.parallel import WorkerFailed

    with pytest.raises(WorkerFailed, match="rank 1 refuses") as err:
        launch(_fail_on_rank_one, WORLD, device="cpu", timeout_s=60)
    assert err.value.rank == 1 and "Traceback" in err.value.traceback


def _fail_on_rank_one():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 refuses")
    return 0


# -- serving split over replicas --------------------------------------------------------


def _detectors(mesh_port, mesh_jax):
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    import skyeye_tpu.models.detector as jdet
    from skyeye_tpu.api import SkyEyeDetector as JaxDetector
    from skyeye_tpu_torch import SkyEyeDetector
    from skyeye_tpu_torch.utils.checkpoint import from_jax_variables
    from test_torch_port_slice import CFG, _variables

    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG))
    flat = _variables(module, seed=5)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jdet, "create_detector", lambda *a, **k: (module, variables))
    try:
        ref = JaxDetector(cfg=CFG, img_size=128, conf_thres=0.001, mesh=mesh_jax)
    finally:
        mp_.undo()
    kw = dict(cfg=CFG, state_dict=from_jax_variables(flat), img_size=128, conf_thres=0.001,
              device="cpu")
    return ref, SkyEyeDetector(**kw, mesh=mesh_port), SkyEyeDetector(**kw)


@pytest.fixture(scope="module")
def served():
    import jax

    from skyeye_tpu.parallel import create_mesh as jcreate_mesh

    return _detectors(create_mesh(WORLD, devices=["cpu"] * WORLD),
                      jcreate_mesh(n_data=WORLD, devices=jax.devices()[:WORLD]))


def _frames(n):
    rng = np.random.RandomState(n)
    return [np.clip(rng.randint(0, 256, (72, 128, 3)) // 32 * 32 + 16, 0, 255).astype(np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("n", [3, 8])
def test_mesh_serving_matches_jax_mesh_and_the_unmeshed_detector(served, n):
    ref, meshed, plain = served
    frames = _frames(n)
    x = torch.from_numpy(np.stack([f[:, :, ::-1] for f in frames]).copy())
    d_mesh, c_mesh = meshed.infer(x, (128, 128))  # one batch of n: a pad row at 3
    d_plain, c_plain = plain.infer(x, (128, 128))
    # index for index; the values to the rounding of convolutions over another
    # batch size (a share of 2 against 3: 7.6e-6 px, 6e-8 in score)
    assert torch.equal(c_mesh, c_plain) and torch.equal(d_mesh[..., 5], d_plain[..., 5])
    torch.testing.assert_close(d_mesh[..., :4], d_plain[..., :4], rtol=0, atol=MESH_BOX_ATOL)
    torch.testing.assert_close(d_mesh[..., 4], d_plain[..., 4], rtol=0, atol=MESH_SCORE_ATOL)
    # against JAX at conf 0.005: at 0.001 these noise frames hold near-tied boxes
    # whose order float32 noise decides, between the unmeshed port and unmeshed
    # JAX as well (test_torch_port_slice.py avoids them with its frames)
    ref.conf_thres = meshed.conf_thres = JAX_CONF
    ref._executables.clear()
    want, got = ref(frames), meshed(frames)
    meshed.conf_thres = 0.001
    assert sum(len(d) for d in got.xyxy) > 0
    for g, w in zip(got.xyxy, want.xyxy):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)
