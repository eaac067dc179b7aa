"""``skyeye_tpu_torch.cli.train`` end to end against JAX's ``cli.train``.

A tiny skyeye_s (base width 16, nc 3) from one seeded ``.pt`` (written by JAX's
``export_torch``), 4 PNG frames of 64 px (train and val), batch 2, accumulate
2, 2 epochs (one optimizer step an epoch), device augmentation with every gain
0 (mosaic, affine, HSV and flips then leave frames and labels as they are,
whatever either framework draws). JAX's loader is pinned to its Python path
(its native C++ decode switched off), to one device, its model built on the
seeded variables without an init, and its BatchNorm to the two-pass variance,
as in the train-step tests. ``results.csv``: the lr column equal;
the train losses within 1e-4 relative, the validation losses within 1e-3
(they follow the updates: float32 and float64 runs of the port itself part
by 2e-4 after the second update, and by 2.5e-3 after the fourth, 5e-2 with a
padded batch of one image in it: this net's training amplifies rounding,
which is why the comparison stops at two optimizer steps); P, R and the mAPs
within 1e-3. Also: ``last.pt``/``best.pt`` hold the EMA weights, read back by
``SkyEyeDetector`` and by ``validate`` to their epoch's row of ``results.csv``; a
run stopped after one epoch and resumed gives the uninterrupted run's rows;
FSDP over a spatial mesh, which is not ported, raises, naming its ROADMAP
item (8c), and so does a row split that is not even (multi-device training
is held in ``test_torch_port_parallel.py``, spatial sharding in
``test_torch_port_spatial.py``). Host augmentation (JAX's default), ``remat`` and ``evolve`` are held
against JAX in ``test_torch_port_{augment,remat,evolve}.py``.
"""
import csv
import dataclasses
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import flax.linen.normalization as fnorm

import skyeye_tpu.cli.train as jax_train
import skyeye_tpu.parallel as jax_parallel
import skyeye_tpu.data.native as jax_native
import skyeye_tpu.models.detector as jdet
from skyeye_tpu.cli.export import export_torch
from skyeye_tpu_torch import SkyEyeDetector
from skyeye_tpu_torch.cli import train as port_train
from skyeye_tpu_torch.cli import validate as port_validate
from skyeye_tpu_torch.config import DEFAULT_HYP, dump_flat_yaml
from skyeye_tpu_torch.utils.checkpoint import load_torch_checkpoint

NC, N_FRAMES, IMG, BATCH, EPOCHS, ACCUM = 3, 4, 64, 2, 2, 2
CFG = {"nc": NC, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.25,
       "variant": "s"}
LOSS_REL, VAL_LOSS_REL, METRIC_TOL = 1e-4, 1e-3, 1e-3
ZERO_GAINS = {k: 0.0 for k in ("hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale",
                               "shear", "perspective", "flipud", "fliplr", "mosaic", "mixup")}

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seeded_variables(module, seed):
    shapes = jax.eval_shape(lambda k, x: module.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.RandomState(seed)
    flat = {}
    for path, v in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "var":
            flat[path] = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "scale":
            flat[path] = rng.uniform(0.8, 1.2, v.shape)
        elif leaf == "kernel":
            flat[path] = rng.normal(0, 1, v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        else:
            flat[path] = rng.normal(0, 0.1, v.shape)
    for level in range(3):  # a head that sends a few boxes an image past conf 0.001 ... 0.3
        flat[f"params/head/pred{level}/bias"].reshape(3, NC + 5)[:, 4] -= 1.0
    return traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v, jnp.float32)
                                         for k, v in flat.items()})


def _create_without_init(variables):
    """JAX's ``create_detector`` with the seeded variables in place of an init,
    which runs op by op (some 480 compiles): the CLI loads the ``.pt`` over
    them either way."""
    def create(cfg, num_classes=None, dtype=jnp.float32, rng=None,
               ref_exact_cross_attn=None, remat=False, packed_stem_train=False, **_):
        config = dataclasses.replace(jdet.load_model_config(cfg), nc=num_classes)
        return jdet.SkyEyeDetectorModule(config=config, dtype=dtype, remat=remat,
                                         packed_stem_train=packed_stem_train), variables
    return create


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainset")
    (root / "images" / "train").mkdir(parents=True)
    (root / "labels" / "train").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(N_FRAMES):
        coarse = rng.randint(0, 256, (IMG // 8, IMG // 8, 3)).astype(np.uint8)
        cv2.imwrite(str(root / "images" / "train" / f"im{i}.png"),
                    np.ascontiguousarray(coarse.repeat(8, 0).repeat(8, 1)))
        lines = [f"{rng.randint(NC)} {rng.uniform(0.3, 0.7):.6f} {rng.uniform(0.3, 0.7):.6f} "
                 f"{rng.uniform(0.15, 0.4):.6f} {rng.uniform(0.15, 0.4):.6f}" for _ in range(3)]
        (root / "labels" / "train" / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG))
    variables = _seeded_variables(module, 1)
    weights = export_torch(module, variables, root / "init.pt")
    hyp = root / "hyp.yaml"
    hyp.write_text(dump_flat_yaml({**DEFAULT_HYP, **ZERO_GAINS}))
    data = {"path": str(root), "train": "images/train", "val": "images/train", "nc": NC,
            "names": [f"c{i}" for i in range(NC)]}
    kw = dict(cfg=CFG, data=data, hyp=str(hyp), epochs=EPOCHS, batch_size=BATCH, img_size=IMG,
              weights=str(weights), device_aug=True, accumulate=ACCUM, workers=2,
              exist_ok=True, seed=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "native_available", lambda: False)
    stats = fnorm._compute_stats
    mp.setattr(fnorm, "_compute_stats",
               lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    # one device (the tests' 8 virtual CPU devices would shard batch 2 over a
    # mesh of 2, BatchNorm's statistics the same); JAX's orbax checkpoints, which
    # no check here reads, not written
    mp.setattr(jax_parallel, "create_mesh", lambda **k: None)
    mp.setattr(jax_train, "save_checkpoint", lambda *a, **k: None)
    mp.setattr(jdet, "create_detector", _create_without_init(variables))
    try:
        _, jax_dir = jax_train.train(project=str(root / "jax"), name="exp", **kw)
    finally:
        mp.undo()
    _, port_dir = port_train.train(project=str(root / "port"), name="exp", device="cpu", **kw)
    return dict(root=root, kw=kw, jax_dir=Path(jax_dir), port_dir=Path(port_dir))


def _rows(save_dir):
    with open(Path(save_dir) / "results.csv") as f:
        rows = list(csv.reader(f))
    return rows[0], [[float(v) for v in r] for r in rows[1:]]


def test_results_csv_rows_match_jax(setup):
    jh, jrows = _rows(setup["jax_dir"])
    ph, prows = _rows(setup["port_dir"])
    assert ph == jh == port_train.RESULTS_HEADER
    assert len(prows) == len(jrows) == EPOCHS
    for p, j in zip(prows, jrows):
        assert p[0] == j[0] and p[11] == j[11]                          # epoch, lr
        np.testing.assert_allclose(p[1:4], j[1:4], rtol=LOSS_REL)      # train losses
        np.testing.assert_allclose(p[8:11], j[8:11], rtol=VAL_LOSS_REL)  # val losses
        np.testing.assert_allclose(p[4:8], j[4:8], atol=METRIC_TOL)    # P, R, mAPs
    assert all(np.isfinite(r).all() for r in prows)
    assert (setup["port_dir"] / "hyp.yaml").read_text() == dump_flat_yaml(
        {**DEFAULT_HYP, **ZERO_GAINS})
    assert "device_aug: true" in (setup["port_dir"] / "opt.yaml").read_text()


@pytest.mark.parametrize("name", ["last.pt", "best.pt"])
def test_checkpoints_serve_through_the_facade(setup, name):
    path = setup["port_dir"] / "weights" / name
    state, meta = load_torch_checkpoint(path)
    epoch = meta["epoch"]  # best.pt: the epoch of the best fitness
    steps = (epoch + 1) * N_FRAMES // BATCH
    assert epoch == EPOCHS - 1 if name == "last.pt" else 0 <= epoch < EPOCHS
    assert meta["step"] == meta["ema_updates"] == steps
    assert meta["optimizer"]["gradient_step"] == steps // ACCUM
    # the file serves the EMA parameters (with the model's BatchNorm statistics),
    # as JAX serves a training checkpoint's ema_params; training resumes from
    # the model's own weights beside them
    raw = meta["train_state_dict"]
    assert set(raw) == set(state)
    params = [k for k in state if k.endswith((".weight", ".bias"))]
    assert params and any(not torch.equal(state[k], raw[k]) for k in params)
    assert all(torch.equal(state[k], raw[k]) for k in state if k not in params)
    det = SkyEyeDetector(weights=str(path), img_size=IMG, conf_thres=0.001, device="cpu",
                         fuse=False)
    own = det.model.state_dict()
    assert all(torch.equal(own[k], v) for k, v in state.items())
    frame = cv2.imread(str(setup["root"] / "images" / "train" / "im0.png"))
    res = det(frame)
    assert len(res.xyxy) == 1 and res.xyxy[0].shape[1] == 6


@pytest.mark.parametrize("name", ["last.pt", "best.pt"])
def test_checkpoints_validate_to_their_epochs_row(setup, name, tmp_path):
    """``validate(weights=)`` on a checkpoint gives the P, R and mAPs that
    training wrote for its epoch: the file holds the weights it was validated
    (and, for best.pt, chosen) by."""
    path = setup["port_dir"] / "weights" / name
    _, meta = load_torch_checkpoint(path)
    _, rows = _rows(setup["port_dir"])
    (p, r, map50, map_, *_), _, _ = port_validate.validate(
        setup["kw"]["data"], weights=str(path), batch_size=BATCH, img_size=IMG,
        project=str(tmp_path), plots=False, device="cpu")
    np.testing.assert_allclose([p, r, map50, map_], rows[meta["epoch"]][4:8], rtol=1e-3)


def test_a_resumed_run_gives_the_uninterrupted_rows(setup, tmp_path):
    kw = dict(setup["kw"], project=str(tmp_path), name="exp", device="cpu")
    port_train.train(**{**kw, "epochs": 1})
    _, save_dir = port_train.train(**kw, resume=True)
    _, rows = _rows(save_dir)
    _, want = _rows(setup["port_dir"])
    assert rows == want


@pytest.mark.parametrize("options,error,item", [
    # FSDP over the data axis of a spatial mesh (a data axis of 2: two cards a share)
    (dict(spatial_shards=2, fsdp=True), NotImplementedError, "item 8c"),
    # rows that do not split into whole rows at every level
    (dict(spatial_shards=4, img_size=320), ValueError, "multiple of 32 x 4 = 128"),
])
def test_options_that_are_not_ported_raise(options, error, item, tmp_path, monkeypatch):
    monkeypatch.setattr(port_train, "_data_axis", lambda *a, **k: 2)
    kw = dict(data={"train": str(tmp_path), "nc": 1}, device_aug=True, project=str(tmp_path),
              device="cpu", **options)
    with pytest.raises(error, match=item):
        port_train.train(**kw)


def test_parse_opt_keeps_jax_defaults():
    opt = port_train.parse_opt(["--data", "d.yaml"])
    assert (opt.epochs, opt.batch_size, opt.img_size, opt.device_aug, opt.packed_stem,
            opt.device) == (100, 16, 640, False, True, "cuda")
