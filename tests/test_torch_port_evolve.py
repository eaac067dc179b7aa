"""Hyperparameter evolution on the port against JAX's.

``mutate_hyp`` and ``evolve`` with a stub ``train_fn`` give JAX's mutations,
``evolve.csv`` and best hyp for the same seed, also when a run continues an
existing ``evolve.csv``. Then ``cli.train(evolve=2)`` end to end on both, with
JAX's default host augmentation (``device_aug=False``; JAX's loader at one
worker, whose draws are then in item order, the port's at two): the two
generations' hyp columns equal, their fitness and ``results.csv`` rows at the
tolerances of ``test_torch_port_train.py``; ``hyp_evolved.yaml`` equal to
JAX's values, and JAX's ``load_hyp`` reads the port's file back to them.
The tiny model, dataset and JAX-side settings are ``test_torch_port_train.py``'s.
"""
import contextlib
import csv
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import flax.linen.normalization as fnorm
import skyeye_tpu.cli.train as jax_train
import skyeye_tpu.data.native as jax_native
import skyeye_tpu.models.detector as jdet
import skyeye_tpu.parallel as jax_parallel
import skyeye_tpu.train.evolve as jax_evolve
from skyeye_tpu.cli.export import export_torch
from skyeye_tpu.config import load_hyp as jax_load_hyp
from skyeye_tpu_torch.cli import train as port_train
from skyeye_tpu_torch.config import DEFAULT_HYP, load_hyp
import skyeye_tpu_torch.train.evolve as port_evolve

from test_torch_port_train import (
    CFG, IMG, LOSS_REL, METRIC_TOL, NC, N_FRAMES, VAL_LOSS_REL, _create_without_init,
    _seeded_variables,
)

BATCH, ACCUM = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's small tensors: several test
    workers share the machine, and idle OpenMP threads spin."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def write_trainset(root: Path):
    """N_FRAMES PNG frames of IMG px with 3 labels each, and a seeded ``.pt``
    written by JAX's ``export_torch``; returns (data dict, weights, variables)."""
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
    data = {"path": str(root), "train": "images/train", "val": "images/train", "nc": NC,
            "names": [f"c{i}" for i in range(NC)]}
    return data, str(weights), variables


@contextlib.contextmanager
def jax_cli_settings(variables):
    """JAX's CLI as ``test_torch_port_train.py`` runs it: its loader's Python path,
    two-pass BatchNorm variance, one device, no orbax checkpoints, the model
    built on the seeded variables without an init."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "native_available", lambda: False)
    stats = fnorm._compute_stats
    mp.setattr(fnorm, "_compute_stats",
               lambda *a, **k: stats(*a, **{**k, "use_fast_variance": False}))
    mp.setattr(jax_parallel, "create_mesh", lambda **k: None)
    mp.setattr(jax_train, "save_checkpoint", lambda *a, **k: None)
    mp.setattr(jdet, "create_detector", _create_without_init(variables))
    try:
        yield
    finally:
        mp.undo()


def rows(path):
    with open(path) as f:
        table = list(csv.reader(f))
    return table[0], [[float(v) for v in r] for r in table[1:]]


def assert_results_rows_match(prows, jrows):
    assert len(prows) == len(jrows)
    for p, j in zip(prows, jrows):
        assert p[0] == j[0] and p[11] == j[11]                          # epoch, lr
        np.testing.assert_allclose(p[1:4], j[1:4], rtol=LOSS_REL)      # train losses
        np.testing.assert_allclose(p[8:11], j[8:11], rtol=VAL_LOSS_REL)  # val losses
        np.testing.assert_allclose(p[4:8], j[4:8], atol=METRIC_TOL)    # P, R, mAPs
        assert np.isfinite(p).all()


@pytest.mark.parametrize("seed", range(5))
def test_mutate_hyp_matches_jax(seed):
    assert port_evolve.EVOLVE_META == jax_evolve.EVOLVE_META
    hyp = dict(DEFAULT_HYP, mixup=0.2, degrees=3.0)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        got, want = port_evolve.mutate_hyp(hyp, r1), jax_evolve.mutate_hyp(hyp, r2)
        assert got == want
        hyp = got
    assert r1.random() == r2.random()


def _stub_fitness(hyp):
    return hyp["lr0"] * 10 + hyp["mosaic"] * 0.1 - hyp["hsv_s"] * 0.01


def test_evolve_with_a_stub_train_fn_matches_jax(tmp_path):
    base = dict(DEFAULT_HYP)
    for run in range(2):  # the second call continues each evolve.csv
        got = port_evolve.evolve(_stub_fitness, base, generations=4,
                                 save_dir=tmp_path / "port", seed=run)
        want = jax_evolve.evolve(_stub_fitness, base, generations=4,
                                 save_dir=tmp_path / "jax", seed=run)
        assert got == want
        assert ((tmp_path / "port" / "evolve.csv").read_text()
                == (tmp_path / "jax" / "evolve.csv").read_text())
    header, data = port_evolve.load_evolve_results(tmp_path / "port" / "evolve.csv")
    assert (header, data) == jax_evolve.load_evolve_results(tmp_path / "jax" / "evolve.csv")
    assert len(data) == 8 and header[0] == "fitness"


@pytest.fixture(scope="module")
def evolved(tmp_path_factory):
    root = tmp_path_factory.mktemp("evolveset")
    data, weights, variables = write_trainset(root)
    kw = dict(cfg=CFG, data=data, epochs=1, batch_size=BATCH, img_size=IMG, weights=weights,
              accumulate=ACCUM, seed=0, evolve=2)
    with jax_cli_settings(variables):
        _, jax_dir = jax_train.train(project=str(root / "jax"), workers=1, **kw)
    _, port_dir = port_train.train(project=str(root / "port"), workers=2, device="cpu", **kw)
    return dict(root=root, jax_dir=Path(jax_dir), port_dir=Path(port_dir))


def test_evolve_csv_generations_match_jax(evolved):
    ph, prows = rows(evolved["port_dir"] / "evolve.csv")
    jh, jrows = rows(evolved["jax_dir"] / "evolve.csv")
    assert ph == jh and len(prows) == len(jrows) == 2
    for p, j in zip(prows, jrows):
        assert p[1:] == j[1:]                                  # the hyp columns
        assert p[0] == pytest.approx(j[0], abs=METRIC_TOL)      # fitness
    # generation 1 trains the base hyp, generation 2 a mutation from the seed's generator
    keys = ph[1:]
    assert prows[0][1:] == [DEFAULT_HYP[k] for k in keys]
    assert prows[1][1:] == [port_evolve.mutate_hyp(DEFAULT_HYP, np.random.default_rng(0))[k]
                            for k in keys]


def test_each_generations_training_matches_jax(evolved):
    """Both generations write their epoch to ``<project>/evolve_gen/results.csv``,
    JAX's default host-augmented training with the generation's hyp."""
    ph, prows = rows(evolved["port_dir"].parent / "evolve_gen" / "results.csv")
    jh, jrows = rows(evolved["jax_dir"].parent / "evolve_gen" / "results.csv")
    assert ph == jh == port_train.RESULTS_HEADER
    assert len(prows) == 2
    assert_results_rows_match(prows, jrows)


def test_hyp_evolved_reads_back_through_jax_load_hyp(evolved):
    path = evolved["port_dir"] / "hyp_evolved.yaml"
    want = jax_load_hyp(evolved["jax_dir"] / "hyp_evolved.yaml")
    assert jax_load_hyp(path) == want
    assert load_hyp(path) == want
