"""The port's serving slice end to end against the JAX package's.

``skyeye_tpu_torch.SkyEyeDetector(device="cpu")`` and ``skyeye_tpu.SkyEyeDetector``
run on the same weights and the same BGR uint8 frames, of two shapes, with the
same ``approx_topk``: False (decode everything, one global exact cut) and the
default True (late decode; JAX's approximate top-k is exact on the CPU, as the
port's is everywhere). Counts and classes must be equal, in keep order; boxes
(pixels of the original frame) within 1e-2 px and scores within 1e-4, the
float32 error of a small network's forward carried through decode and
rescaling.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import skyeye_tpu.models.detector as jdet
from skyeye_tpu.api import SkyEyeDetector as JaxDetector
from skyeye_tpu_torch import SkyEyeDetector
from skyeye_tpu_torch.utils.checkpoint import from_jax_variables

REPO = Path(__file__).resolve().parent.parent
CFG = {"nc": 6, "base_channels": 16, "depth_multiple": 0.33, "width_multiple": 0.5,
       "variant": "s"}


def _variables(module, seed):
    """Seeded numpy weights for every flax leaf (BN statistics too). The head's
    obj/cls biases start where YOLOv5's initialisation puts them, so that the
    detector proposes sparse boxes, as a trained one does, and not near-ties
    at every cell, where float32 noise alone would decide the keep order."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
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
            flat[path] = rng.normal(0, 0.5, v.shape)
    no = CFG["nc"] + 5
    for level, stride in enumerate((8, 16, 32)):
        bias = flat[f"params/head/pred{level}/bias"].reshape(3, no)
        bias[:, 4] += np.log(8 / (640 / stride) ** 2)
        bias[:, 5:] += np.log(0.6 / (CFG["nc"] - 0.99))
    return {k: v.astype(np.float32) for k, v in flat.items()}


@pytest.fixture(scope="module")
def detectors():
    module = jdet.SkyEyeDetectorModule(config=jdet.load_model_config(CFG))
    flat = _variables(module, seed=5)
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    mp = pytest.MonkeyPatch()
    # JaxDetector builds its module with create_detector; hand it these weights
    mp.setattr(jdet, "create_detector", lambda *a, **k: (module, variables))
    try:
        ref = JaxDetector(cfg=CFG, img_size=128, approx_topk=False)
    finally:
        mp.undo()
    port = SkyEyeDetector(cfg=CFG, state_dict=from_jax_variables(flat), img_size=128,
                          approx_topk=False, device="cpu")
    return ref, port


def _frames():
    rng = np.random.RandomState(0)
    wide = [rng.randint(0, 256, (72, 128, 3), np.uint8) for _ in range(2)]
    tall = [rng.randint(0, 256, (100, 60, 3), np.uint8)]
    # smooth the noise so the detector sees structure, not only texture
    return [np.clip(f.astype(np.int32) // 32 * 32 + 16, 0, 255).astype(np.uint8)
            for f in wide + tall]


def _serve_both(detectors, conf, approx_topk):
    ref, port = detectors
    ref.conf_thres = port.conf_thres = conf
    ref.approx_topk = port.approx_topk = approx_topk
    ref._executables.clear()  # the JAX pipeline bakes both into its executable
    frames = _frames()
    want = ref(frames)
    got = port(frames)
    assert len(got) == len(want) == len(frames)
    assert sum(len(d) for d in got.xyxy) > 0
    for g, w in zip(got.xyxy, want.xyxy):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=1e-4)
    for g, w in zip(got.xywh, want.xywh):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2)
    got.print()


@pytest.mark.parametrize("conf", [0.005, 0.001])
def test_serving_matches_jax(detectors, conf):
    _serve_both(detectors, conf, approx_topk=False)


@pytest.mark.parametrize("conf", [0.01, 0.005, 0.001])
def test_late_decode_serving_matches_jax(detectors, conf):
    """The default on both facades: the cut per level on the raw logits."""
    _serve_both(detectors, conf, approx_topk=True)


def test_stage_hook_sees_each_stage_of_every_batch_in_order(detectors):
    _, port = detectors
    stages = ["host_prep", "host_to_device", "letterbox", "model", "decode", "nms",
              "device_to_host", "rescale"]
    for approx_topk in (False, True):  # the global cut, then late decode: same stages
        port.conf_thres, port.approx_topk = 0.001, approx_topk
        frames = _frames()
        want = port(frames)
        seen = []
        port.on_stage = seen.append
        try:
            got = port(frames)
        finally:
            port.on_stage = None
        assert seen == stages * 2  # one batch per frame shape
        for g, w in zip(got.xyxy, want.xyxy):
            np.testing.assert_array_equal(g, w)


def test_paths_and_arrays_of_the_same_frames_give_the_same_detections(detectors, tmp_path):
    """Image paths go through ``data.imageio.imread`` (PNG, BMP, JPEG), as JAX's
    go through ``cv2.imread``."""
    import cv2

    _, port = detectors
    port.conf_thres, port.approx_topk = 0.005, True
    frames = _frames()
    paths = []
    for i, frame in enumerate(frames):
        paths.append(str(tmp_path / f"frame{i}.{'bmp' if i == 1 else 'png'}"))
        cv2.imwrite(paths[-1], frame)
    by_path, by_array = port(paths), port(frames)
    assert by_path.paths == paths and by_array.paths[0] == "array0.jpg"
    assert sum(len(d) for d in by_array.xyxy) > 0
    for g, w in zip(by_path.xyxy, by_array.xyxy):
        np.testing.assert_array_equal(g, w)
    mixed = port([paths[0], frames[1]])
    np.testing.assert_array_equal(mixed.xyxy[1], by_array.xyxy[1])
    cv2.imwrite(str(tmp_path / "frame.jpg"), frames[0])
    by_jpeg = port(str(tmp_path / "frame.jpg"))
    np.testing.assert_array_equal(
        by_jpeg.xyxy[0], port(cv2.imread(str(tmp_path / "frame.jpg"))).xyxy[0])
    with pytest.raises(TypeError):
        port([frames[0], 3])


def test_batch_buckets_match_jax():
    for n in (0, 1, 5, 16, 23, 40):
        assert SkyEyeDetector._batch_buckets(n) == JaxDetector._batch_buckets(n)


def test_cuda_is_the_default_and_is_not_replaced_by_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SkyEyeDetector(CFG)


def test_main_path_imports_no_jax():
    """The port, its API, its CLIs, its multi-device package and chip_smoke.py
    import none of jax, flax,
    skyeye_tpu, yaml, cv2, PIL, matplotlib or pandas (``Results.pandas`` imports
    pandas when it is called)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import skyeye_tpu_torch, skyeye_tpu_torch.api, skyeye_tpu_torch.ops.nms_kernel\n"
        "import skyeye_tpu_torch.ops.attention_kernel, skyeye_tpu_torch.ops.csp_kernel\n"
        "import skyeye_tpu_torch.ops.fused_csp, skyeye_tpu_torch.models.attention\n"
        "import skyeye_tpu_torch.tools.attention_precision, skyeye_tpu_torch.tools.train_grad_noise\n"
        "import skyeye_tpu_torch.ops.late_decode, skyeye_tpu_torch.ops.tiling\n"
        "import skyeye_tpu_torch.utils.checkpoint\n"
        "import skyeye_tpu_torch.data.dataset, skyeye_tpu_torch.data.imageio\n"
        "import skyeye_tpu_torch.data.prefetch, skyeye_tpu_torch.utils.metrics\n"
        "import skyeye_tpu_torch.utils.coco_eval, skyeye_tpu_torch.cli.validate\n"
        "import skyeye_tpu_torch.cli.train, skyeye_tpu_torch.train, skyeye_tpu_torch.losses\n"
        "import skyeye_tpu_torch.data.device_aug, skyeye_tpu_torch.utils.autoanchor\n"
        "import skyeye_tpu_torch.cli.detect, skyeye_tpu_torch.data.loaders\n"
        "import skyeye_tpu_torch.data.jpeg, skyeye_tpu_torch.utils.visualization\n"
        "import skyeye_tpu_torch.data.augment, skyeye_tpu_torch.train.evolve\n"
        "import skyeye_tpu_torch.ops.calibrate, skyeye_tpu_torch.ops.packed_stem\n"
        "import skyeye_tpu_torch.ops.int8_stage, skyeye_tpu_torch.ops.int8_neck\n"
        "import skyeye_tpu_torch.ops.int8_stem, skyeye_tpu_torch.cli.export\n"
        "import skyeye_tpu_torch.utils.profiling\n"
        "import skyeye_tpu_torch.parallel, skyeye_tpu_torch.parallel.mesh\n"
        "import skyeye_tpu_torch.parallel.fsdp, skyeye_tpu_torch.parallel.launch\n"
        "import skyeye_tpu_torch.parallel.collectives\n"
        "import chip_smoke\n"
        "banned = ('jax', 'flax', 'skyeye_tpu', 'yaml', 'cv2', 'PIL', 'matplotlib', 'pandas')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
