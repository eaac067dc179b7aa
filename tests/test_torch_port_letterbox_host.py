"""The port's host letterbox against JAX's, which resizes and pads with cv2.

``skyeye_tpu_torch.ops.letterbox.letterbox`` and ``skyeye_tpu.ops.letterbox.letterbox``
(its cv2 branch: ``cv2.resize(INTER_LINEAR)``, then ``copyMakeBorder``) on the
same uint8 images: the image bit for bit, the ratio and the padding exactly,
square and rect targets, growing and shrinking, with ``scaleup`` on and off, the
minimum-rectangle (``auto``) and stretch (``scale_fill``) modes.
"""
import importlib

import numpy as np
import pytest

from skyeye_tpu_torch.ops.letterbox import letterbox

# the module (skyeye_tpu.ops re-exports its function under the same name)
jax_letterbox = importlib.import_module("skyeye_tpu.ops.letterbox")

SHAPES = [(72, 128), (128, 72), (100, 100), (37, 53), (720, 1280), (1080, 1920), (300, 41)]
TARGETS = [(640, 640), (736, 1312), (1312, 1312), (160, 256), (96, 64), 320]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("scaleup", [True, False])
def test_letterbox_matches_jax(shape, target, scaleup):
    rng = np.random.RandomState(shape[0] + shape[1])
    im = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
    for kw in ({"auto": False}, {"auto": True}, {"auto": False, "scale_fill": True}):
        got, g_ratio, g_pad = letterbox(im, target, scaleup=scaleup, **kw)
        want, w_ratio, w_pad = jax_letterbox.letterbox(im, target, scaleup=scaleup, **kw)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert g_ratio == w_ratio and g_pad == w_pad


def test_jax_takes_its_cv2_branch():
    assert jax_letterbox.cv2 is not None


def test_pad_colour_per_channel():
    im = np.full((10, 20, 3), 200, np.uint8)
    got, _, pad = letterbox(im, (40, 40), color=(1, 2, 3), auto=False)
    want, _, _ = jax_letterbox.letterbox(im, (40, 40), color=(1, 2, 3), auto=False)
    np.testing.assert_array_equal(got, want)
    assert pad == (0.0, 10.0) and tuple(got[0, 0]) == (1, 2, 3)
