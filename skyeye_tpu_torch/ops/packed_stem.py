"""Space-to-depth packed stem: the serving input layout of the int8 modes.

Port of ``skyeye_tpu/ops/packed_stem.py``. The network takes a 4x4
space-to-depth packed image (B, H/4, W/4, 48), packed on the host
(``s2d4_host``) or on the device (``s2d4_device``), and its first two convs are
rewritten in the packed domain with an exact weight remap:

  * the fused stem 6x6/2 (3 -> c1) is a 3x3/1 conv (48 -> 4 c1) whose output is
    the 2x2 space-to-depth packing of the canonical stem output;
  * down1 3x3/2 (c1 -> c2) is a 2x2/1 conv (4 c1 -> c2) with ((1, 0), (1, 0))
    padding that reads that packing and emits the canonical (H/4, W/4, c2).

BatchNorm and SiLU commute with the packing (per channel, elementwise), so the
stem's BN leaves are tiled 4x. On the TPU this fills the 128 lanes that 3 input
channels leave empty; here it is the layout ``Int8EarlyStage`` and
``Int8PackedStem`` read. The kernels are remapped in JAX's HWIO layout
(``pack_stem_kernel``, ``pack_down1_kernel``); ``pack_stem_variables`` and
``fold_input_scale`` work on the port's ``state_dict`` (OIHW). JAX's
``down1_p2p`` pairs only with ``packed_stage1`` (ROADMAP Queue 1 item 9) and
raises here.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

STEM = "backbone.stem"
DOWN1 = "backbone.down1"
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def s2d4_host(x: np.ndarray) -> np.ndarray:
    """(..., H, W, C) -> (..., H/4, W/4, 16 C), channel (dy * 4 + dx) * C + c."""
    *lead, H, W, C = x.shape
    y = x.reshape(*lead, H // 4, 4, W // 4, 4, C)
    y = np.moveaxis(y, -4, -3)  # (..., H/4, W/4, 4, 4, C)
    return np.ascontiguousarray(y.reshape(*lead, H // 4, W // 4, 16 * C))


def s2d4_device(x: torch.Tensor) -> torch.Tensor:
    """``s2d4_host`` on a tensor, on its device: (B, H, W, C) -> (B, H/4, W/4, 16 C)."""
    *lead, H, W, C = x.shape
    y = x.reshape(*lead, H // 4, 4, W // 4, 4, C)
    y = torch.movedim(y, -4, -3)
    return y.reshape(*lead, H // 4, W // 4, 16 * C)


def pack_stem_kernel(kf: np.ndarray) -> np.ndarray:
    """(6, 6, C, c1) stride-2 pad-2 kernel -> (3, 3, 16 C, 4 c1) stride-1 pad-1
    kernel over the s2d-4 input; output channel (a * 2 + b) * c1 + o is the
    (a, b) phase of the canonical output (its 2x2 s2d packing). Output pixel
    (2I + a, 2J + b) of the 6x6/2 conv reads rows 4I + 2a + r - 2, r in 0..5:
    written as 4 (I + u) + dy, (u, dy) = divmod(2a + r - 2, 4)."""
    kf = np.asarray(kf)
    if kf.shape[:2] != (6, 6):
        raise ValueError(f"expected a (6, 6, C, c1) stem kernel, got {kf.shape}")
    C, c1 = kf.shape[2], kf.shape[3]
    out = np.zeros((3, 3, 16 * C, 4 * c1), kf.dtype)
    for a in range(2):
        for b in range(2):
            for r in range(6):
                u, dy = divmod(2 * a + r - 2, 4)
                for s in range(6):
                    v, dx = divmod(2 * b + s - 2, 4)
                    ci = (dy * 4 + dx) * C
                    co = (a * 2 + b) * c1
                    out[u + 1, v + 1, ci: ci + C, co: co + c1] = kf[r, s]
    return out


def pack_down1_kernel(kd: np.ndarray) -> np.ndarray:
    """(3, 3, c1, c2) stride-2 pad-1 kernel -> (2, 2, 4 c1, c2) stride-1
    pad-((1, 0), (1, 0)) kernel over the 2x2 s2d packed stem output."""
    kd = np.asarray(kd)
    if kd.shape[:2] != (3, 3):
        raise ValueError(f"expected a (3, 3, c1, c2) down1 kernel, got {kd.shape}")
    c1, c2 = kd.shape[2], kd.shape[3]
    out = np.zeros((2, 2, 4 * c1, c2), kd.dtype)
    for r in range(3):
        u, dy = divmod(r - 1, 2)
        for s in range(3):
            v, dx = divmod(s - 1, 2)
            ci = (dy * 2 + dx) * c1
            out[u + 1, v + 1, ci: ci + c1, :] = kd[r, s]
    return out


def _hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().cpu().numpy().transpose(2, 3, 1, 0)


def _oihw(k: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(like.dtype)


def fold_input_scale(state: Mapping[str, torch.Tensor], scale: float = 1.0 / 255.0
                     ) -> Dict[str, torch.Tensor]:
    """Fold the input normalisation (x * scale) into the stem conv's kernel:
    conv(x * s, k) == conv(x, k * s), so the model reads frames in 0..255 with
    no separate divide. Works before or after ``pack_stem_variables``. Returns
    a new dict."""
    out = dict(state)
    key = f"{STEM}.conv.weight"
    out[key] = torch.from_numpy(state[key].detach().cpu().numpy() * scale).to(state[key].dtype)
    return out


def pack_stem_variables(state: Mapping[str, torch.Tensor], down1_p2p: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """A canonical detector's ``state_dict`` (BN folded or not) -> the form a
    ``packed_stem=True`` detector loads: the stem kernel 6x6 -> 3x3 s2d with its
    BN leaves tiled 4x, down1's kernel 3x3 -> 2x2 s2d; every other entry as it
    is. Returns a new dict."""
    if down1_p2p:
        raise NotImplementedError(
            "down1_p2p pairs with packed_stage1, not ported (ROADMAP Queue 1 item 9)")
    out = dict(state)
    stem_w, down1_w = state[f"{STEM}.conv.weight"], state[f"{DOWN1}.conv.weight"]
    out[f"{STEM}.conv.weight"] = _oihw(pack_stem_kernel(_hwio(stem_w)), stem_w)
    out[f"{DOWN1}.conv.weight"] = _oihw(pack_down1_kernel(_hwio(down1_w)), down1_w)
    for leaf in _BN_LEAVES:
        key = f"{STEM}.bn.{leaf}"
        out[key] = state[key].detach().cpu().repeat(4)
    return out
