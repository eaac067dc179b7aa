"""Int8 serving neck: every FPN/PAN conv as an int8 x int8 -> int32 product.

Port of ``skyeye_tpu/ops/int8_neck.py``. The three backbone maps quantize once
with static per-tensor scales (calibrated by ``ops/calibrate.observe_ranges``
on the float detector), every tensor between neck convs is stored int8, and
the three head inputs dequantize back to the model's dtype. The conv and its
epilogue are ``ops/int8_stage.py``'s (``int8_conv``, ``_qconv``).

It mirrors ``models/neck.py::FeatureNeck`` and its reference quirks: the
laterals read the raw P4 and P5, the raw P5 is quantized twice (at ``x5`` and
at ``pan5_in``, for the PAN concat), the two operands of a concat share one
scale (the ``("max", ...)`` keys of ``_range_key_map``), and every CSP has 3
bottlenecks whatever the depth. P5's output leaves its last conv as bf16 (as
JAX's does) before the cast to the model's dtype. Buffers come from
``quantize_neck_variables``; features go in and out NCHW (the outputs are
NCHW views of NHWC memory).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch

from .int8_stage import P0, P1, Int8Convs, folded_conv, quant_int8, quantized_state, \
    register_int8_buffers

NECK_BLOCKS = 3  # FeatureNeck's bottlenecks per CSP (not depth-scaled)
_CSPS = ("fpn4", "fpn3", "pan4", "pan5")


def _neck_specs(c3: int, c4: int, c5: int, nb: int) -> Dict[str, tuple]:
    """name -> (kh, kw, cin, cout, stride, padding); mirrors FeatureNeck."""
    specs = {
        "lateral5": (1, 1, c5, c4, 1, P0),
        "lateral4": (1, 1, c4, c3, 1, P0),
        "down3": (3, 3, c3, c3, 2, P1),
        "down4": (3, 3, c4, c4, 2, P1),
    }
    for name, cin, cout in (("fpn4", 2 * c4, c4), ("fpn3", 2 * c3, c3),
                            ("pan4", c3 + c4, c4), ("pan5", c4 + c5, c5)):
        h = cout // 2
        specs[f"{name}_cv1"] = (1, 1, cin, h, 1, P0)
        specs[f"{name}_cv2"] = (1, 1, cin, h, 1, P0)
        specs[f"{name}_cv3"] = (1, 1, 2 * h, cout, 1, P0)
        for i in range(nb):
            specs[f"{name}_m{i}_cv1"] = (1, 1, h, h, 1, P0)
            specs[f"{name}_m{i}_cv2"] = (3, 3, h, h, 1, P1)
    return specs


def _tensor_names(nb: int) -> List[str]:
    """Every int8-stored tensor that needs a static activation scale."""
    names = ["x3", "x4", "x5", "pan4_in", "pan5_in", "fpn3", "pan4"]
    for n in _CSPS:
        names += [f"{n}_cv1", f"{n}_cat"]
        for i in range(nb):
            names += [f"{n}_m{i}_cv1"] + ([f"{n}_m{i}"] if i < nb - 1 else [])
    return names


def _range_key_map(nb: int) -> Dict[str, object]:
    """Tensor scale -> the captured path(s) of the float detector that set it."""
    m = {
        "x5": "backbone/spp4",
        # shared concat scales: both concat operands requantize to one scale
        "x4": ("max", "backbone/cbam3", "neck/lateral5"),
        "x3": ("max", "backbone/csp2", "neck/lateral4"),
        "pan4_in": ("max", "neck/down3", "neck/fpn4"),
        "pan5_in": ("max", "neck/down4", "backbone/spp4"),
        "fpn3": "neck/fpn3",
        "pan4": "neck/pan4",
    }
    for n in _CSPS:
        m[f"{n}_cv1"] = f"neck/{n}/cv1"
        m[f"{n}_cat"] = ("max", f"neck/{n}/m{nb - 1}", f"neck/{n}/cv2")
        for i in range(nb):
            m[f"{n}_m{i}_cv1"] = f"neck/{n}/m{i}/cv1"
            if i < nb - 1:
                m[f"{n}_m{i}"] = f"neck/{n}/m{i}"
    return m


def _up2(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest 2x upsample (each pixel a 2x2 block), any dtype."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Int8Neck(Int8Convs):
    """``FeatureNeck`` in int8 (serving only)."""

    def __init__(self, in_channels: Sequence[int], num_blocks: int = NECK_BLOCKS,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c3, c4, c5 = in_channels
        self.in_channels, self.nb, self.dtype = tuple(in_channels), num_blocks, dtype
        self.specs = _neck_specs(c3, c4, c5, num_blocks)
        register_int8_buffers(self, self.specs, _tensor_names(num_blocks))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.training:
            raise RuntimeError("Int8Neck is a serving-only path")
        S, run, nb = self.scale, self.run, self.nb
        p3, p4, p5 = (f.permute(0, 2, 3, 1).float() for f in features)
        q5 = quant_int8(p5, S("x5"))
        lat5 = run("lateral5", q5, S("x5"), S("x4"))
        q4 = quant_int8(p4, S("x4"))
        m4 = torch.cat([_up2(lat5), q4], dim=-1)
        lat4 = run("lateral4", q4, S("x4"), S("x3"))
        q3 = quant_int8(p3, S("x3"))
        m3 = torch.cat([_up2(lat4), q3], dim=-1)

        p4p = self.csp("fpn4", m4, S("x4"), nb, S("pan4_in"))
        p3p = self.csp("fpn3", m3, S("x3"), nb, S("fpn3"))

        p3_out = (p3p.float() * S("fpn3")).to(self.dtype)
        d3 = run("down3", p3p, S("fpn3"), S("pan4_in"))
        p4o = self.csp("pan4", torch.cat([d3, p4p], dim=-1), S("pan4_in"), nb, S("pan4"))
        p4_out = (p4o.float() * S("pan4")).to(self.dtype)
        d4 = run("down4", p4o, S("pan4"), S("pan5_in"))
        q5b = quant_int8(p5, S("pan5_in"))  # the reference's quirk: the raw P5
        p5_out = self.csp("pan5", torch.cat([d4, q5b], dim=-1), S("pan5_in"), nb,
                          None).to(self.dtype)
        return [t.permute(0, 3, 1, 2) for t in (p3_out, p4_out, p5_out)]


def quantize_neck_variables(state: Mapping[str, torch.Tensor],
                            ranges: Mapping[str, Mapping[str, float]], config,
                            stat: str = "pctl") -> Dict[str, torch.Tensor]:
    """A BN-folded canonical ``state_dict`` and the float detector's calibration
    ranges -> the ``state_dict`` of a detector built with ``int8_neck=True``:
    ``neck.*`` replaced by ``Int8Neck``'s buffers, the rest as it is."""
    nb = NECK_BLOCKS
    src = {n: folded_conv(state, f"neck.{n}") for n in ("lateral5", "lateral4", "down3", "down4")}
    for blk in _CSPS:
        for cv in ("cv1", "cv2", "cv3"):
            src[f"{blk}_{cv}"] = folded_conv(state, f"neck.{blk}.{cv}")
        for i in range(nb):
            for cv in ("cv1", "cv2"):
                src[f"{blk}_m{i}_{cv}"] = folded_conv(state, f"neck.{blk}.m{i}.{cv}")
    out = {k: v for k, v in state.items() if not k.startswith("neck.")}
    out.update(quantized_state(src, _range_key_map(nb), ranges, stat, "neck."))
    return out
