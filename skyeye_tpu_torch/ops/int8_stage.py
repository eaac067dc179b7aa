"""Int8 post-training-quantized early backbone (serving only), and the int8 conv.

Port of ``skyeye_tpu/ops/int8_stage.py``. Symmetric int8: per-output-channel
weight scales, static per-tensor activation scales from calibration
(``ops/calibrate.observe_ranges`` on the packed-stem serving model). Each conv
is an int8 x int8 -> int32 product (``int8_conv``); a float32 epilogue, in
JAX's order, applies (in_scale * w_scale), the bias and SiLU, adds a residual
as ``residual_q * residual_scale``, then requantizes to the consumer's scale,
or returns bf16 where there is none (in a float32 model too, as JAX's
``_qconv`` does). So every tensor stored between layers is int8. Rounding is
half to even (``torch.round``, as ``jnp.round``) and the clip is to +-127.

``int8_conv`` is the port's int8 convolution on NHWC int8 input and an HWIO
int8 kernel. JAX leaves it to XLA (``lax.conv_general_dilated`` with an int32
result, no Pallas kernel), so here it is a library integer GEMM, as a plain
matrix product outside any kernel is: on a CUDA tensor ``int8_conv_mm``, the
im2col matrix (the k x k windows of a zero-padded NHWC tensor taken by
strides, then one copy) times the kernel through ``torch._int_mm``, with rows
padded to more than 16 and the depth and width to multiples of 8 with zeros,
which keeps the product exact; on a CPU tensor ``int8_conv_plain``, a float64
convolution (every partial sum is an integer below 2^53, so it is exact too).
``LAUNCHES`` counts the GEMMs ``int8_conv`` issues on the card.

``Int8EarlyStage`` runs stages 1-2 (stem -> csp2, P3) of the packed-stem
backbone (``CSPDarknet(int8_early=True, packed_stem=True)``); its buffers
come from ``quantize_early_variables``. They are int8 kernels and float32
scales and biases in JAX's layout (HWIO), buffers with no gradient, which
``module.to(dtype)`` leaves alone. The module takes NCHW and returns an NCHW
view of NHWC memory in the model's dtype.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# GEMMs int8_conv issued on the card since the last reset
LAUNCHES: Dict[str, int] = {"int8_conv": 0}

Padding = Tuple[Tuple[int, int], Tuple[int, int]]
P1: Padding = ((1, 1), (1, 1))
P0: Padding = ((0, 0), (0, 0))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: Padding):
    """(B, H, W, C) -> ((B Ho Wo, kh kw C) windows, (B, Ho, Wo)); a 1x1 stride-1
    conv reads the input as it is."""
    B, H, W, C = x.shape
    (t, b), (l, r) = padding
    if (kh, kw, stride, t, b, l, r) == (1, 1, 1, 0, 0, 0, 0):
        return x.reshape(B * H * W, C), (B, H, W)
    xp = x.new_zeros((B, H + t + b, W + l + r, C))
    xp[:, t: t + H, l: l + W] = x
    ho, wo = (H + t + b - kh) // stride + 1, (W + l + r - kw) // stride + 1
    sb, sh, sw, sc = xp.stride()
    win = xp.as_strided((B, ho, wo, kh, kw, C), (sb, stride * sh, stride * sw, sh, sw, sc))
    return win.reshape(B * ho * wo, kh * kw * C), (B, ho, wo)


def int8_conv_mm(x_q: torch.Tensor, k_q: torch.Tensor, stride: int, padding: Padding
                 ) -> torch.Tensor:
    """The card's route: im2col, then ``torch._int_mm`` (the kernel's matrix
    column-major, zero-padded to its constraints). Runs on either device."""
    kh, kw, cin, cout = k_q.shape
    a, (B, ho, wo) = _im2col(x_q, kh, kw, stride, padding)
    m, k = a.shape
    m_pad, k_pad, n_pad = (m if m > 16 else 32), _round_up(k, 8), _round_up(cout, 8)
    if (m_pad, k_pad) != (m, k):
        padded = a.new_zeros((m_pad, k_pad))
        padded[:m, :k] = a
        a = padded
    w_t = k_q.new_zeros((n_pad, k_pad))  # (n, k) row-major: the (k, n) operand column-major
    w_t[:cout, :k] = k_q.reshape(k, cout).t()
    y = torch._int_mm(a.contiguous(), w_t.t())
    return y[:m, :cout].reshape(B, ho, wo, cout)


def int8_conv_plain(x_q: torch.Tensor, k_q: torch.Tensor, stride: int, padding: Padding
                    ) -> torch.Tensor:
    """The same int32 result as a float64 convolution, rounded (exact)."""
    (t, b), (l, r) = padding
    x = F.pad(x_q.permute(0, 3, 1, 2).double(), (l, r, t, b))
    y = F.conv2d(x, k_q.permute(3, 2, 0, 1).double(), stride=stride)
    return y.round().to(torch.int32).permute(0, 2, 3, 1)


def int8_conv(x_q: torch.Tensor, k_q: torch.Tensor, stride: int = 1,
              padding: Padding = P0) -> torch.Tensor:
    """(B, H, W, Cin) int8 NHWC x (kh, kw, Cin, Cout) int8 HWIO -> (B, Ho, Wo, Cout)
    int32, zero padding ((top, bottom), (left, right)): ``int8_conv_mm`` on a
    CUDA tensor, ``int8_conv_plain`` on a CPU one."""
    if x_q.dtype != torch.int8 or k_q.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {x_q.dtype} and {k_q.dtype}")
    if x_q.shape[-1] != k_q.shape[2]:
        raise ValueError(f"input has {x_q.shape[-1]} channels, the kernel takes {k_q.shape[2]}")
    if x_q.device.type == "cpu":
        return int8_conv_plain(x_q, k_q, stride, padding)
    if x_q.device.type != "cuda":
        raise ValueError(f"unsupported device {x_q.device}")
    y = int8_conv_mm(x_q, k_q, stride, padding)
    LAUNCHES["int8_conv"] += 1
    return y


def quant_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 -> int8 with a symmetric per-tensor scale."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _qconv(x_q, k_q, in_scale, w_scale, bias, *, stride=1, padding, out_scale=None,
           residual_q=None, residual_scale=None):
    """int8 conv + float32 epilogue (dequant -> bias -> SiLU [-> + residual]) ->
    requant to out_scale (or bf16 when out_scale is None)."""
    y = int8_conv(x_q, k_q, stride, padding).float() * (in_scale * w_scale)
    y = y + bias
    y = y * torch.sigmoid(y)  # SiLU, as JAX writes it
    if residual_q is not None:
        y = y + residual_q.float() * residual_scale
    if out_scale is None:
        return y.to(torch.bfloat16)
    return quant_int8(y, out_scale)


def register_int8_buffers(module: nn.Module, specs: Dict[str, tuple], scales) -> None:
    """``{name}_k`` (kh, kw, cin, cout) int8, ``{name}_ws`` and ``{name}_b`` (cout,)
    float32 for each conv spec; ``s_{t}`` () float32 for each tensor scale."""
    for name, (kh, kw, cin, cout, *_) in specs.items():
        module.register_buffer(f"{name}_k", torch.zeros((kh, kw, cin, cout), dtype=torch.int8))
        module.register_buffer(f"{name}_ws", torch.zeros(cout))
        module.register_buffer(f"{name}_b", torch.zeros(cout))
    for t in scales:
        module.register_buffer(f"s_{t}", torch.zeros(()))


class Int8Convs(nn.Module):
    """The shared body of the int8 modules: their buffers, ``run`` (one conv
    by name) and ``csp`` (a CSP block whose concat operands share one scale)."""

    specs: Dict[str, tuple]

    def scale(self, name: str) -> torch.Tensor:
        return getattr(self, f"s_{name}")

    def run(self, name, x_q, in_s, out_s, residual_q=None, residual_scale=None):
        *_, stride, pad = self.specs[name]
        return _qconv(x_q, getattr(self, f"{name}_k"), in_s, getattr(self, f"{name}_ws"),
                      getattr(self, f"{name}_b"), stride=stride, padding=pad,
                      out_scale=out_s, residual_q=residual_q, residual_scale=residual_scale)

    def csp(self, prefix, x_q, in_s, nb, out_s):
        y1_s = self.scale(f"{prefix}_cv1")
        y1 = self.run(f"{prefix}_cv1", x_q, in_s, y1_s)
        cat_s = self.scale(f"{prefix}_cat")
        for i in range(nb):
            a_s = self.scale(f"{prefix}_m{i}_cv1")
            a = self.run(f"{prefix}_m{i}_cv1", y1, y1_s, a_s)
            next_s = cat_s if i == nb - 1 else self.scale(f"{prefix}_m{i}")
            y1 = self.run(f"{prefix}_m{i}_cv2", a, a_s, next_s,
                          residual_q=y1, residual_scale=y1_s)
            y1_s = next_s
        y2 = self.run(f"{prefix}_cv2", x_q, in_s, cat_s)
        return self.run(f"{prefix}_cv3", torch.cat([y1, y2], dim=-1), cat_s, out_s)


class Int8EarlyStage(Int8Convs):
    """Stages 1-2 of the packed-stem serving backbone in int8. Input: the
    packed (B, 48, S/4, S/4) frames in [0, 1] (NCHW); output: P3
    (B, c3, S/8, S/8) in ``dtype``."""

    def __init__(self, c1: int, c2: int, c3: int, nb1: int, nb2: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.nb1, self.nb2, self.dtype = nb1, nb2, dtype
        self.specs = _conv_specs(c1, c2, c3, nb1, nb2)
        register_int8_buffers(self, self.specs, _tensor_names(nb1, nb2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("Int8EarlyStage is a serving-only path")
        S = self.scale
        xq = quant_int8(x.permute(0, 2, 3, 1).float(), S("x"))
        t = self.run("stem", xq, S("x"), S("stem"))
        t = self.run("down1", t, S("stem"), S("down1"))
        t = self.csp("c1", t, S("down1"), self.nb1, S("c1"))
        t = self.run("down2", t, S("c1"), S("down2"))
        out = self.csp("c2", t, S("down2"), self.nb2, None)
        return out.to(self.dtype).permute(0, 3, 1, 2)


def _conv_specs(c1, c2, c3, nb1, nb2) -> Dict[str, tuple]:
    """name -> (kh, kw, cin, cout, stride, padding)."""
    h1, h2 = c2 // 2, c3 // 2
    specs = {
        "stem": (3, 3, 48, 4 * c1, 1, P1),
        "down1": (2, 2, 4 * c1, c2, 1, ((1, 0), (1, 0))),
        "c1_cv1": (1, 1, c2, h1, 1, P0),
        "c1_cv2": (1, 1, c2, h1, 1, P0),
        "c1_cv3": (1, 1, 2 * h1, c2, 1, P0),
        "down2": (3, 3, c2, c3, 2, P1),
        "c2_cv1": (1, 1, c3, h2, 1, P0),
        "c2_cv2": (1, 1, c3, h2, 1, P0),
        "c2_cv3": (1, 1, 2 * h2, c3, 1, P0),
    }
    for i in range(nb1):
        specs[f"c1_m{i}_cv1"] = (1, 1, h1, h1, 1, P0)
        specs[f"c1_m{i}_cv2"] = (3, 3, h1, h1, 1, P1)
    for i in range(nb2):
        specs[f"c2_m{i}_cv1"] = (1, 1, h2, h2, 1, P0)
        specs[f"c2_m{i}_cv2"] = (3, 3, h2, h2, 1, P1)
    return specs


def _tensor_names(nb1, nb2):
    names = ["x", "stem", "down1", "c1_cv1", "c1_cat", "c1", "down2", "c2_cv1", "c2_cat"]
    for i in range(nb1):
        names += [f"c1_m{i}_cv1"] + ([f"c1_m{i}"] if i < nb1 - 1 else [])
    for i in range(nb2):
        names += [f"c2_m{i}_cv1"] + ([f"c2_m{i}"] if i < nb2 - 1 else [])
    return names


def _range_key_map(nb1, nb2) -> Dict[str, object]:
    """Tensor scale -> the captured path(s) of the packed-stem model that set it."""
    m = {
        "x": None,  # packed input in [0, 1]
        "stem": "backbone/stem",
        "down1": "backbone/down1",
        "c1_cv1": "backbone/csp1/cv1",
        "c1_cat": ("max", f"backbone/csp1/m{nb1 - 1}", "backbone/csp1/cv2"),
        "c1": "backbone/csp1",
        "down2": "backbone/down2",
        "c2_cv1": "backbone/csp2/cv1",
        "c2_cat": ("max", f"backbone/csp2/m{nb2 - 1}", "backbone/csp2/cv2"),
    }
    for i in range(nb1):
        m[f"c1_m{i}_cv1"] = f"backbone/csp1/m{i}/cv1"
        if i < nb1 - 1:
            m[f"c1_m{i}"] = f"backbone/csp1/m{i}"
    for i in range(nb2):
        m[f"c2_m{i}_cv1"] = f"backbone/csp2/m{i}/cv1"
        if i < nb2 - 1:
            m[f"c2_m{i}"] = f"backbone/csp2/m{i}"
    return m


def folded_conv(state: Mapping[str, torch.Tensor], module: str):
    """A BN-folded ConvBlock's (HWIO kernel, bias) as float32 numpy."""
    from .fused_csp import _require_identity_bn

    _require_identity_bn(state, f"{module}.bn")
    k = state[f"{module}.conv.weight"].detach().cpu().numpy().transpose(2, 3, 1, 0)
    return k, state[f"{module}.bn.bias"].detach().cpu().numpy()


def quantized_state(src: Dict[str, tuple], key_map: Dict[str, object],
                    ranges: Mapping[str, Mapping[str, float]], stat: str, prefix: str
                    ) -> Dict[str, torch.Tensor]:
    """``{prefix}{name}_k/_ws/_b`` from each folded (kernel, bias) and
    ``{prefix}s_{tensor}`` from the ranges, JAX's arithmetic in numpy."""
    from .calibrate import quantize_weight_per_channel, symmetric_scale

    flat: Dict[str, torch.Tensor] = {}
    for name, (k, b) in src.items():
        kq, ws = quantize_weight_per_channel(k)
        flat[f"{prefix}{name}_k"] = torch.from_numpy(np.ascontiguousarray(kq))
        flat[f"{prefix}{name}_ws"] = torch.from_numpy(ws)
        flat[f"{prefix}{name}_b"] = torch.from_numpy(np.asarray(b, np.float32).copy())
    for tensor, key in key_map.items():
        if key is None:
            absmax = 1.0
        elif isinstance(key, tuple):
            absmax = max(ranges[k][stat] for k in key[1:])
        else:
            absmax = ranges[key][stat]
        flat[f"{prefix}s_{tensor}"] = torch.tensor(np.float32(symmetric_scale(absmax)))
    return flat


def quantize_early_variables(state: Mapping[str, torch.Tensor],
                             ranges: Mapping[str, Mapping[str, float]], config,
                             stat: str = "pctl") -> Dict[str, torch.Tensor]:
    """A BN-folded, stem-packed ``state_dict`` (``pack_stem_variables`` after
    ``fuse_conv_bn``) and the packed-stem model's calibration ranges -> the
    ``state_dict`` of a detector built with ``int8_early=True``: the backbone's
    stem, down1, csp1, down2 and csp2 replaced by ``backbone.int8_early.*``;
    the deeper stages as they are."""
    from ..models.backbone import scaled_channels, scaled_depth

    c1, c2, c3 = (scaled_channels(config.base_channels * m, config.width_multiple)
                  for m in (1, 2, 4))
    nb1, nb2 = scaled_depth(3, config.depth_multiple), scaled_depth(9, config.depth_multiple)
    bb = "backbone"
    src = {n: folded_conv(state, f"{bb}.{n}") for n in ("stem", "down1", "down2")}
    for pfx, blk, nb in (("c1", "csp1", nb1), ("c2", "csp2", nb2)):
        for cv in ("cv1", "cv2", "cv3"):
            src[f"{pfx}_{cv}"] = folded_conv(state, f"{bb}.{blk}.{cv}")
        for i in range(nb):
            for cv in ("cv1", "cv2"):
                src[f"{pfx}_m{i}_{cv}"] = folded_conv(state, f"{bb}.{blk}.m{i}.{cv}")
    gone = tuple(f"{bb}.{n}." for n in ("stem", "down1", "csp1", "down2", "csp2"))
    out = {k: v for k, v in state.items() if not k.startswith(gone)}
    out.update(quantized_state(src, _range_key_map(nb1, nb2), ranges, stat,
                               f"{bb}.int8_early."))
    return out
