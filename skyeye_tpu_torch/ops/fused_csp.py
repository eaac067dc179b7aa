"""Serving-path fused CSP: the module and its state_dict transform.

Port of ``skyeye_tpu/ops/fused_csp.py``. ``fused_csp=True`` on the detector swaps
the stage-1 CSP for ``FusedCSPBlock`` (flat parameters, one kernel launch:
``ops/csp_kernel.py``), and ``fuse_csp_state`` rewrites a BN-folded canonical
``state_dict`` (``utils/checkpoint.py::fuse_conv_bn``) into that layout.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .csp_kernel import TILE_ROWS, WEIGHT_NAMES, PreparedCSPWeights, csp_fused_v2, prepare_weights


class FusedCSPBlock(nn.Module):
    """CSP block computed by the fused kernel (serving only).

    The parameters are flat and in the JAX layout (``w_cv1`` (C, h), ...,
    ``w_m2`` (nb, 3, 3, h, h)); they come from ``fuse_csp_state`` and are never
    trained. Takes NCHW, runs the kernel on the activations in bf16 and
    channels-last and returns ``dtype`` (an NCHW view of channels-last memory),
    as JAX's block does. In a bf16 detector whose activations are channels-last
    already, that is no copy on either side; in a float32 one, a bf16 copy in and
    a float32 copy out.

    ``prepare()`` packs the kernel's weights from the parameters once
    (``fused_csp_detector`` calls it after loading and placing them), so a served
    call launches only the kernel. Call it again after changing or moving the
    parameters.
    """

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, h, nb = in_channels, out_channels // 2, num_blocks  # hidden: expansion 0.5
        self.num_blocks = nb
        self.dtype = dtype
        shapes = {"w_cv1": (c, h), "b_cv1": (h,), "w_m1": (nb, h, h), "b_m1": (nb, h),
                  "w_m2": (nb, 3, 3, h, h), "b_m2": (nb, h), "w_cv2": (c, h), "b_cv2": (h,),
                  "w_cv3": (2 * h, out_channels), "b_cv3": (out_channels,)}
        for name in WEIGHT_NAMES:
            self.register_parameter(name, nn.Parameter(torch.zeros(shapes[name]),
                                                       requires_grad=False))
        self.prepared: Optional[PreparedCSPWeights] = None

    def prepare(self) -> PreparedCSPWeights:
        """Pack the kernel's weights from the parameters, where they are."""
        weights = {name: getattr(self, name) for name in WEIGHT_NAMES}
        self.prepared = prepare_weights(weights, self.num_blocks)
        return self.prepared

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("FusedCSPBlock is a serving-only path; call .eval()")
        if self.prepared is None or self.prepared.frags.device != x.device:
            raise RuntimeError("FusedCSPBlock's packed weights are not prepared on "
                               f"{x.device}; call prepare() after loading or moving them")
        xh = x.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
        out = csp_fused_v2(xh, self.prepared, self.num_blocks, TILE_ROWS)
        return out.permute(0, 3, 1, 2).to(self.dtype)


def _require_identity_bn(state: Mapping[str, torch.Tensor], bn: str) -> None:
    if not (torch.allclose(state[f"{bn}.weight"], torch.tensor(1.0))
            and torch.allclose(state[f"{bn}.running_mean"], torch.tensor(0.0))):
        raise ValueError(f"{bn}: weights are not BN-folded; run "
                         "utils.checkpoint.fuse_conv_bn first (FusedCSPBlock consumes "
                         "folded conv + bias weights)")


def fuse_csp_state(state: Mapping[str, torch.Tensor],
                   prefix: str = "backbone.csp1") -> Dict[str, torch.Tensor]:
    """Rewrite one canonical, BN-folded CSP's entries into ``FusedCSPBlock``'s flat
    parameters; every other entry is kept. Raises ``ValueError`` on weights that
    are not BN-folded."""
    def conv_wb(module: str, squeeze_1x1: bool):
        _require_identity_bn(state, f"{module}.bn")
        k = state[f"{module}.conv.weight"]  # (out, in, kh, kw)
        k = k[:, :, 0, 0].t() if squeeze_1x1 else k.permute(2, 3, 1, 0)
        return k.contiguous(), state[f"{module}.bn.bias"]

    nb = 0
    while f"{prefix}.m{nb}.cv1.conv.weight" in state:
        nb += 1
    flat = {}
    for name in ("cv1", "cv2", "cv3"):
        flat[f"w_{name}"], flat[f"b_{name}"] = conv_wb(f"{prefix}.{name}", True)
    m1 = [conv_wb(f"{prefix}.m{i}.cv1", True) for i in range(nb)]
    m2 = [conv_wb(f"{prefix}.m{i}.cv2", False) for i in range(nb)]
    flat["w_m1"], flat["b_m1"] = torch.stack([w for w, _ in m1]), torch.stack([b for _, b in m1])
    flat["w_m2"], flat["b_m2"] = torch.stack([w for w, _ in m2]), torch.stack([b for _, b in m2])

    out = {k: v for k, v in state.items() if not k.startswith(prefix + ".")}
    out.update({f"{prefix}.{name}": flat[name] for name in WEIGHT_NAMES})
    return out
