"""SkyEye detector assembly: backbone + neck (+ the enhanced variant's
cross-layer attention) + head (+ the transformer P5 head).

Port of ``SkyEyeDetectorModule`` and ``create_detector`` in
``skyeye_tpu/models/detector.py``. The module takes NCHW images and returns the
raw per-level logits in the JAX layout; decode is a separate function. It
computes in ``dtype`` (float32 or bfloat16) with float32 parameters, so its
``state_dict`` is the same in either. The transformer variant runs its P5
attention through the fused kernel (K4); the enhanced variant adds
``CrossLayerAttention`` P5 -> P4, then P4 -> P3, each to its level;
``fused_csp=True`` is the fused-CSP serving mode (K3), built from folded
weights by ``fused_csp_detector``. The int8 serving modes are JAX's flags:
``packed_stem`` (the s2d4 input layout), ``int8_stem`` and ``int8_early`` (on
it), and ``int8_neck`` (``ops/int8_neck.py``), each with the ``state_dict``
its quantizer writes. ``remat`` recomputes activations in the
backward pass at JAX's levels: "block" (or True) each CSP and SPP block of the
backbone and the neck, "stage" the backbone's four stages and the whole neck;
the head, and K4 in it, runs once per forward at every level. Parameter names
and values do not depend on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch
from torch import nn

from ..config import ModelConfig, load_model_config
from ..ops.fused_csp import fuse_csp_state
from ..ops.int8_neck import Int8Neck
from ..utils.checkpoint import fuse_conv_bn
from ..utils.general import resolve_device
from .attention import CrossLayerAttention
from .backbone import CSPDarknet, feature_channels, remat_level
from .blocks import remat as recompute
from .head import DetectionHead, decode_predictions
from .neck import FeatureNeck


class SkyEyeDetectorModule(nn.Module):
    """Full detector: returns raw per-level logits (B, H, W, na, nc + 5)."""

    def __init__(self, config: ModelConfig, fused_csp: bool = False,
                 dtype: torch.dtype = torch.float32, remat: Union[bool, str] = False,
                 packed_stem: bool = False, int8_early: bool = False, int8_stem: bool = False,
                 int8_neck: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.int8_neck = int8_neck
        self.remat = remat_level(remat)
        channels = feature_channels(config.base_channels, config.width_multiple)
        self.backbone = CSPDarknet(config.base_channels, config.depth_multiple,
                                   config.width_multiple, config.in_channels, fused_csp,
                                   dtype=dtype, remat=self.remat, packed_stem=packed_stem,
                                   int8_early=int8_early, int8_stem=int8_stem)
        if int8_neck:  # serving only: never recomputed
            self.remat = ""
            self.neck = Int8Neck(channels, dtype=dtype)
        else:
            self.neck = FeatureNeck(channels, dtype=dtype, remat=self.remat == "block")
        if config.enhanced:  # named as in flax, beside backbone, neck and head
            c3, c4, c5 = channels
            ref_exact = config.ref_exact_cross_attn
            self.cross_attn_p5_p4 = CrossLayerAttention(c4, c5, region_size=2, heads=4,
                                                        ref_exact=ref_exact, dtype=dtype)
            self.cross_attn_p4_p3 = CrossLayerAttention(c3, c4, region_size=2, heads=4,
                                                        ref_exact=ref_exact, dtype=dtype)
        self.head = DetectionHead(channels, config.nc, config.num_anchors,
                                  config.transformer_heads, dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.backbone(x)
        if self.remat == "stage":
            p3, p4, p5 = recompute(lambda *f: self.neck(f), *feats)
        else:
            p3, p4, p5 = self.neck(feats)
        if self.config.enhanced:
            p4 = self.cross_attn_p5_p4(p4, p5) + p4
            p3 = self.cross_attn_p4_p3(p3, p4) + p3
        return self.head([p3, p4, p5])

    def decode(self, outputs, input_shape) -> torch.Tensor:
        return decode_predictions(outputs, self.config.anchors, input_shape)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's scales: conv kernels of the
    conv+BN blocks ~ N(0, 2 / fan_out); other convs and the dense layers ~
    N(0, 1 / fan_in); biases 0; BN and LayerNorm the identity."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            o, i, kh, kw = m.weight.shape
            bn_conv = name.endswith(".conv") and not name.endswith("spatial.conv")
            std = math.sqrt(2.0 / (o * kh * kw)) if bn_conv else math.sqrt(1.0 / (i * kh * kw))
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features)
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()


def create_detector(cfg: Union[str, dict, ModelConfig] = "skyeye_s",
                    num_classes: Optional[int] = None, anchors=None,
                    dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device] = "cuda",
                    seed: int = 0, remat: Union[bool, str] = False) -> SkyEyeDetectorModule:
    """Build the detector with weights made from ``seed``, in eval mode on ``device``,
    computing in ``dtype`` (parameters float32), recomputing at ``remat``'s level
    in training.

    ``num_classes`` / ``anchors`` override the config's values; the config's
    ``ref_exact_cross_attn`` picks the enhanced variant's attention mode."""
    dev = resolve_device(device)
    config = load_model_config(cfg)
    if num_classes is not None and num_classes != config.nc:
        config = dataclasses.replace(config, nc=num_classes)
    if anchors is not None:
        config = dataclasses.replace(config, anchors=tuple(
            tuple(tuple(float(v) for v in a) for a in level) for level in anchors))
    module = SkyEyeDetectorModule(config, dtype=dtype, remat=remat)
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.eval().to(dev)


@torch.no_grad()
def fused_csp_detector(module: SkyEyeDetectorModule) -> SkyEyeDetectorModule:
    """The fused-CSP serving form of a canonical detector: every conv + BN folded
    (``fuse_conv_bn``), stage-1's CSP rewritten for ``FusedCSPBlock``
    (``fuse_csp_state``), in the module's ``dtype``, in eval mode on its device,
    with the kernel's packed weights prepared. The port of what ``bench.py``
    does with ``SKYEYE_FUSED_CSP=1`` (there in bfloat16 throughout)."""
    device = next(module.parameters()).device
    state = fuse_csp_state(fuse_conv_bn(module.state_dict()), prefix="backbone.csp1")
    fused = SkyEyeDetectorModule(module.config, fused_csp=True, dtype=module.dtype)
    fused.load_state_dict(state, strict=True)
    fused = fused.eval().to(device)
    fused.backbone.csp1.prepare()
    return fused
