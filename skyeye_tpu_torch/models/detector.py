"""SkyEye detector assembly: backbone + neck + head (+ the transformer P5 head).

Port of ``SkyEyeDetectorModule`` and ``create_detector`` in
``skyeye_tpu/models/detector.py``. The module takes NCHW images and returns the
raw per-level logits in the JAX layout; decode is a separate function. The
transformer variant runs its P5 attention through the fused kernel (K4);
``fused_csp=True`` is the fused-CSP serving mode (K3), built from folded weights
by ``fused_csp_detector``. The enhanced variant comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch
from torch import nn

from ..config import ModelConfig, load_model_config
from ..ops.fused_csp import fuse_csp_state
from ..utils.checkpoint import fuse_conv_bn
from ..utils.general import resolve_device
from .backbone import CSPDarknet, feature_channels
from .head import DetectionHead, decode_predictions
from .neck import FeatureNeck


class SkyEyeDetectorModule(nn.Module):
    """Full detector: returns raw per-level logits (B, H, W, na, nc + 5)."""

    def __init__(self, config: ModelConfig, fused_csp: bool = False):
        super().__init__()
        if config.enhanced:
            raise NotImplementedError(
                "the enhanced variant is not ported yet (ROADMAP.md Queue 1, Slice D)")
        self.config = config
        channels = feature_channels(config.base_channels, config.width_multiple)
        self.backbone = CSPDarknet(config.base_channels, config.depth_multiple,
                                   config.width_multiple, config.in_channels, fused_csp)
        self.neck = FeatureNeck(channels)
        self.head = DetectionHead(channels, config.nc, config.num_anchors,
                                  config.transformer_heads)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.head(self.neck(self.backbone(x)))

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
                    device: Union[str, torch.device] = "cuda",
                    seed: int = 0) -> SkyEyeDetectorModule:
    """Build the detector with weights made from ``seed``, in eval mode on ``device``.

    ``num_classes`` / ``anchors`` override the config's values."""
    dev = resolve_device(device)
    config = load_model_config(cfg)
    if num_classes is not None and num_classes != config.nc:
        config = dataclasses.replace(config, nc=num_classes)
    if anchors is not None:
        config = dataclasses.replace(config, anchors=tuple(
            tuple(tuple(float(v) for v in a) for a in level) for level in anchors))
    module = SkyEyeDetectorModule(config)
    init_weights(module, torch.Generator().manual_seed(seed))
    return module.eval().to(dev)


@torch.no_grad()
def fused_csp_detector(module: SkyEyeDetectorModule) -> SkyEyeDetectorModule:
    """The fused-CSP serving form of a canonical detector: every conv + BN folded
    (``fuse_conv_bn``), stage-1's CSP rewritten for ``FusedCSPBlock``
    (``fuse_csp_state``), in eval mode on the module's device, with the kernel's
    packed weights prepared. The port of what ``bench.py`` does with
    ``SKYEYE_FUSED_CSP=1``."""
    device = next(module.parameters()).device
    state = fuse_csp_state(fuse_conv_bn(module.state_dict()), prefix="backbone.csp1")
    fused = SkyEyeDetectorModule(module.config, fused_csp=True)
    fused.load_state_dict(state, strict=True)
    fused = fused.eval().to(device)
    fused.backbone.csp1.prepare()
    return fused
