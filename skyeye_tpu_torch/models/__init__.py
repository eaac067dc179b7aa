"""Model components: blocks, attention, backbone, neck, head, detector assembly."""
from .attention import (
    CBAM,
    ChannelAttention,
    MultiHeadSelfAttention,
    SpatialAttention,
    TransformerLayer,
)
from .backbone import CSPDarknet, feature_channels, scaled_channels, scaled_depth
from .blocks import Bottleneck, ConvBlock, CSPBlock, FocusBlock, SPPBlock, space_to_depth_2x2
from .detector import SkyEyeDetectorModule, create_detector, fused_csp_detector
from .head import DetectionHead, decode_predictions, to_reference_layout
from .neck import FeatureNeck, upsample_nearest_2x

__all__ = [
    "CBAM", "ChannelAttention", "MultiHeadSelfAttention", "SpatialAttention",
    "TransformerLayer",
    "CSPDarknet", "feature_channels", "scaled_channels", "scaled_depth",
    "Bottleneck", "ConvBlock", "CSPBlock", "FocusBlock", "SPPBlock", "space_to_depth_2x2",
    "SkyEyeDetectorModule", "create_detector", "fused_csp_detector",
    "DetectionHead", "decode_predictions", "to_reference_layout",
    "FeatureNeck", "upsample_nearest_2x",
]
