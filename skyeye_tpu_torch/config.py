"""Model configuration: the s/m/l family, anchors and strides.

Port of ``skyeye_tpu/config.py`` (the ``ModelConfig`` plane). The five model
configurations the repository ships under ``configs/models/`` are held here as
plain Python literals, so the serving path needs no YAML parser; ``yaml`` is
imported only inside :meth:`ModelConfig.from_yaml`, for a caller who passes a
path. Anchors are in grid units per level (strides 8/16/32).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Tuple

# YOLOv5-convention anchors in grid units (pixel anchors / stride for strides 8/16/32).
DEFAULT_ANCHORS: Tuple[Tuple[Tuple[float, float], ...], ...] = (
    ((1.25, 1.625), (2.0, 3.75), (4.125, 2.875)),        # P3/8
    ((1.875, 3.8125), (3.875, 2.8125), (3.6875, 7.4375)),  # P4/16
    ((3.625, 2.8125), (4.875, 6.1875), (11.65625, 10.1875)),  # P5/32
)

STRIDES: Tuple[int, int, int] = (8, 16, 32)

# (depth_multiple, width_multiple) of the s/m/l family.
VARIANTS: Dict[str, Tuple[float, float]] = {
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.0, 1.0),
}

# The shipped model configurations (configs/models/<name>.yaml), as literals.
MODEL_CONFIGS: Dict[str, Dict[str, Any]] = {
    "skyeye_s": {"nc": 80, "base_channels": 64, "depth_multiple": 0.33,
                 "width_multiple": 0.5, "variant": "s"},
    "skyeye_m": {"nc": 80, "base_channels": 64, "depth_multiple": 0.67,
                 "width_multiple": 0.75, "variant": "m"},
    "skyeye_l": {"nc": 80, "base_channels": 64, "depth_multiple": 1.0,
                 "width_multiple": 1.0, "variant": "l"},
    "skyeye_l_enhanced": {"nc": 80, "base_channels": 64, "depth_multiple": 1.0,
                          "width_multiple": 1.0, "variant": "l", "enhanced": True},
    "skyeye_l_transformer": {"nc": 80, "base_channels": 64, "depth_multiple": 1.0,
                             "width_multiple": 1.0, "variant": "l",
                             "transformer_heads": True},
}


@dataclass
class ModelConfig:
    """Architecture configuration for a SkyEye detector."""

    nc: int = 80
    base_channels: int = 64
    depth_multiple: float = 1.0
    width_multiple: float = 0.5
    anchors: Tuple[Tuple[Tuple[float, float], ...], ...] = DEFAULT_ANCHORS
    strides: Tuple[int, ...] = STRIDES
    in_channels: int = 3
    enhanced: bool = False  # cross-layer attention in the neck
    transformer_heads: bool = False  # TransformerLayer before the P5 head
    ref_exact_cross_attn: bool = False
    variant: str = "s"

    @property
    def num_levels(self) -> int:
        return len(self.anchors)

    @property
    def num_anchors(self) -> int:
        return len(self.anchors[0])

    @classmethod
    def from_variant(cls, variant: str, nc: int = 80, **kw) -> "ModelConfig":
        name = variant.replace("skyeye_", "")
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; expected one of {list(VARIANTS)}")
        d, w = VARIANTS[name]
        return cls(nc=nc, depth_multiple=d, width_multiple=w, variant=name, **kw)

    @classmethod
    def from_yaml(cls, path) -> "ModelConfig":
        import yaml  # only for a caller who passes a YAML path

        with open(path, errors="ignore") as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ModelConfig":
        kw: Dict[str, Any] = {}
        for key in ("nc", "base_channels", "depth_multiple", "width_multiple",
                    "in_channels", "enhanced", "transformer_heads",
                    "ref_exact_cross_attn", "variant"):
            if key in raw and raw[key] is not None:
                kw[key] = raw[key]
        if raw.get("anchors"):
            anchors = raw["anchors"]
            # accept flat-per-level [[w,h,w,h,...], ...] or nested [[[w,h],...], ...]
            if anchors and not isinstance(anchors[0][0], (list, tuple)):
                anchors = [
                    [tuple(level[i : i + 2]) for i in range(0, len(level), 2)]
                    for level in anchors
                ]
            kw["anchors"] = tuple(tuple(tuple(a) for a in level) for level in anchors)
        return cls(**kw)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["anchors"] = [[list(a) for a in level] for level in self.anchors]
        d["strides"] = list(self.strides)
        return d


def load_model_config(cfg) -> ModelConfig:
    """Resolve a ModelConfig from a shipped config name, variant, YAML path,
    dict, or ModelConfig."""
    if isinstance(cfg, ModelConfig):
        return cfg
    if isinstance(cfg, dict):
        return ModelConfig.from_dict(cfg)
    s = str(cfg)
    if Path(s).exists():
        return ModelConfig.from_yaml(s)
    stem = Path(s).stem
    if stem in MODEL_CONFIGS:
        return ModelConfig.from_dict(MODEL_CONFIGS[stem])
    if stem.replace("skyeye_", "") in VARIANTS:
        return ModelConfig.from_variant(stem)
    raise FileNotFoundError(f"no model config named or found at {s!r}")
