"""Model and dataset configuration: the s/m/l family, anchors and strides;
the data YAML's schema; the training hyperparameters.

Port of ``skyeye_tpu/config.py`` (``ModelConfig``, ``DataConfig``,
``DEFAULT_HYP`` and ``load_hyp``). The five
model configurations the repository ships under ``configs/models/`` are held
here as plain Python literals, so the serving path needs no YAML parser;
``yaml`` is imported only inside ``ModelConfig.from_yaml``, for a caller who
passes a path; ``DataConfig.from_yaml`` reads the flat data schema itself, as
the card's machine has no PyYAML; so does ``load_hyp`` with a hyp file
(flat ``key: number`` lines), and ``dump_flat_yaml`` writes the flat files a
training run leaves (``hyp.yaml``, ``opt.yaml``) in a form PyYAML reads to the
same values. Anchors are in grid units per level (strides 8/16/32).
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

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


_SCHEMA = ("path", "train", "val", "test", "nc", "names")
_NULL = ("", "~", "null", "Null", "NULL")
# Bare scalars that PyYAML reads as a bool, a float or an int other than a plain decimal.
_TYPED = re.compile(r"(?i:yes|no|true|false|on|off|[-+]?\.inf|\.nan)"
                    r"|[-+]?(?:[0-9][0-9_:]*(?:\.[0-9_]*)?|\.[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)?"
                    r"|[-+]?0[bBoOxX][0-9a-fA-F_]+")


def _scalar(text: str):
    """A scalar of the data YAML's flat schema: None (``~``, ``null`` or nothing),
    a quoted or bare string, or a decimal int. Anything else (a bool, a float,
    an escape, an anchor, a block scalar) raises, so the reader never gives
    another answer than PyYAML."""
    text = text.strip()
    if text in _NULL:
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        inner = text[1:-1]
        if text[0] in inner or (text[0] == '"' and "\\" in inner):
            raise ValueError(f"data YAML value {text!r} is outside the flat schema")
        return inner
    if re.fullmatch(r"[-+]?(?:0|[1-9][0-9]*)", text):
        return int(text)
    if text[0] in "'\"[]{}&*!|>%@`" or ": " in text or text.endswith(":") or _TYPED.fullmatch(text):
        raise ValueError(f"data YAML value {text!r} is outside the flat schema (quote a string)")
    return text


def _flow(text: str):
    """A value on a key's own line: a scalar, ``[a, b]`` or ``{0: a}``."""
    if text[:1] not in ("[", "{"):
        return _scalar(text)
    if text[-1] != {"[": "]", "{": "}"}[text[0]]:
        raise ValueError(f"data YAML value {text!r} is outside the flat schema")
    items = [item for item in text[1:-1].split(",") if item.strip()]
    if text[0] == "[":
        return [_scalar(item) for item in items]
    pairs = [item.split(":", 1) for item in items]
    if any(len(pair) != 2 for pair in pairs):
        raise ValueError(f"data YAML value {text!r} is outside the flat schema")
    return {_scalar(k): _scalar(v) for k, v in pairs}


def _read_flat_yaml(text: str) -> Dict[str, Any]:
    """The data YAML's flat schema, read without PyYAML (the card's machine has
    none): ``key: value`` (a scalar, ``[a, b]`` or ``{0: a}``), and a block list
    (``- a``) or map (``0: a``) under a bare ``key:``. Keys outside the schema
    are skipped with their blocks, as ``DataConfig`` ignores them; any other
    construct raises."""
    raw: Dict[str, Any] = {}
    key = None  # the bare key whose block is being read
    for line in text.splitlines():
        line = "" if line.lstrip().startswith("#") else line.split(" #", 1)[0].rstrip()
        if not line.strip():
            continue
        if line[0] not in " -":
            name, sep, value = line.partition(":")
            if not sep:
                raise ValueError(f"data YAML line not understood: {line!r}")
            name, value = name.strip(), value.strip()
            if name not in _SCHEMA:
                key = "skip"
                continue
            raw[name] = _flow(value)
            key = name if not value else None
            continue
        if key == "skip":
            continue
        item = line.strip()
        is_list = item == "-" or item.startswith("- ")
        if key is None or not isinstance(raw[key], (type(None), list if is_list else dict)):
            raise ValueError(f"data YAML line not understood: {line!r}")
        if is_list:
            raw[key] = (raw[key] or []) + [_scalar(item[1:])]
        else:
            k, sep, v = item.partition(":")
            if not sep:
                raise ValueError(f"data YAML line not understood: {line!r}")
            raw[key] = {**(raw[key] or {}), _scalar(k): _scalar(v)}
    return raw


@dataclass
class DataConfig:
    """Dataset description (the reference's data-YAML schema)."""

    path: str = ""
    train: str = ""
    val: str = ""
    test: str = ""
    nc: int = 80
    names: List[str] = field(default_factory=list)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any], root=None) -> "DataConfig":
        """Split paths that are relative resolve against ``path`` where the dict
        gives one, else against ``root`` (the YAML's folder), else stay as given."""
        for attr in ("path", "train", "val", "test"):
            if isinstance(raw.get(attr), (list, dict)):
                raise ValueError(f"data {attr!r} must be one path, not {raw[attr]!r}")
        names = raw.get("names") or []
        if isinstance(names, dict):
            names = [names[k] for k in sorted(names)]
        cfg = cls(path=str(raw.get("path") or ""), train=str(raw.get("train") or ""),
                  val=str(raw.get("val") or ""), test=str(raw.get("test") or ""),
                  nc=int(raw.get("nc") or len(names) or 80), names=[str(n) for n in names])
        if not cfg.names:
            cfg.names = [str(i) for i in range(cfg.nc)]
        base = Path(cfg.path) if cfg.path else (Path(root) if root is not None else None)
        if base is not None:
            for attr in ("train", "val", "test"):
                v = getattr(cfg, attr)
                if v and not Path(v).is_absolute():
                    setattr(cfg, attr, str(base / v))
        return cfg

    @classmethod
    def from_yaml(cls, path) -> "DataConfig":
        raw = _read_flat_yaml(Path(path).read_text(errors="ignore"))
        return cls.from_dict(raw, root=Path(path).parent)


# Training and augmentation hyperparameters, JAX's DEFAULT_HYP value for value.
DEFAULT_HYP: Dict[str, float] = {
    "lr0": 0.01,            # initial learning rate
    "lrf": 0.01,            # final lr fraction (cosine/linear target)
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 0.05,            # box loss gain
    "cls": 0.5,             # cls loss gain
    "cls_pw": 1.0,
    "obj": 1.0,             # obj loss gain
    "obj_pw": 1.0,
    "fl_gamma": 1.5,        # focal loss gamma
    "label_smoothing": 0.0,
    "iou_t": 0.2,
    "anchor_t": 4.0,        # anchor ratio threshold
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.0,
    "copy_paste": 0.0,
}

# PyYAML's float: a decimal point is required (``1e-5`` is a string to it).
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?")


def _number(text: str, line: str):
    """An int or float as PyYAML reads it; anything else raises."""
    if re.fullmatch(r"[-+]?(?:0|[1-9][0-9]*)", text):
        return int(text)
    if _YAML_FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    raise ValueError(f"hyp line {line!r}: the value is not a number as YAML reads one")


def load_hyp(path=None) -> Dict[str, float]:
    """DEFAULT_HYP, updated from a flat ``key: number`` hyp file when one is given."""
    hyp = dict(DEFAULT_HYP)
    if path:
        for line in Path(path).read_text(errors="ignore").splitlines():
            line = "" if line.lstrip().startswith("#") else line.split(" #", 1)[0].rstrip()
            if not line.strip() or line.strip() in ("---", "{}"):
                continue
            name, sep, value = line.partition(":")
            if not sep or line[0] == " " or not value.strip():
                raise ValueError(f"hyp line not understood: {line!r} (flat key: number only)")
            hyp[name.strip()] = _number(value.strip(), line)
    return hyp


def _flat_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if abs(v) == float("inf"):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:  # 1e-05 -> 1.0e-05, as PyYAML
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    return "'" + str(v).replace("'", "''") + "'"


def dump_flat_yaml(values: Dict[str, Any]) -> str:
    """``key: value`` lines (bool, int, float or string values) that PyYAML and
    ``load_hyp`` read back to the same numbers; keys in sorted order, as
    ``yaml.safe_dump`` writes them."""
    return "".join(f"{k}: {_flat_value(values[k])}\n" for k in sorted(values))
