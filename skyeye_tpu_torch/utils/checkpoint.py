"""Weights: the flax-variable bridge, reference-layout ``.pt`` files, BN folding.

The port's module names follow the flax module names, so each flax path maps
to one ``state_dict`` key: conv kernels go from HWIO to OIHW, dense kernels
from (in, out) to (out, in), and BatchNorm ``scale``/``bias``/``mean``/``var``
to ``weight``/``bias``/``running_mean``/``running_var``, LayerNorm
``scale``/``bias`` likewise; the flat leaves of ``FusedCSPBlock`` (``w_cv1``,
..., ``b_cv3``) and of the int8 modules (``*_k``, ``*_ws``, ``*_b``, ``s_*``;
``kernel_q``, ``w_scale``, ``bias``, ``tap_sums``) keep their JAX layout, and
int8 stays int8. The caller flattens the flax variables to numpy arrays;
nothing here imports flax.

``export_torch`` is the counterpart of ``skyeye_tpu/cli/export.py::export_torch``:
the reference-layout ``.pt`` that both packages read, key for key and bit for
bit what JAX writes for the same weights.

``load_torch_checkpoint`` reads a reference-layout ``.pt`` (what
``skyeye_tpu/cli/export.py::export_torch`` writes, in any of the reference's
three wrapper conventions) by the name rules of ``skyeye_tpu/utils/checkpoint.py``
into flax paths, then through ``from_jax_variables``; ``merge_matching`` loads
it by shape, leaving the rest of a module's weights as they are, and
``load_model`` is the facade's loader (the port of JAX's ``load_model``).

``save_model`` writes the port's own ``state_dict`` and config to a ``.pt``
that ``load_model`` reads back without conversion (any serving mode's
buffers included); JAX does not read it. ``fuse_conv_bn`` folds
BatchNorm into the preceding conv, on the port's own ``state_dict``.

Training: ``save_train_checkpoint`` writes ``save_model``'s layout with the
EMA weights as its ``state_dict`` (so the facade and ``validate`` serve a
``last.pt`` as JAX serves its ``ema_params``), and beside them the model's own
weights, the optimizer and accumulation state, ``step``, ``epoch``,
``best_fitness`` and the config; ``restore_train_state`` puts one back into a
train state. ``from_jax_train_state`` carries JAX's ``TrainState`` (params,
batch_stats, EMA, the trace or Adam moments, the ``MultiSteps`` counters),
as numpy, into the same fields, so both can start from one mid-run state.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, load_model_config
from ..ops.csp_kernel import WEIGHT_NAMES as _FLAT_LEAVES
from .general import LOGGER

_COLLECTIONS = ("params", "batch_stats")
_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
# the int8 modules' flat leaves (ops/int8_stage.py, int8_neck.py, int8_stem.py)
_INT8_LEAF = re.compile(r"^(?:.+_(?:k|ws|b)|s_.+|kernel_q|w_scale|tap_sums)$")


def from_jax_variables(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Map ``{"params/backbone/stem/conv/kernel": array, ...}`` (the ``/``-joined
    flax paths of ``params`` and ``batch_stats``) to a ``state_dict`` that loads
    into ``SkyEyeDetectorModule`` with ``load_state_dict(strict=True)``."""
    state: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] in _COLLECTIONS:
            parts = parts[1:]
        module, leaf = ".".join(parts[:-1]), parts[-1]
        arr = np.asarray(value)
        arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
        if leaf == "kernel":
            if arr.ndim == 4:  # conv: (kh, kw, in, out) -> (out, in, kh, kw)
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense: (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
            name = "weight"
        elif leaf in _FLAT_LEAVES or _INT8_LEAF.match(leaf):
            name = leaf
        elif leaf in _LEAVES:
            name = _LEAVES[leaf]
            if leaf == "mean":
                state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        else:
            raise KeyError(f"{path}: no state_dict counterpart for leaf {leaf!r}")
        state[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def fuse_conv_bn(state: Mapping[str, torch.Tensor], eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Fold each BatchNorm into the conv before it (``<m>.conv`` + ``<m>.bn``).

    weight' = weight * g and bias' = bias - mean * g with g = scale / sqrt(var + eps);
    the BN is left as the identity plus the folded bias (weight 1, mean 0,
    var 1 - eps), so the same module computes the folded result, as
    ``skyeye_tpu.utils.checkpoint.fuse_conv_bn`` leaves it. Returns a new dict.
    """
    out = dict(state)
    for key in state:
        if not key.endswith(".bn.running_mean"):
            continue
        m = key[: -len(".bn.running_mean")]
        if f"{m}.conv.weight" not in state:
            continue
        g = state[f"{m}.bn.weight"] / torch.sqrt(state[f"{m}.bn.running_var"] + eps)
        out[f"{m}.conv.weight"] = state[f"{m}.conv.weight"] * g[:, None, None, None]
        out[f"{m}.bn.bias"] = state[f"{m}.bn.bias"] - state[key] * g
        out[f"{m}.bn.weight"] = torch.ones_like(g)
        out[key] = torch.zeros_like(g)
        out[f"{m}.bn.running_var"] = torch.ones_like(g) - eps
    return out


# -- reference-layout torch .pt files --------------------------------------------

# Reference module path -> flax path (skyeye_tpu/utils/checkpoint.py's rules).
_PREFIX_RULES = [
    # the Focus stem: its k x k kernel over the space-to-depth image becomes the
    # fused 2k x 2k kernel (fused_stem_kernel, after the rules)
    (r"^backbone\.backbone\.stage1\.0\.conv\.", "backbone/stem/"),
    (r"^backbone\.backbone\.stage1\.1\.", "backbone/down1/"),
    (r"^backbone\.backbone\.stage1\.2\.", "backbone/csp1/"),
    (r"^backbone\.backbone\.stage2\.0\.", "backbone/down2/"),
    (r"^backbone\.backbone\.stage2\.1\.", "backbone/csp2/"),
    (r"^backbone\.backbone\.stage3\.0\.", "backbone/down3/"),
    (r"^backbone\.backbone\.stage3\.1\.", "backbone/csp3/"),
    (r"^backbone\.backbone\.stage3\.2\.channel_attention\.shared_mlp\.0\.",
     "backbone/cbam3/channel/fc1/"),
    (r"^backbone\.backbone\.stage3\.2\.channel_attention\.shared_mlp\.2\.",
     "backbone/cbam3/channel/fc2/"),
    (r"^backbone\.backbone\.stage3\.2\.spatial_attention\.conv\.",
     "backbone/cbam3/spatial/conv/"),
    (r"^backbone\.backbone\.stage4\.0\.", "backbone/down4/"),
    (r"^backbone\.backbone\.stage4\.1\.", "backbone/csp4/"),
    (r"^backbone\.backbone\.stage4\.2\.", "backbone/spp4/"),
    (r"^neck\.lateral_conv5\.", "neck/lateral5/"),
    (r"^neck\.lateral_conv4\.", "neck/lateral4/"),
    (r"^neck\.fpn_conv4\.", "neck/fpn4/"),
    (r"^neck\.fpn_conv3\.", "neck/fpn3/"),
    (r"^neck\.downsample3\.", "neck/down3/"),
    (r"^neck\.downsample4\.", "neck/down4/"),
    (r"^neck\.pan_conv4\.", "neck/pan4/"),
    (r"^neck\.pan_conv5\.", "neck/pan5/"),
    (r"^detection_head\.detection_layers\.(\d+)\.", r"head/pred\1/"),
] + [(rf"^cross_attention_{lv}\.{ref}_projection\.", f"cross_attn_{lv}/{short}_proj/")
     for lv in ("p5_p4", "p4_p3")
     for ref, short in (("query", "q"), ("key", "k"), ("value", "v"), ("output", "out"))]

# Rules inside a block, after the prefix: bottlenecks and conv-block internals.
_INNER_RULES = [
    (r"bottlenecks\.(\d+)\.", r"m\1/"),
    (r"cv1\.", "cv1/"),
    (r"cv2\.", "cv2/"),
    (r"cv3\.", "cv3/"),
    (r"conv\.conv\.", "conv/conv/"),
]

_BN_LEAVES = {"weight": ("scale", "params"), "bias": ("bias", "params"),
              "running_mean": ("mean", "batch_stats"), "running_var": ("var", "batch_stats")}


def _translate_key(torch_key: str) -> Optional[Tuple[str, str]]:
    """A reference ``state_dict`` key -> (flax collection, ``/``-joined flax path),
    or None for a key with no flax counterpart."""
    key = torch_key
    for pat, repl in _PREFIX_RULES:
        if re.match(pat, key):
            key = re.sub(pat, repl, key)
            break
    else:
        return None
    for pat, repl in _INNER_RULES:
        key = re.sub(pat, repl, key)

    m = re.search(r"(?:^|/)(conv|bn)\.(weight|bias|running_mean|running_var|"
                  r"num_batches_tracked)$", key)
    if m:
        mod, leaf = m.group(1), m.group(2)
        base = key[: m.start()].strip("/")
        if mod == "conv":
            name = {"weight": "kernel", "bias": "bias"}.get(leaf)
            return None if name is None else ("params", f"{base}/conv/{name}")
        if leaf == "num_batches_tracked":
            return None
        name, collection = _BN_LEAVES[leaf]
        return collection, f"{base}/bn/{name}"
    # conv and linear modules addressed directly (head preds, attention
    # projections, the CBAM MLP)
    m = re.search(r"[./](weight|bias)$", key)
    if m:
        base = key[: m.start()].strip("/").replace(".", "/")
        return "params", f"{base}/{'bias' if m.group(1) == 'bias' else 'kernel'}"
    return None


# patch order TL, BL, TR, BR of the space-to-depth stem: p -> (dy, dx)
_S2D_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1))


def fused_stem_kernel(k_s2d: np.ndarray) -> np.ndarray:
    """A (k, k, 4C, O) HWIO kernel over the space-to-depth image -> the equal
    (2k, 2k, C, O) stride-2 kernel over the raw image (skyeye_tpu's
    ``models.blocks.fused_stem_kernel``)."""
    k, _, c4, o = k_s2d.shape
    c = c4 // 4
    out = np.zeros((2 * k, 2 * k, c, o), k_s2d.dtype)
    for p, (dy, dx) in enumerate(_S2D_OFFSETS):
        out[dy::2, dx::2] = k_s2d[:, :, p * c: (p + 1) * c]
    return out


def convert_torch_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference-layout ``state_dict`` -> the port's ``state_dict`` entries it
    names. Keys with no counterpart are logged and dropped."""
    flat: Dict[str, np.ndarray] = {}
    unmatched = []
    for key, value in state_dict.items():
        arr = (value.detach().cpu().float().numpy() if isinstance(value, torch.Tensor)
               else np.asarray(value, np.float32))
        tr = _translate_key(key)
        if tr is None:
            unmatched.append(key)
            continue
        collection, path = tr
        if path.endswith("kernel"):  # OIHW -> HWIO, (O, I) -> (I, O): the flax layout
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        flat[f"{collection}/{path}"] = arr
    if unmatched:
        LOGGER.info("torch conversion: %d keys unmatched (e.g. %s)", len(unmatched),
                    unmatched[:3])
    stem = "params/backbone/stem/conv/kernel"
    if stem in flat and flat[stem].shape[2] % 4 == 0:
        flat[stem] = fused_stem_kernel(flat[stem])
    return from_jax_variables(flat)


def unfuse_stem_kernel(k_fused: np.ndarray) -> np.ndarray:
    """Inverse of ``fused_stem_kernel``: (2k, 2k, C, O) -> (k, k, 4C, O)."""
    k2, _, c, o = k_fused.shape
    k = k2 // 2
    out = np.zeros((k, k, 4 * c, o), k_fused.dtype)
    for p, (dy, dx) in enumerate(_S2D_OFFSETS):
        out[:, :, p * c: (p + 1) * c] = k_fused[dy::2, dx::2]
    return out


# flax path -> reference module path: the inverse of _PREFIX_RULES (but the head's
# numbered rule, which _flax_to_torch_key matches apart), as JAX's export map
_INVERSE_PREFIX = {flax.rstrip("/"): pat[1:].replace("\\.", ".").rstrip(".")
                   for pat, flax in _PREFIX_RULES if "(" not in pat}
_EXPORT_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}


def _flax_to_torch_key(path) -> Optional[str]:
    """A flax module path -> its reference module path, or None (JAX's
    ``_flax_to_torch_key``: a bottleneck ``m<i>`` right after a prefix becomes
    ``bottlenecks.<i>``; a head pred conv maps by its index)."""
    joined = "/".join(path)
    for pre, tpre in sorted(_INVERSE_PREFIX.items(), key=lambda kv: -len(kv[0])):
        if joined.startswith(pre + "/") or joined == pre:
            rest = re.sub(r"^m(\d+)", r"bottlenecks.\1", joined[len(pre):].strip("/"))
            rest = rest.replace("/", ".")
            return f"{tpre}.{rest}" if rest else tpre
    m = re.match(r"head/pred(\d+)(?:/(.+))?$", joined)
    if m:
        base = f"detection_head.detection_layers.{m.group(1)}"
        return f"{base}.{m.group(2).replace('/', '.')}" if m.group(2) else base
    return None


def _flax_leaves(module: torch.nn.Module):
    """Each ``state_dict`` entry as its flax leaf: (collection, module path, leaf
    name, tensor), in JAX's tree order (params, then batch_stats; keys sorted)."""
    owners = dict(module.named_modules())
    out = []
    for key, t in module.state_dict().items():
        name, attr = key.rsplit(".", 1)
        owner = owners[name]
        if isinstance(owner, torch.nn.modules.batchnorm._BatchNorm):
            leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                    "running_var": "var"}.get(attr)
            if leaf is None:  # num_batches_tracked: no flax counterpart
                continue
        elif isinstance(owner, torch.nn.LayerNorm):
            leaf = {"weight": "scale"}.get(attr, attr)
        elif isinstance(owner, (torch.nn.Conv2d, torch.nn.Linear)):
            leaf = {"weight": "kernel"}.get(attr, attr)
        else:  # flat leaves (the fused CSP's, the int8 modules')
            leaf = attr
        coll = "batch_stats" if leaf in ("mean", "var") else "params"
        out.append((coll, tuple(name.split(".")), leaf, t))
    out.sort(key=lambda e: (_COLLECTIONS.index(e[0]), e[1] + (e[2],)))
    return out


def reference_state_dict(module: torch.nn.Module) -> Tuple[Dict[str, torch.Tensor], int]:
    """The reference-layout ``state_dict`` of ``module`` and the number of leaves
    with no reference key (skipped), as JAX's ``export_torch`` builds it: the
    fused stem kernel unfused to the reference's k x k over the space-to-depth
    image, kernels in OIHW and dense kernels (out, in) (the port's own
    layouts), BN ``scale``/``mean``/``var`` as ``weight``/``running_mean``/
    ``running_var``. A leaf whose module has a reference key but whose name is
    none of JAX's (the fused CSP's and the int8 stem's flat leaves) is left out
    without being counted, as JAX does."""
    sd: Dict[str, torch.Tensor] = {}
    skipped = 0
    for _coll, path, leaf, t in _flax_leaves(module):
        tkey = _flax_to_torch_key(path)
        if tkey is None:
            skipped += 1
            continue
        v = t.detach().cpu()
        if leaf == "kernel":
            if v.dim() == 4 and path == ("backbone", "stem", "conv"):
                hwio = unfuse_stem_kernel(v.numpy().transpose(2, 3, 1, 0))
                v = torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))
            sd[f"{tkey}.weight"] = v.clone()
        elif leaf in _EXPORT_LEAVES:
            sd[f"{tkey}.{_EXPORT_LEAVES[leaf]}"] = v.clone()
    return sd, skipped


def export_torch(module: torch.nn.Module, path) -> Path:
    """Write ``{"state_dict": <reference keys>, "config": ...}``: the ``.pt`` JAX
    writes with ``skyeye_tpu.cli.export --formats torch`` and reads with its
    ``load_model``, as the port's ``load_model`` does."""
    path = Path(path)
    sd, skipped = reference_state_dict(module)
    torch.save({"state_dict": sd, "config": module.config.to_dict()}, path)
    LOGGER.info("torch export: %s (%d tensors, %d skipped)", path, len(sd), skipped)
    return path


PORT_LAYOUT = "skyeye_tpu_torch"  # a .pt that holds the port's own state_dict


def save_model(module: torch.nn.Module, path) -> Path:
    """Write ``module``'s own ``state_dict`` and config to a ``.pt`` that
    ``load_model`` (and so ``SkyEyeDetector(weights=...)``) reads back as it is."""
    path = Path(path)
    torch.save({"layout": PORT_LAYOUT, "config": module.config.to_dict(),
                "state_dict": {k: v.detach().cpu() for k, v in module.state_dict().items()}},
               path)
    return path


def load_torch_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read a reference-layout ``.pt``: ``{"model": module, ...}``, ``{"state_dict":
    ..., ...}`` or a bare ``state_dict`` (or a bare module); or one that
    ``save_model`` wrote. Returns the port's ``state_dict`` entries and the
    file's other fields (``config`` among them, where ``export_torch`` or
    ``save_model`` wrote it). A ``.pt`` is a pickle: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    meta: Dict[str, Any] = {}
    if isinstance(ckpt, dict) and ckpt.get("layout") == PORT_LAYOUT:
        return dict(ckpt["state_dict"]), {k: v for k, v in ckpt.items() if k != "state_dict"}
    if isinstance(ckpt, dict) and "model" in ckpt and hasattr(ckpt["model"], "state_dict"):
        sd = ckpt["model"].float().state_dict()
        meta = {k: v for k, v in ckpt.items() if k != "model"}
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
        meta = {k: v for k, v in ckpt.items() if k != "state_dict"}
    elif isinstance(ckpt, dict):
        sd = ckpt
    else:
        sd = ckpt.state_dict()
    return convert_torch_state_dict(sd), meta


def merge_matching(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Shape-filtered partial load: each ``target`` entry is replaced by the
    ``source`` entry of the same key and shape. Returns (merged, n_loaded,
    n_total); BN batch counters are not counted."""
    merged, n_loaded, n_total = {}, 0, 0
    for key, value in target.items():
        counted = not key.endswith("num_batches_tracked")
        n_total += counted
        src = source.get(key)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            merged[key] = src.to(value.dtype)
            n_loaded += counted
        else:
            merged[key] = value
    return merged, n_loaded, n_total


def _guess_variant(stem: str) -> str:
    for v in ("s", "m", "l"):
        if stem.endswith(f"_{v}"):
            return v
    return "s"


def load_model(weights, num_classes: Optional[int] = None, dtype: torch.dtype = torch.float32,
               device="cuda", seed: int = 0):
    """The detector ``weights`` names, in eval mode on ``device``: a reference-layout
    ``.pt``/``.pth`` file (its config from the file, else guessed from the file
    name; its weights loaded by shape over a seeded init, the rest logged), or
    a configuration name or path (weights from ``seed``). The port of
    ``skyeye_tpu.utils.checkpoint.load_model``; the facade folds BatchNorm after
    it. An orbax directory needs orbax, which the port does not use: it raises."""
    from ..models.detector import create_detector

    path = Path(str(weights))
    if path.suffix in (".pt", ".pth"):
        if not path.is_file():
            raise FileNotFoundError(f"no weights file at {path}")
        state, meta = load_torch_checkpoint(path)
        meta_cfg = meta.get("config")
        config = (ModelConfig.from_dict(meta_cfg) if meta_cfg else
                  ModelConfig.from_variant(_guess_variant(path.stem), nc=num_classes or 80))
        if num_classes:
            config = dataclasses.replace(config, nc=num_classes)
        module = create_detector(config, dtype=dtype, device=device, seed=seed)
        merged, n_loaded, n_total = merge_matching(module.state_dict(), state)
        module.load_state_dict(merged, strict=True)
        left = sorted({k.rsplit(".", 1)[0] for k, v in module.state_dict().items()
                       if k not in state or tuple(state[k].shape) != tuple(v.shape)})
        LOGGER.info("loaded %d/%d tensors from %s", n_loaded, n_total, path)
        if left:
            LOGGER.info("left at their seeded init (not in the file, or another shape): %s",
                        ", ".join(left))
    elif path.is_dir():
        raise ValueError(f"{path} is a directory (an orbax checkpoint?): reading one needs "
                         "orbax, which the port does not use; export it to a .pt with "
                         "skyeye_tpu.cli.export --formats torch")
    else:
        module = create_detector(load_model_config(weights), num_classes=num_classes,
                                 dtype=dtype, device=device, seed=seed)
    return module


# -- training state ------------------------------------------------------------------


def save_train_checkpoint(path, state, epoch: int, best_fitness: float, config) -> Path:
    """``state`` (``train.TrainState``) to a ``.pt`` in ``save_model``'s layout.
    Its ``state_dict`` holds the weights that are served and validated, as JAX
    serves a training checkpoint's ``ema_params``: the EMA parameters with the
    model's BatchNorm statistics. Beside them: ``train_state_dict`` (the model's
    own parameters and statistics, which training resumes from),
    ``ema_updates``, ``optimizer``, ``step``, ``epoch``, ``best_fitness``.

    In a data-parallel run every rank calls it: an FSDP state's shards are
    gathered whole (a collective), and the main process alone writes the
    file, the same file a single-card run writes."""
    from ..parallel.fsdp import full_tensors
    from ..parallel.mesh import is_main_process
    from ..train.ema import ema_weights

    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")

    def cpu(sd):
        return {k: v.detach().cpu() for k, v in full_tensors(sd).items()}

    payload = {"layout": PORT_LAYOUT, "config": config.to_dict(),
               "state_dict": cpu(ema_weights(state.ema, state.model)),
               "train_state_dict": cpu(state.model.state_dict()),
               "ema_updates": int(state.ema.updates), "optimizer": state.opt.state_dict(),
               "step": int(state.step), "epoch": int(epoch),
               "best_fitness": float(best_fitness)}
    if is_main_process():
        torch.save(payload, tmp)
        tmp.replace(path)
    return path


def restore_train_state(state, ckpt: Mapping[str, Any]) -> None:
    """Put a checkpoint's (or ``from_jax_train_state``'s) fields into ``state``:
    the model from ``train_state_dict``, EMA from the parameters of
    ``state_dict`` (a file without ``train_state_dict``, as ``save_model``
    writes, starts both from ``state_dict``), step, and the optimizer state
    where it fits the optimizer (else it is logged and the momenta start from
    zero, as JAX does)."""
    device = next(state.model.parameters()).device
    served = ckpt["state_dict"]
    sd = ckpt.get("train_state_dict") or served
    own = state.model.state_dict()
    state.model.load_state_dict({k: sd[k] if k in sd else own[k] for k in own}, strict=True)
    for k, t in state.ema.params.items():
        t.copy_(served[k].to(device))
    state.ema.updates = int(ckpt.get("ema_updates", 0))
    state.step = int(ckpt.get("step", 0))
    if ckpt.get("optimizer"):
        try:
            state.opt.load_state_dict(ckpt["optimizer"])
        except (ValueError, KeyError) as e:
            LOGGER.warning("could not restore optimizer state (%s); momenta restart from zero", e)


def _nodes(node):
    """Every node of a tree of NamedTuples, dicts, lists and tuples (an optax
    state, read without optax), depth first."""
    yield node
    if hasattr(node, "_fields"):
        children = [getattr(node, f) for f in node._fields]
    elif isinstance(node, dict):
        children = list(node.values())
    elif isinstance(node, (list, tuple)):
        children = list(node)
    else:
        children = []
    for child in children:
        yield from _nodes(child)


def _fields(node, name: str):
    """The values of every NamedTuple field ``name`` in the tree."""
    return [getattr(n, name) for n in _nodes(node)
            if hasattr(n, "_fields") and name in n._fields]


def _flat_arrays(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays -> {"a/b/c": array}; leaves that are not arrays
    (optax's ``MaskedNode`` for another group's parameters) are skipped."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat_arrays(v, path))
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            out[path] = np.asarray(v)
    return out


def _as_port_params(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return from_jax_variables({f"params/{k}": v for k, v in flat.items()})


def from_jax_train_state(jax_state, accumulate: int = 1) -> Dict[str, Any]:
    """JAX's ``TrainState`` after ``jax.device_get`` (numpy leaves) -> the fields
    ``restore_train_state`` reads. Each optimizer group's trace (or Adam's
    mu and nu) is one tree with the other group's leaves masked out: they are
    merged. ``accumulate`` is ``MultiSteps``'s k (static in JAX)."""
    flat_vars = {f"params/{k}": v for k, v in _flat_arrays(jax_state.params).items()}
    flat_vars.update({f"batch_stats/{k}": v
                      for k, v in _flat_arrays(jax_state.batch_stats).items()})
    opt = jax_state.opt_state
    out_opt: Dict[str, Any] = {"accumulate": accumulate}
    hyper = _fields(opt, "hyperparams")
    if hyper:
        out_opt["hyperparams"] = {k: float(np.asarray(v)) for k, v in hyper[0].items()}
    mus = _fields(opt, "mu")
    if mus:
        out_opt["adam"] = True
        for name in ("mu", "nu"):
            merged = {}
            for tree in _fields(opt, name):
                merged.update(_flat_arrays(tree))
            out_opt[name] = _as_port_params(merged)
        # Adam's own count (optimizer steps), not inject_hyperparams' (micro-steps)
        adam = next(n for n in _nodes(opt) if hasattr(n, "_fields") and "nu" in n._fields)
        out_opt["count"] = int(np.asarray(adam.count))
    else:
        out_opt["adam"] = False
        merged = {}
        for tree in _fields(opt, "trace"):
            merged.update(_flat_arrays(tree))
        out_opt["trace"] = _as_port_params(merged)
    acc = _fields(opt, "acc_grads")
    if acc:
        out_opt["acc_grads"] = _as_port_params(_flat_arrays(acc[0]))
        out_opt["mini_step"] = int(np.asarray(_fields(opt, "mini_step")[0]))
        out_opt["gradient_step"] = int(np.asarray(_fields(opt, "gradient_step")[0]))
    ema_vars = {f"params/{k}": v for k, v in _flat_arrays(jax_state.ema.params).items()}
    ema_vars.update({k: v for k, v in flat_vars.items() if k.startswith("batch_stats/")})
    return {"state_dict": from_jax_variables(ema_vars),
            "train_state_dict": from_jax_variables(flat_vars),
            "ema_updates": int(np.asarray(jax_state.ema.updates)),
            "step": int(np.asarray(jax_state.step)), "optimizer": out_opt}
