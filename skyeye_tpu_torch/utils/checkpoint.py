"""Weight bridge: flax variables (as numpy) -> the port's ``state_dict``.

The port's module names follow the flax module names, so each flax path maps
to one ``state_dict`` key: conv kernels go from HWIO to OIHW, dense kernels
from (in, out) to (out, in), and BatchNorm ``scale``/``bias``/``mean``/``var``
to ``weight``/``bias``/``running_mean``/``running_var``, LayerNorm
``scale``/``bias`` likewise; the flat leaves of ``FusedCSPBlock`` (``w_cv1``,
..., ``b_cv3``) keep their JAX layout. The caller flattens the flax variables
to numpy arrays; nothing here imports flax.

``fuse_conv_bn`` folds BatchNorm into the preceding conv, on the port's own
``state_dict``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..ops.csp_kernel import WEIGHT_NAMES as _FLAT_LEAVES

_COLLECTIONS = ("params", "batch_stats")
_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


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
        arr = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            if arr.ndim == 4:  # conv: (kh, kw, in, out) -> (out, in, kh, kw)
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # dense: (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"{path}: kernel of rank {arr.ndim}")
            name = "weight"
        elif leaf in _FLAT_LEAVES:
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
