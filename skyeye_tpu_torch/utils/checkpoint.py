"""Weight bridge: flax variables (as numpy) -> the port's ``state_dict``.

The port's module names follow the flax module names, so each flax path maps
to one ``state_dict`` key: conv kernels go from HWIO to OIHW, dense kernels
from (in, out) to (out, in), and BatchNorm ``scale``/``bias``/``mean``/``var``
to ``weight``/``bias``/``running_mean``/``running_var``. The caller flattens
the flax variables to numpy arrays; nothing here imports flax.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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
        elif leaf in _LEAVES:
            name = _LEAVES[leaf]
            if leaf == "mean":
                state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        else:
            raise KeyError(f"{path}: no state_dict counterpart for leaf {leaf!r}")
        state[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
