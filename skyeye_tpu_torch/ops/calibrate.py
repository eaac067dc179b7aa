"""Activation-range calibration for post-training int8 quantization.

Port of ``skyeye_tpu/ops/calibrate.py``. ``observe_ranges`` runs the detector
over calibration batches and records, for every submodule's output, its
largest magnitude and its 99.9th percentile of magnitudes. JAX captures each
flax module's ``__call__`` output by path; here a forward hook on each of
``named_modules()`` does, keyed by the module's name with ``.`` turned into
``/`` (``neck.fpn4.m2`` -> ``neck/fpn4/m2``, the flax path, since the port's
module names are flax's), and the root's output under ``""``. A tuple or list
output is keyed ``path``, ``path#1``, ``path#2``, ... as in
``_flatten_intermediates``. A module called twice in one forward is recorded at
its first call, as flax's ``v[0]``.

The percentile is numpy's, on the host, over the whole float32 tensor of a
batch (``torch.quantile`` refuses more than 2^24 elements); a path's range is
the maximum over batches. Activation scales come from these ranges, weight
scales from the folded kernels (``quantize_weight_per_channel``).
"""
from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Collection, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn


def _arrays(output) -> List[torch.Tensor]:
    items = output if isinstance(output, (tuple, list)) else [output]
    return [t for t in items if isinstance(t, torch.Tensor)]


def _abs_stats(t: np.ndarray, percentile: float) -> np.ndarray:
    a = np.abs(t)
    return np.array([a.max(), np.percentile(a, percentile)])


@torch.no_grad()
def observe_ranges(module: nn.Module, batches: Sequence, percentile: float = 99.9,
                   paths: Optional[Collection[str]] = None) -> Dict[str, Dict[str, float]]:
    """Run ``batches`` (NHWC arrays or tensors, as JAX's take them) through
    ``module`` (on its device, in eval mode) and return ``{path: {"absmax": float,
    "pctl": float}}`` for every module output, or for ``paths`` only: at a
    serving size every output is gigabytes a batch to copy and sort on the host,
    and a quantizer reads a few dozen (``calibration_paths``). The host's
    statistics run on a thread pool (numpy's partition releases the GIL) while
    the module goes on."""
    device = next(module.parameters()).device
    stats: Dict[str, List[Future]] = {}
    seen: set = set()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        def hook(path: str):
            def record(_mod, _args, output):
                if path in seen:
                    return
                seen.add(path)
                for i, t in enumerate(_arrays(output)):
                    key = path + (f"#{i}" if i else "")
                    host = t.detach().float().cpu().numpy()
                    stats.setdefault(key, []).append(pool.submit(_abs_stats, host, percentile))
            return record

        handles = [m.register_forward_hook(hook(name.replace(".", "/")))
                   for name, m in module.named_modules()
                   if paths is None or name.replace(".", "/") in paths]
        try:
            for batch in batches:
                seen.clear()
                x = torch.as_tensor(np.asarray(batch) if not isinstance(batch, torch.Tensor)
                                    else batch)
                module(x.to(device).permute(0, 3, 1, 2))
        finally:
            for h in handles:
                h.remove()
        arrays = {path: np.stack([f.result() for f in futures])
                  for path, futures in stats.items()}
    return {path: {"absmax": float(arr[:, 0].max()), "pctl": float(arr[:, 1].max())}
            for path, arr in arrays.items()}


def calibration_paths(key_map: Dict[str, object]) -> set:
    """The captured paths a ``_range_key_map`` reads (a path, None, or
    ``("max", path, path)``)."""
    out = set()
    for key in key_map.values():
        if isinstance(key, tuple):
            out.update(key[1:])
        elif key is not None:
            out.add(key)
    return out


def symmetric_scale(absmax: float, bits: int = 8) -> float:
    """Per-tensor symmetric quantization scale: x_q = round(x / scale)."""
    qmax = 2 ** (bits - 1) - 1
    return max(absmax, 1e-12) / qmax


def quantize_weight_per_channel(kernel: np.ndarray):
    """(kh, kw, cin, cout) f32 -> (int8 kernel, (cout,) f32 scales)."""
    k = np.asarray(kernel, np.float32)
    absmax = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0)
    scales = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(k / scales[None, None, None, :]), -127, 127)
    return q.astype(np.int8), scales.astype(np.float32)
