"""Profiling: device-synchronised timing, per-module benchmarks, model summaries.

Port of ``skyeye_tpu/utils/profiling.py``:

  time_sync   wall time after the card's queued work is done
  bench_fn    median seconds a call, synchronised with CUDA
  flops_of    ``torch.utils.flop_counter.FlopCounterMode``: the FLOPs of the
              convolutions and matrix products (2 a multiply-add), what JAX's
              ``flops_by_trace`` counts from the jaxpr. JAX's ``flops_of`` is
              XLA's cost analysis, which counts elementwise work too; the port
              has no counterpart of it (a recorded departure). K4 is a ctypes
              call that the counter cannot see inside: its custom op carries
              its own count (``ops/attention_kernel.py``)
  profile     params / GFLOPs / ms of callables or modules over inputs
  model_info  parameter tensors, parameters and GFLOPs at an image size
  scale_img   ratio-resize (``models.attention.bilinear_resize``, JAX's
              antialiased bilinear) and pad of an NHWC batch
  copy_attr, trace (``torch.profiler``, a Chrome trace), select_device
"""
from __future__ import annotations

import math
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .general import LOGGER, resolve_device


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_sync() -> float:
    """Wall time after all queued work on the card completes."""
    _sync()
    return time.time()


def bench_fn(fn: Callable, *args, n: int = 10, warmup: int = 2) -> float:
    """Median seconds a call of ``fn(*args)``, synchronised."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def flops_of(fn: Callable, *args) -> Optional[float]:
    """Convolution and matrix-product FLOPs of one ``fn(*args)`` (None if 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops()) or None


def _param_tensors(module: nn.Module):
    """What flax keeps under ``params``: the parameters, and the buffers that are
    not BatchNorm statistics (the int8 modules' leaves)."""
    bn_stats = ("running_mean", "running_var", "num_batches_tracked")
    return [t for _, t in module.named_parameters()] + [
        t for name, t in module.named_buffers() if name.rsplit(".", 1)[-1] not in bn_stats]


def count_params(module: nn.Module) -> int:
    return sum(t.numel() for t in _param_tensors(module))


def profile(inputs, ops: Sequence, n: int = 10, device=None) -> list:
    """Micro-benchmark ops (callables or modules) over inputs (moved to ``device``
    where given): params, GFLOPs and ms a call of each (the reference's
    ``profile``)."""
    results = []
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    LOGGER.info(f"{'Params':>12}{'GFLOPs':>10}{'fwd (ms)':>10}  op")
    for x in inputs:
        x = torch.as_tensor(x) if device is None else torch.as_tensor(x).to(device)
        for op in ops:
            n_p = count_params(op) if isinstance(op, nn.Module) else 0
            name = type(op).__name__ if isinstance(op, nn.Module) else getattr(op, "__name__", str(op))
            with torch.no_grad():
                dt = bench_fn(op, x, n=n) * 1000
            gf = flops_of(op, x)
            gf_s = f"{gf / 1e9:.2f}" if gf else "-"
            LOGGER.info(f"{n_p:>12}{gf_s:>10}{dt:>10.2f}  {name}")
            results.append({"name": name, "params": n_p, "gflops": gf, "ms": dt})
    return results


def model_info(module: nn.Module, img_size: int = 640, verbose: bool = False) -> Dict:
    """Model summary: parameter tensors (flax's ``params`` leaves), parameters and
    GFLOPs of one (1, 3, img_size, img_size) frame on the module's device."""
    tensors = _param_tensors(module)
    n_p = sum(t.numel() for t in tensors)
    device = next(module.parameters()).device
    x = torch.zeros((1, 3, img_size, img_size), device=device)
    gflops = flops_of(module, x)
    info = {"layers": len(tensors), "parameters": n_p,
            "gflops": (gflops / 1e9) if gflops else None, "img_size": img_size}
    gf = f"{info['gflops']:.1f}" if info["gflops"] else "?"
    LOGGER.info("Model summary: %d param tensors, %s parameters, %s GFLOPs at %dpx",
                len(tensors), f"{n_p:,}", gf, img_size)
    if verbose:
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            LOGGER.info("%60s %20s", name, tuple(t.shape))
    return info


def scale_img(img: torch.Tensor, ratio: float = 1.0, same_shape: bool = False,
              gs: int = 32) -> torch.Tensor:
    """Ratio-scale an NHWC float batch, padding to gs multiples with gray 0.447."""
    from ..models.attention import bilinear_resize

    if ratio == 1.0:
        return img
    b, h, w, c = img.shape
    new_h, new_w = int(h * ratio), int(w * ratio)
    img = bilinear_resize(img.permute(0, 3, 1, 2), new_h, new_w).permute(0, 2, 3, 1)
    if not same_shape:
        h_out, w_out = int(math.ceil(h * ratio / gs) * gs), int(math.ceil(w * ratio / gs) * gs)
    else:
        h_out, w_out = h, w
    pad_h, pad_w = max(h_out - new_h, 0), max(w_out - new_w, 0)
    img = F.pad(img, (0, 0, 0, pad_w, 0, pad_h), value=0.447)
    return img[:, :h_out, :w_out]


def copy_attr(a, b, include=(), exclude=()):
    """Copy attributes from b to a (the reference's ``copy_attr``)."""
    for k, v in b.__dict__.items():
        if (include and k not in include) or k.startswith("_") or k in exclude:
            continue
        setattr(a, k, v)


@contextmanager
def trace(log_dir: Union[str, Path] = "runs/trace"):
    """Capture a ``torch.profiler`` trace (host and, where there is a card, CUDA
    activity) of the block; written as a Chrome trace under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch_profile(activities=activities) as prof:
        yield log_dir
    out = log_dir / "trace.json"
    prof.export_chrome_trace(str(out))
    LOGGER.info("profiler trace written to %s", out)


def select_device(device: str = "") -> torch.device:
    """Device by string: '' (the card), 'cpu', 'cuda', 'cuda:N' (the reference's
    ``select_device``; JAX's takes 'tpu' for the card). Asking for a card where
    there is none raises."""
    return resolve_device(device or "cuda")
