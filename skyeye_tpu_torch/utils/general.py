"""Small helpers shared by the port: device resolution, image-size rounding,
run directories, the dataset description, and the training run's seeding,
resume lookup, class weights and argument log."""
from __future__ import annotations

import glob
import logging
import math
import os
import random
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..config import DataConfig

LOGGER = logging.getLogger("skyeye_tpu_torch")


def _main_process() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def set_logging(verbose: bool = True) -> logging.Logger:
    """The port's logger at INFO on the main process and at WARNING on the
    others (JAX's ``set_logging``); ``parallel.initialize_distributed`` calls it
    once the process knows its rank."""
    LOGGER.setLevel(logging.INFO if verbose and _main_process() else logging.WARNING)
    return LOGGER


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device the caller asked for; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def make_divisible(x: float, divisor: int) -> int:
    """Smallest multiple of ``divisor`` that is >= x."""
    return math.ceil(x / divisor) * divisor


def check_img_size(imgsz, s: int = 32):
    """Round an image size (or each of a list of sizes) up to a multiple of the stride."""
    new = (make_divisible(imgsz, int(s)) if isinstance(imgsz, int)
           else [make_divisible(x, int(s)) for x in imgsz])
    if new != imgsz:
        LOGGER.warning("img size %s must be a multiple of %d, using %s", imgsz, s, new)
    return new


def increment_path(path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, exp3, ... (``skyeye_tpu.utils.general.increment_path``)."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def check_file(file) -> str:
    """A path as given when it is a file, else the first file of that name under
    the repository's ``configs/`` (``skyeye_tpu.utils.general.check_file``; no
    download)."""
    file = str(file)
    if not file or Path(file).is_file():
        return file
    hits = sorted((Path(__file__).resolve().parents[2] / "configs").rglob(Path(file).name))
    if hits:
        return str(hits[0])
    raise FileNotFoundError(f"file not found: {file}")


def check_dataset(data):
    """A ``DataConfig`` from a ``DataConfig``, a dict of the data-YAML schema or a
    YAML path, its split paths resolved; a split that is not there is logged."""
    if isinstance(data, DataConfig):
        cfg = data
    elif isinstance(data, dict):
        cfg = DataConfig.from_dict(data)
    else:
        cfg = DataConfig.from_yaml(check_file(data))
    for split in ("train", "val"):
        p = getattr(cfg, split)
        if p and not Path(p).exists():
            LOGGER.warning("dataset split %s not found at %s", split, p)
    return cfg


def init_seeds(seed: int = 0) -> None:
    """Seed Python's and numpy's global generators, as JAX's ``init_seeds`` does.
    The port's own draws go through explicit generators made from ``seed``."""
    random.seed(seed)
    np.random.seed(seed)


def get_latest_run(search_dir: str = ".") -> str:
    """The most recent ``last*`` checkpoint under search_dir (for resume)."""
    paths = glob.glob(f"{search_dir}/**/last*", recursive=True)
    return max(paths, key=os.path.getctime) if paths else ""


def labels_to_class_weights(labels: Sequence[np.ndarray], nc: int = 80) -> np.ndarray:
    """Inverse-frequency class weights from dataset labels (YOLOv5 convention)."""
    if not len(labels):
        return np.ones(nc) / nc
    classes = np.concatenate([l[:, 0] for l in labels if len(l)], 0).astype(int) \
        if any(len(l) for l in labels) else np.zeros(0, int)
    counts = np.bincount(classes, minlength=nc).astype(float)
    counts[counts == 0] = 1
    weights = 1.0 / counts
    return weights / weights.sum()


def print_args(args: Optional[Dict] = None, show_file: bool = True) -> None:
    """Log the arguments, on the main process only."""
    if _main_process():
        LOGGER.info(", ".join(f"{k}={v}" for k, v in (args or {}).items()))
