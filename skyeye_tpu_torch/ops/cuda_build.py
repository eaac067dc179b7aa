"""Build a CUDA source of the port with ``nvcc`` into a shared library, bound by ctypes.

The library has a plain C interface (no PyTorch headers), so a build takes
seconds. It goes into ``skyeye_tpu_torch/_build/`` at first use, named by a hash
of its source, every local file it includes (``#include "..."``, followed
through those files too) and its own flags, so a stale library is never
loaded and no source inherits a flag that another one needs. The build runs
under a time limit and raises on failure; nothing here falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


@dataclass
class Built:
    """A loaded library and what its build said."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when the library was already built
    ptxas: str      # nvcc's resource report (registers, shared memory, spills)


_LOCKS: Dict[str, threading.Lock] = {}  # one per library, so sources build in parallel
_LOCKS_GUARD = threading.Lock()


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under $CUDA_HOME/bin or /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin")


def source_files(path: Path) -> List[Path]:
    """``path`` and every local file it includes, directly or through another,
    each once, in the order first reached."""
    seen: List[Path] = []
    todo = [path.resolve()]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        for name in _LOCAL_INCLUDE.findall(f.read_bytes()):
            todo.append((f.parent / name.decode()).resolve())
    return seen


def library_key(path: Path, flags: Sequence[str]) -> str:
    """``<stem>-<hash>``: the hash of the flags and of the bytes of the source
    and of every local file it includes."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in source_files(path):
        digest.update(f.read_bytes())
    return f"{path.stem}-{digest.hexdigest()[:16]}"


def load_library(source: str, extra_flags: Sequence[str] = ()) -> Built:
    """Build ``csrc/<source>`` with ``NVCC_FLAGS`` plus ``extra_flags`` (once per
    hash of both, the source and what it includes) and load it."""
    path = CSRC_DIR / source
    flags = (*NVCC_FLAGS, *extra_flags)
    key = library_key(path, flags)
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        target = BUILD_DIR / f"lib{key}.so"
        seconds, ptxas = 0.0, ""
        if not target.exists():
            # build beside the target and rename, so no process loads a half-written file
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *flags, "-o", tmp, str(path)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=BUILD_TIMEOUT_S)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stderr}")
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            seconds = time.perf_counter() - t0
            ptxas = proc.stderr
        return Built(ctypes.CDLL(str(target)), target, seconds, ptxas)
