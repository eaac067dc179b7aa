"""Multi-process launch: one worker process per card.

JAX drives every device from one controller and needs no launcher; the port
runs one process per card. ``launch(fn, n)`` starts ``n`` workers (spawned,
so CUDA starts clean in each), joined in one process group over a free
localhost port: NCCL for CUDA, gloo on the CPU, or the ``backend`` the
caller names. Worker ``r`` runs ``fn(*args, **kwargs)`` on its device
(``cuda:r`` modulo the visible cards, or the CPU) and its return value comes
back to the caller in rank order.

A worker that raises makes the whole run fail: the others are stopped and
``launch`` raises ``WorkerFailed`` carrying the worker's rank, exit code and
traceback. A mesh with a spatial axis takes n_data x n_spatial workers
(``create_mesh(n_data, n_spatial)`` in them). Under ``torchrun``
(``WORLD_SIZE`` in the environment) there is
nothing to start: ``fn`` runs in this process after
``initialize_distributed`` joined torchrun's group.
"""
from __future__ import annotations

import faulthandler
import os
import pickle
import socket
import tempfile
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from .mesh import DEFAULT_TIMEOUT_S, initialize_distributed


class WorkerFailed(RuntimeError):
    """A launched worker raised or died; ``rank``, ``exitcode`` and the
    worker's ``traceback`` (text) say which and why."""

    def __init__(self, rank: int, exitcode: Optional[int], tb: str):
        super().__init__(f"worker {rank} failed (exit code {exitcode}):\n{tb}")
        self.rank, self.exitcode, self.traceback = rank, exitcode, tb


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def under_torchrun() -> bool:
    return int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ


def worker_device(rank: int, backend: str) -> torch.device:
    """Where worker ``rank`` computes: its card for NCCL; for gloo the card when
    CUDA is available (two gloo workers may share one card), else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        raise RuntimeError("the NCCL backend needs CUDA")
    return torch.device("cpu")


def _worker(rank: int, world: int, port: int, backend: str, timeout_s: float,
            out_dir: str, fn: Callable, args, kwargs, device_kind: Optional[str]):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    result_file = Path(out_dir) / f"rank{rank}.pkl"
    faulthandler.enable()  # a worker that crashes in native code still names its line
    try:
        if device_kind == "cpu":
            device = torch.device("cpu")
        else:
            device = worker_device(rank, backend)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        initialize_distributed(f"localhost:{port}", num_processes=world, process_id=rank,
                               backend=backend, timeout_s=timeout_s)
        try:
            value = fn(*args, **kwargs)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with open(result_file, "wb") as f:
            pickle.dump(("ok", value), f)
    except BaseException:
        with open(result_file, "wb") as f:
            pickle.dump(("error", traceback.format_exc()), f)
        raise


def launch(fn: Callable, nprocs: int, args=(), kwargs=None, backend: Optional[str] = None,
           device: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` in ``nprocs`` worker processes, one process
    group over a free localhost port; returns the workers' return values in
    rank order. ``fn`` must be importable (a module-level function).
    ``device="cpu"`` keeps the workers on the CPU where CUDA is available
    (with gloo). Under torchrun, joins its group and returns ``[fn(...)]``."""
    kwargs = dict(kwargs or {})
    if under_torchrun():
        initialize_distributed(backend=backend, timeout_s=timeout_s)
        return [fn(*args, **kwargs)]
    backend = backend or ("nccl" if torch.cuda.is_available() and device != "cpu" else "gloo")
    with tempfile.TemporaryDirectory(prefix="skyeye_launch_") as out_dir:
        ctx = mp.start_processes(
            _worker, args=(nprocs, free_port(), backend, timeout_s, out_dir, fn, args, kwargs,
                           device),
            nprocs=nprocs, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except ProcessException as e:
            tb = _read(Path(out_dir) / f"rank{e.error_index}.pkl")
            raise WorkerFailed(e.error_index, getattr(e, "exit_code", None),
                               tb if isinstance(tb, str) else str(e)) from None
        results = []
        for r in range(nprocs):
            status, value = _read(Path(out_dir) / f"rank{r}.pkl", whole=True)
            if status != "ok":
                raise WorkerFailed(r, None, value)
            results.append(value)
        return results


def _read(path: Path, whole: bool = False):
    try:
        with open(path, "rb") as f:
            status, value = pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        return ("error", "the worker left no result (killed?)") if whole else None
    return (status, value) if whole else value
