"""Device prefetch: host batches copied to the device ahead of the compute.

Port of ``skyeye_tpu/data/prefetch.py::device_prefetch``, rebuilt for CUDA.
A background thread takes batches from the loader (host work: decode,
letterbox, padding) and, on a CUDA device, copies each batch into the next of
a ring of pinned host buffers and from there to the device on a copy stream of
its own. The consumer's stream waits on the copy's event before the batch is
handed over, so compute never reads a tensor still in flight; a pinned buffer
is refilled only after the copy out of it has completed (its event), so a copy
never reads a buffer being refilled. On the CPU the arrays become tensors and nothing is copied.
``device="cuda"`` means the caller's current card (a data-parallel worker's
own): the producer thread, whose current card is the first, copies to it on
a copy stream of that card.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


class _PinnedRing:
    """``size`` flat byte buffers of pinned host memory, taken in turn, each with
    the event of the last copy out of it. A buffer holds one whole batch; it
    grows, to the largest batch seen so far, only when a batch does not fit, so
    the ring holds at most ``size`` times the largest batch whatever the number
    of batch shapes."""

    ALIGN = 64  # bytes: every array's view starts aligned for its dtype

    def __init__(self, size: int):
        self.size = size
        self.slots: List[List] = []  # [buffer, event of the last copy out of it]
        self.turn = 0
        self.largest = 0

    def take(self, arrays: Sequence[np.ndarray]) -> Tuple[List[torch.Tensor], List]:
        """Copy ``arrays`` into the next buffer; return their views there, of the
        arrays' shapes and dtypes, and the buffer's slot."""
        offsets, need = [], 0
        for arr in arrays:
            offsets.append(need)
            need += -(-arr.nbytes // self.ALIGN) * self.ALIGN
        self.largest = max(self.largest, need)
        if len(self.slots) < self.size:
            self.slots.append([torch.empty(0, dtype=torch.uint8), None])
        slot = self.slots[self.turn % len(self.slots)]
        self.turn += 1
        if slot[1] is not None:
            slot[1].synchronize()  # the copy out of this buffer is done
        if slot[0].numel() < need:
            # pinned wherever there is a card to copy to (the ring's only use)
            slot[0] = torch.empty(self.largest, dtype=torch.uint8,
                                  pin_memory=torch.cuda.is_available())
        views = []
        for arr, off in zip(arrays, offsets):
            flat = slot[0][off:off + arr.nbytes]
            flat.numpy()[...] = arr.reshape(-1).view(np.uint8)
            views.append(flat.view(torch.from_numpy(np.empty(0, arr.dtype)).dtype).view(arr.shape))
        return views, slot


def device_prefetch(iterator: Iterable, size: int = 2, device="cuda",
                    keys: Optional[Sequence[str]] = None,
                    timings: Optional[list] = None) -> Iterator:
    """Yield the loader's batch dicts with the arrays under ``keys`` (default:
    every numpy array) as tensors on ``device``, host assembly and copies running
    ``size`` batches ahead.

    ``timings``, where given, gets one entry a batch: on CUDA the copy's (start,
    end) events on the copy stream, whose ``elapsed_time`` is the transfer's
    device time; on the CPU the host seconds the conversion took.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:  # the current card is per thread: fix it here
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    stop = object()
    err: list = []
    # size batches queued, one held by the consumer, one being filled
    ring = _PinnedRing(size + 2) if cuda else None
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def to_device(batch):
        names = [k for k, v in batch.items() if isinstance(v, np.ndarray)
                 and (keys is None or k in keys)]
        out = dict(batch)
        if not cuda:
            t0 = time.perf_counter()
            for k in names:
                out[k] = torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            if timings is not None:
                timings.append(time.perf_counter() - t0)
            return out, None
        pinned, slot = ring.take([np.ascontiguousarray(batch[k]) for k in names])
        start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(copy_stream):
            start.record(copy_stream)
            for k, view in zip(names, pinned):
                out[k] = view.to(device, non_blocking=True)
            done.record(copy_stream)
        slot[1] = done
        if timings is not None:
            timings.append((start, done))
        return out, done

    def producer():
        try:
            for batch in iterator:
                q.put(to_device(batch))
        except Exception as e:  # raised again on the consumer's side
            err.append(e)
        finally:
            q.put(stop)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            if err:
                raise err[0]
            return
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for v in batch.values():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    v.record_stream(stream)  # allocated on the copy stream, used here
        yield batch
