"""Prefetching host loader.

Counterpart of src/repro/data/loader.py (`ShardedLoader`): a background
thread makes the batches of consecutive steps and keeps up to `depth` of
them in a bounded queue, so host data work overlaps device steps.  Where
the reference `device_put`s each batch with its sharding, the port moves
each array to `device` from pinned host memory without blocking the
thread (`non_blocking`, on the current stream, so the step that takes the
batch runs after its copy).  With no `device`, the batches stay numpy, as
the reference's do with no sharding.  A sharded placement waits for the
sharding slice (ROADMAP queue 1 item 8.5).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on `device` (from pinned memory,
    without blocking, when it is the card)."""
    dev = torch.device(device)
    out = {}
    for k, x in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(x))
        out[k] = (t.pin_memory().to(dev, non_blocking=True)
                  if dev.type == "cuda" else t.to(dev))
    return out


class ShardedLoader:
    def __init__(
        self,
        make_batch: Callable[[int], dict],
        device: Optional[torch.device | str] = None,
        depth: int = 2,
        start_step: int = 0,
    ):
        self._make = make_batch
        self._device = device
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            if self._device is not None:
                batch = to_device(batch, self._device)
            try:
                self._q.put((step, batch), timeout=1.0)
            except queue.Full:
                if self._stop.is_set():
                    return
                continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
