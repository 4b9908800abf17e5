"""Prefetching host loader.

Counterpart of src/repro/data/loader.py (`ShardedLoader`): a background
thread makes the batches of consecutive steps and keeps up to `depth` of
them in a bounded queue, so host data work overlaps device steps.  Where
the reference `device_put`s each batch with its sharding, the port moves
each array to `device` from pinned host memory without blocking the
thread (`non_blocking`, on the current stream, so the step that takes the
batch runs after its copy).  With no `device`, the batches stay numpy, as
the reference's do with no sharding.  With `sharding` (a placement, or
a dict of them by key: `sharding.NamedSharding`, e.g. from
`train.steps.batch_spec_tree`), each rank keeps its block of the global
batch, which every rank makes from the same seed (`make_batch(step)`), on
the mesh's device: the loader and the loop stay in step on every rank.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, local_shard


def place(batch: dict, sharding) -> dict:
    """This rank's block of every array of a global batch under `sharding`
    (one placement, or a dict of them by key), on the mesh's device."""
    out = {}
    for k, x in batch.items():
        sh = sharding if isinstance(sharding, NamedSharding) else sharding[k]
        block = local_shard(torch.from_numpy(np.ascontiguousarray(x)),
                            sh.mesh, sh.spec)
        out[k] = to_device({k: block.numpy()}, sh.mesh.device)[k]
    return out


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
        sharding=None,
    ):
        self._make = make_batch
        self._device = device
        self._sharding = sharding
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            if self._sharding is not None:
                batch = place(batch, self._sharding)
            elif self._device is not None:
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
