"""Checkpoints with atomic manifests and async writes: a thin training layer
over `core/persist.py`.

Counterpart of src/repro/train/checkpoint.py (`save`, `latest_step`,
`restore`), in the reference's on-disk format, so each package restores
the other's checkpoints:

  <dir>/step_<N>/manifest.json   step, leaf index (key paths), dtypes,
                                 per-shard CRC32
  <dir>/step_<N>/shard_<i>.npz   the leaves, chunked by byte budget
  <dir>/LATEST                   atomic pointer to step_<N>

A training state is {"params": ..., "opt": OptState}; an int8 first
moment's (q, scale) pair is two leaves (``[0]``, ``[1]``) and a bf16 leaf
is stored as f32 with its dtype tag, as the reference stores them.
`restore(..., shardings=)`, the reference's elastic re-placement onto a
mesh, waits for the sharding slice (ROADMAP queue 1 item 8.5).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import persist


def _host_copy(tree: Any) -> Any:
    """`tree` with every tensor copied to the host (bf16 stays bf16)."""
    _, leaves, treedef = persist.flatten_with_paths(tree)
    return persist.unflatten(treedef, [
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
        else np.array(x) for x in leaves])


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         async_write: bool = False):
    """Write a checkpoint; the LATEST pointer flips only after fsync.  The
    leaves are copied to the host before this returns (the caller updates
    the live tree in place right after); with `async_write` the write runs
    on a thread, which is returned."""
    ckpt_dir = Path(ckpt_dir)
    host_tree = _host_copy(tree)

    def _write():
        persist.save_tree(ckpt_dir, step, host_tree)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    return persist.latest_step(ckpt_dir)


def restore(ckpt_dir: str | Path, like: Any, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of `like`: each tensor leaf comes back on
    its `like` leaf's device and in its dtype (the cast of the elastic
    path), a numpy leaf in its dtype."""
    if shardings is not None:
        raise NotImplementedError(
            "restore(shardings=): elastic re-placement onto a mesh waits for "
            "the sharding slice (ROADMAP queue 1 item 8.5)")
    tree, _manifest = persist.load_tree(ckpt_dir, like, step)
    return tree
