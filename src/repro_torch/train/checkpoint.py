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

A sharded state (every rank's blocks, with its placements `shardings`, a
tree of `sharding.NamedSharding` of the state's structure) is saved as
full, unsharded leaves, the reference's format, so a checkpoint crosses
packages and meshes: `save(..., shardings=)` gathers every leaf (a
collective of the mesh's ranks) and the mesh's rank 0 writes.
`restore(..., shardings=)` re-places every leaf: each rank keeps its block
under the placement, on its `like` leaf's device and in its dtype (the
elastic path).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import persist
from repro_torch.distributed.sharding import (gather_full, is_sharding,
                                              local_shard, spec_map)


def _host_copy(tree: Any) -> Any:
    """`tree` with every tensor copied to the host (bf16 stays bf16)."""
    _, leaves, treedef = persist.flatten_with_paths(tree)
    return persist.unflatten(treedef, [
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
        else np.array(x) for x in leaves])


def _mesh_of(shardings):
    found = []
    spec_map(lambda sh: found.append(sh.mesh), shardings, is_leaf=is_sharding)
    return found[0]


def save(ckpt_dir: str | Path, step: int, tree: Any, *,
         async_write: bool = False, shardings: Any = None):
    """Write a checkpoint; the LATEST pointer flips only after fsync.  The
    leaves are copied to the host before this returns (the caller updates
    the live tree in place right after); with `async_write` the write runs
    on a thread, which is returned.  With `shardings` every rank of the
    mesh calls this: the leaves are gathered whole and the mesh's rank 0
    writes them (the others return None once it has, unless
    `async_write`)."""
    ckpt_dir = Path(ckpt_dir)
    if shardings is not None:
        mesh = _mesh_of(shardings)
        tree = spec_map(lambda sh, x: gather_full(x, sh.mesh, sh.spec),
                        shardings, tree, is_leaf=is_sharding)
        if mesh.rank != 0:
            if not async_write:
                torch.distributed.barrier()
            return None
        if not async_write:
            persist.save_tree(ckpt_dir, step, _host_copy(tree))
            torch.distributed.barrier()
            return None
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
    path), a numpy leaf in its dtype.  With `shardings` (a placement a
    leaf) each rank keeps its block of every leaf; `like`'s leaves may be
    blocks of any shape."""
    if shardings is None:
        tree, _manifest = persist.load_tree(ckpt_dir, like, step)
        return tree
    # whole leaves land on the host; each rank moves its block across
    host_like = spec_map(
        lambda x: torch.empty(0, dtype=x.dtype) if isinstance(
            x, torch.Tensor) else x, like,
        is_leaf=lambda x: not isinstance(x, (dict, tuple, list)))
    full, _manifest = persist.load_tree(ckpt_dir, host_like, step)
    return spec_map(
        lambda sh, x, lk: local_shard(x, sh.mesh, sh.spec).to(
            device=lk.device, copy=True), shardings, full, like,
        is_leaf=is_sharding)
