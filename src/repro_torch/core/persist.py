"""Atomic, crash-consistent persistence, in numpy and PyTorch.

Counterpart of src/repro/core/persist.py, whose docstring gives the three
rules every artifact follows:

  1. write new, never in place: content lands in a temp file or directory
     beside the destination, is fsynced and renamed over it, so a crash
     leaves either the old artifact or the new one;
  2. manifest last: a snapshot directory writes its payload shards, then a
     manifest carrying a CRC32 per shard, inside the temp directory; the
     rename publishes both, and the ``LATEST`` pointer flips only after
     the directory is durable;
  3. validate on load: `validate_step` re-checks manifest and shards and
     raises `SnapshotCorruptError`; `newest_valid_step` walks the steps
     newest first and skips the corrupt ones.

The on-disk format is the reference's (``shard_<i>.npz``, a
``manifest.json`` with ``leaves``, ``dtypes``, ``n_shards``, ``shard_crc``
and ``extra``), so each package validates the other's snapshot
directories.  The reference flattens with `jax.tree_util`; here
`flatten_with_paths` walks what a snapshot or a checkpoint holds (dicts,
`NamedTuple`s, dataclasses, plain tuples and lists such as an int8
optimizer moment's ``(q, scale)`` pair; tensors, numpy arrays and Python
scalars as leaves) and names each leaf with the reference's key-path
strings.  npz stores no bf16, so a bf16 leaf is written as f32 with the
dtype tag ``bfloat16`` in the manifest, as the reference writes it, and
read back into its `like` leaf's dtype.  `host_tree` reads every device
tensor of a tree back in one host read (counted in
`utils.hostsync.SYNCS`).  `save_trace` writes through `atomic_savez`, the
metrics registry and the tracer's export through `atomic_write_json`, the
serving tier's snapshots (`serve/durability.py`) through `save_tree`.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import tempfile
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import SnapshotCorruptError
from repro_torch.utils.hostsync import host_array

SHARD_BYTES = 1 << 30  # 1 GiB per npz shard


# ---------------------------------------------------------------------------
# single-file atomic writes
# ---------------------------------------------------------------------------


def fsync_file(path: Path | str) -> None:
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: Path | str) -> None:
    """Durably record a directory entry (the rename itself)."""
    fsync_file(path)


def atomic_write_bytes(path: Path | str, blob: bytes, *,
                       fsync: bool = True) -> Path:
    """tmp + fsync + os.replace: the destination is either the old content
    or the complete new content, never a truncated mix."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=f".{path.name}.", suffix=".tmp", dir=path.parent
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(path.parent)
    return path


def atomic_write_text(path: Path | str, text: str, *,
                      fsync: bool = True) -> Path:
    return atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def atomic_write_json(path: Path | str, obj: Any, *, fsync: bool = True,
                      indent: Optional[int] = None) -> Path:
    """`obj` as JSON text plus a newline, written atomically."""
    return atomic_write_text(path, json.dumps(obj, indent=indent) + "\n",
                             fsync=fsync)


def atomic_savez(path: Path | str, *, compressed: bool = False,
                 fsync: bool = True, **arrays: np.ndarray) -> Path:
    """Atomic `np.savez[_compressed]`; a missing ``.npz`` suffix is
    appended, as numpy does."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **arrays)
    return atomic_write_bytes(path, buf.getvalue(), fsync=fsync)


# ---------------------------------------------------------------------------
# trees: flatten with key paths, read to the host, rebuild
# ---------------------------------------------------------------------------

# A tree's structure: ("leaf",), ("dict", keys, children),
# ("namedtuple", type, children), ("dataclass", type, field names,
# children), ("tuple", children) or ("list", children).
TreeDef = Tuple


def flatten_with_paths(tree) -> Tuple[List[str], list, TreeDef]:
    """(paths, leaves, treedef) of a tree of dicts, `NamedTuple`s,
    dataclasses, tuples and lists.  Leaves come in `jax.tree_util`'s order
    (dict keys sorted, fields in declaration order, sequence items in
    order) and paths are its key-path strings joined by "/": ``['key']``
    for a dict entry, ``.name`` for a field, ``[i]`` for item i of a tuple
    or list."""
    paths: List[str] = []
    leaves: list = []

    def walk(x, prefix):
        def child(key, v):
            return walk(v, prefix + [key])

        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", keys, [child(f"[{k!r}]", x[k]) for k in keys])
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return ("namedtuple", type(x),
                    [child(f".{f}", getattr(x, f)) for f in x._fields])
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = [f.name for f in dataclasses.fields(x)]
            return ("dataclass", type(x), names,
                    [child(f".{n}", getattr(x, n)) for n in names])
        if isinstance(x, (tuple, list)):
            return (type(x).__name__,
                    [child(f"[{i}]", v) for i, v in enumerate(x)])
        paths.append("/".join(prefix))
        leaves.append(x)
        return ("leaf",)

    treedef = walk(tree, [])
    return paths, leaves, treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of `treedef` with `leaves` in flatten order."""
    it = iter(leaves)

    def build(td):
        kind = td[0]
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(td[1], td[2])}
        if kind == "namedtuple":
            return td[1](*[build(c) for c in td[2]])
        if kind in ("tuple", "list"):
            return {"tuple": tuple, "list": list}[kind](
                build(c) for c in td[1])
        return td[1](**{n: build(c) for n, c in zip(td[2], td[3])})

    return build(treedef)


def _storable(t: torch.Tensor) -> torch.Tensor:
    """`t` detached, a bf16 tensor widened (exactly) to f32."""
    t = t.detach()
    return t.float() if t.dtype == torch.bfloat16 else t


def _dtype_tag(x, arr: np.ndarray) -> str:
    """The manifest's dtype of a leaf: ``bfloat16`` for a bf16 tensor
    (stored as f32), else the stored array's."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _host_leaves(leaves) -> List[np.ndarray]:
    """Every leaf as a numpy array (a bf16 tensor as f32).  The tensors on
    a device come back in one host read: their bytes, concatenated on the
    device."""
    out: List[Any] = [None] * len(leaves)
    on_device = []
    for i, x in enumerate(leaves):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cpu":
                out[i] = _storable(x).numpy().copy()
            else:
                on_device.append(i)
        else:
            out[i] = np.asarray(x)
    if on_device:
        ts = [_storable(leaves[i]).contiguous() for i in on_device]
        blob = host_array(torch.cat([t.reshape(-1).view(torch.uint8)
                                     for t in ts]), "persist.host_tree")
        at = 0
        for i, t in zip(on_device, ts):
            n = t.numel() * t.element_size()
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            out[i] = blob[at:at + n].view(dtype).reshape(tuple(t.shape))
            at += n
    return out


def host_tree(tree) -> Any:
    """`tree` with numpy leaves, in one host read (`_host_leaves`)."""
    _, leaves, treedef = flatten_with_paths(tree)
    return unflatten(treedef, _host_leaves(leaves))


# ---------------------------------------------------------------------------
# manifest-directory snapshots
# ---------------------------------------------------------------------------


def step_dir(root: Path | str, step: int) -> Path:
    return Path(root) / f"step_{step}"


def save_tree(
    root: Path | str,
    step: int,
    tree: Any,
    *,
    extra: Optional[Dict[str, Any]] = None,
    fsync: bool = True,
) -> Path:
    """Write ``<root>/step_<step>/`` (shards + manifest) atomically and
    flip ``<root>/LATEST`` to it.  `extra` is a JSON-able dict stored in
    the manifest (the serving snapshot's host state).  The tree's device
    tensors are read in one host read."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    paths, leaves, _ = flatten_with_paths(tree)
    host = _host_leaves(leaves)
    dtypes = [_dtype_tag(x, arr) for x, arr in zip(leaves, host)]

    tmp = root / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    shards, cur, cur_bytes, idx = [], {}, 0, {}
    for name, arr in zip(paths, host):
        key = f"leaf_{len(cur)}"
        cur[key] = arr
        idx[name] = (len(shards), key)
        cur_bytes += arr.nbytes
        if cur_bytes >= SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    shards.append(cur)
    shard_crc = []
    for i, sh in enumerate(shards):
        p = tmp / f"shard_{i}.npz"
        np.savez(p, **sh)
        shard_crc.append(zlib.crc32(p.read_bytes()) & 0xFFFFFFFF)
        if fsync:
            fsync_file(p)
    manifest = {
        "step": step,
        "leaves": {n: list(v) for n, v in idx.items()},
        "dtypes": dict(zip(paths, dtypes)),
        "n_shards": len(shards),
        "shard_crc": shard_crc,
        "extra": extra if extra is not None else {},
        "time": time.time(),
    }
    mpath = tmp / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    if fsync:
        fsync_file(mpath)
    final = step_dir(root, step)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    if fsync:
        fsync_dir(root)
    atomic_write_text(root / "LATEST", final.name, fsync=fsync)
    return final


def latest_step(root: Path | str) -> Optional[int]:
    """The step the LATEST pointer names, without validating it."""
    p = Path(root) / "LATEST"
    if not p.exists():
        return None
    name = p.read_text().strip()
    try:
        return int(name.rsplit("_", 1)[1])
    except (IndexError, ValueError):
        return None


def available_steps(root: Path | str) -> List[int]:
    """All on-disk step numbers under root, newest first."""
    root = Path(root)
    if not root.exists():
        return []
    out = []
    for d in root.iterdir():
        if d.is_dir() and d.name.startswith("step_"):
            try:
                out.append(int(d.name.rsplit("_", 1)[1]))
            except ValueError:
                continue
    return sorted(out, reverse=True)


def validate_step(root: Path | str, step: int) -> Dict[str, Any]:
    """Check one snapshot directory end to end; return its manifest or
    raise `SnapshotCorruptError` (missing or unparseable manifest, missing
    shard, shard CRC mismatch, manifest naming shards that do not exist)."""
    d = step_dir(root, step)
    mpath = d / "manifest.json"
    if not mpath.exists():
        raise SnapshotCorruptError("manifest.json missing", path=str(d))
    try:
        manifest = json.loads(mpath.read_text())
    except (ValueError, OSError) as e:
        raise SnapshotCorruptError(
            f"unreadable manifest ({e})", path=str(d)
        ) from e
    n = manifest.get("n_shards")
    crcs = manifest.get("shard_crc")
    if not isinstance(n, int) or n < 1:
        raise SnapshotCorruptError("manifest lacks n_shards", path=str(d))
    for i in range(n):
        p = d / f"shard_{i}.npz"
        if not p.exists():
            raise SnapshotCorruptError(
                f"shard_{i}.npz missing", path=str(d)
            )
        if crcs is not None:
            got = zlib.crc32(p.read_bytes()) & 0xFFFFFFFF
            if got != crcs[i]:
                raise SnapshotCorruptError(
                    f"shard_{i}.npz CRC mismatch "
                    f"(manifest {crcs[i]:#x}, file {got:#x})",
                    path=str(d),
                )
    for name, (shard_i, _key) in manifest.get("leaves", {}).items():
        if not isinstance(shard_i, int) or shard_i >= n:
            raise SnapshotCorruptError(
                f"stale manifest: leaf {name!r} names shard {shard_i} "
                f"of {n}", path=str(d),
            )
    return manifest


def newest_valid_step(root: Path | str) -> Optional[int]:
    """Newest step that validates: the LATEST pointer's first, then every
    on-disk step newest first, skipping corrupt ones (a LATEST naming a
    step not on disk falls through to the scan).  None when no valid
    snapshot exists."""
    candidates = available_steps(root)
    pointed = latest_step(root)
    if pointed is not None and pointed in candidates:
        candidates.remove(pointed)
        candidates.insert(0, pointed)
    for step in candidates:
        try:
            validate_step(root, step)
            return step
        except SnapshotCorruptError:
            continue
    return None


def load_tree(root: Path | str, like: Any,
              step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
    """Validate a snapshot (the LATEST one when `step` is None) and load it
    into the structure of `like`; returns ``(tree, manifest)``.  A tensor
    leaf comes back on its `like` leaf's device and in its dtype (a
    `torch.Generator` state is a CPU uint8 tensor, for a CUDA generator
    too, so it comes back there, as `set_state` takes it); anything else
    as a numpy array in its `like` leaf's dtype."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {root}")
    manifest = validate_step(root, step)
    d = step_dir(root, step)
    shard_cache: Dict[int, Any] = {}

    paths, leaves, treedef = flatten_with_paths(like)
    out = []
    for name, leaf in zip(paths, leaves):
        if name not in manifest["leaves"]:
            raise SnapshotCorruptError(
                f"manifest lacks leaf {name!r}", path=str(d)
            )
        shard_i, key = manifest["leaves"][name]
        if shard_i not in shard_cache:
            try:
                shard_cache[shard_i] = np.load(d / f"shard_{shard_i}.npz")
            except Exception as e:
                raise SnapshotCorruptError(
                    f"unreadable shard_{shard_i}.npz "
                    f"({type(e).__name__}: {e})", path=str(d),
                ) from e
        arr = shard_cache[shard_i][key]
        if isinstance(leaf, torch.Tensor):
            arr = torch.as_tensor(np.array(arr, order="C")).to(
                device=leaf.device, dtype=leaf.dtype)
        elif getattr(leaf, "dtype", None) is not None:
            arr = arr.astype(leaf.dtype)
        out.append(arr)
    return unflatten(treedef, out), manifest


def prune_steps(root: Path | str, keep: int) -> int:
    """Delete all but the newest `keep` snapshot dirs; returns the number
    removed.  Never removes the step LATEST points at."""
    steps = available_steps(root)
    pointed = latest_step(root)
    removed = 0
    for step in steps[max(keep, 1):]:
        if step == pointed:
            continue
        shutil.rmtree(step_dir(root, step), ignore_errors=True)
        removed += 1
    return removed


__all__ = [
    "SHARD_BYTES",
    "fsync_file", "fsync_dir",
    "atomic_write_bytes", "atomic_write_text", "atomic_write_json",
    "atomic_savez",
    "flatten_with_paths", "unflatten", "host_tree",
    "step_dir", "save_tree", "load_tree",
    "latest_step", "available_steps", "newest_valid_step",
    "validate_step", "prune_steps",
]
