"""Atomic single-file writes (tmp + fsync + rename), in numpy.

Counterpart of the single-file part of src/repro/core/persist.py
(:51-123): content lands in a temp file in the destination's directory, is
fsynced and renamed over the destination, so a crash leaves either the old
file or the complete new one, never a truncated mix.  `save_trace` writes
through `atomic_savez`, the metrics registry and the tracer's export
through `atomic_write_json`.  The reference's manifest-directory snapshots
are not ported yet.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np


def fsync_dir(path: Path | str) -> None:
    """Durably record a directory entry (the rename itself)."""
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


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


def atomic_write_json(path: Path | str, obj: Any, *, fsync: bool = True,
                      indent: Optional[int] = None) -> Path:
    """`obj` as JSON text plus a newline, written atomically."""
    text = json.dumps(obj, indent=indent) + "\n"
    return atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


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
