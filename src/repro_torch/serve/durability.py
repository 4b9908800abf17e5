"""Write-ahead admission log and crash-consistent snapshots for the
serving tier, in numpy and PyTorch.

Counterpart of src/repro/serve/durability.py, whose docstring gives the
design:

  WAL        every window's arrivals are appended to a CRC-framed
             write-ahead log and fsynced before the window executes; a
             commit record (fsynced) marks the window done.  Sheds and
             evictions are logged too (informational: replay re-derives
             them).  A torn tail (a crash mid-append) is detected by the
             frame CRC and truncated away on recovery.
  SNAPSHOT   every `snapshot_interval` windows the whole scheduler and
             engine state (the carry, the draw cursor and generator state,
             backlogs, in-flight maps, overload controller, stats, step
             clocks) is written through `core.persist.save_tree`, the host
             state in the manifest's `extra` with the carry's
             `carry_fingerprint` stamped in.
  RECOVERY   load the newest snapshot that validates (damaged ones are
             skipped with accounting), then replay the WAL's window suffix
             through the engine's ordinary window path.

Framing: each record is ``<u32 len><u32 crc32(payload)><payload>``
(little-endian, payload = compact JSON with the reference's separators,
so both packages write the same bytes for the same records).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import persist
from repro_torch.core.errors import SnapshotCorruptError
from repro_torch.serve.scheduler import Request

_FRAME = struct.Struct("<II")  # payload length, payload crc32
_MAX_RECORD = 1 << 28  # sanity bound: a "length" beyond this is corruption


def request_to_dict(r: Request) -> Dict[str, int]:
    return dataclasses.asdict(r)


def request_from_dict(d: Dict[str, int]) -> Request:
    return Request(**{k: int(v) for k, v in d.items()})


@dataclasses.dataclass
class DurabilityConfig:
    """Knobs for the WAL + snapshot layer.

    ``fsync=False`` keeps the append/commit ordering but skips the
    physical sync — the benchmark's "how much of the overhead is the
    disk" probe; a production run leaves it on."""

    dir: str | Path
    fsync: bool = True
    snapshot_interval: int = 4  # windows between snapshots (>=1)
    keep_snapshots: int = 2


@dataclasses.dataclass
class DurabilityStats:
    """Counters surfaced through `ServeEngine.health()["durability"]`."""

    records_appended: int = 0
    bytes_appended: int = 0
    commits: int = 0
    last_commit_step: int = -1
    torn_records_dropped: int = 0
    torn_bytes_dropped: int = 0
    replayed_windows: int = 0
    replayed_records: int = 0
    snapshots_written: int = 0
    snapshots_skipped_invalid: int = 0
    last_snapshot_step: int = -1

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class WriteAheadLog:
    """Append-only CRC-framed record log with torn-tail recovery."""

    def __init__(self, path: str | Path, fsync: bool = True):
        self.path = Path(path)
        self.fsync = fsync
        self._fh = None  # opened lazily, AFTER recover() truncated the tail

    # -- read side ---------------------------------------------------------

    def recover(self) -> Tuple[List[dict], int, int]:
        """Scan the log, parse every whole valid frame, and TRUNCATE the
        file to that prefix.  Returns ``(records, dropped_records,
        dropped_bytes)`` — a torn tail (short header, short payload, CRC
        mismatch, unparseable JSON) is an expected crash artifact, not an
        error."""
        if not self.path.exists():
            return [], 0, 0
        blob = self.path.read_bytes()
        records: List[dict] = []
        off = 0
        while off + _FRAME.size <= len(blob):
            length, crc = _FRAME.unpack_from(blob, off)
            start = off + _FRAME.size
            if length > _MAX_RECORD or start + length > len(blob):
                break
            payload = blob[start:start + length]
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                break
            try:
                records.append(json.loads(payload.decode("utf-8")))
            except ValueError:
                break
            off = start + length
        dropped_bytes = len(blob) - off
        if dropped_bytes:
            with open(self.path, "r+b") as f:
                f.truncate(off)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
        # dropped record count: at most one frame is torn; anything beyond
        # it is unreadable, so count frames conservatively as >= 1
        dropped_records = 1 if dropped_bytes else 0
        return records, dropped_records, dropped_bytes

    # -- write side --------------------------------------------------------

    def _handle(self):
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "ab")
        return self._fh

    def append(self, record: dict) -> int:
        """Buffered append of one frame; returns the frame's byte size.
        Call `sync()` to make everything appended so far durable."""
        payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
        frame = _FRAME.pack(
            len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ) + payload
        self._handle().write(frame)
        return len(frame)

    def sync(self) -> None:
        fh = self._handle()
        fh.flush()
        if self.fsync:
            os.fsync(fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class DurableStore:
    """The engine-facing durability surface: one WAL + a snapshot tree +
    a heartbeat file, rooted at ``cfg.dir``.

    Layout:
      <dir>/wal.log                  — CRC-framed admission/commit log
      <dir>/snapshots/step_<N>/      — persist.save_tree manifests
      <dir>/heartbeat.json           — liveness beacon (step + wall time),
                                       atomically rewritten at every
                                       commit; the supervisor watches its
                                       mtime to detect hangs
    """

    def __init__(self, cfg: DurabilityConfig, obs=None):
        if obs is None:
            from repro_torch.obs import NULL as obs  # disabled bundle
        self.cfg = cfg
        self.obs = obs
        self.root = Path(cfg.dir)
        self.root.mkdir(parents=True, exist_ok=True)
        self.wal = WriteAheadLog(self.root / "wal.log", fsync=cfg.fsync)
        self.snap_root = self.root / "snapshots"
        self.heartbeat_path = self.root / "heartbeat.json"
        self.stats = DurabilityStats()
        self._windows_since_snapshot = 0
        self._records: Optional[List[dict]] = None  # recover() cache
        self.suppress_events = False  # replay re-derives sheds/evicts

    # -- WAL façade --------------------------------------------------------

    def read_wal(self) -> List[dict]:
        """Recover-read the log once (truncating any torn tail) and cache
        the parsed records for this process."""
        if self._records is None:
            records, dropped_r, dropped_b = self.wal.recover()
            self._records = records
            self.stats.torn_records_dropped += dropped_r
            self.stats.torn_bytes_dropped += dropped_b
        return self._records

    def _append(self, record: dict) -> None:
        n = self.wal.append(record)
        self.stats.records_appended += 1
        self.stats.bytes_appended += n

    def log_window(self, step0: int,
                   arrivals_by_tick: List[List[Request]]) -> None:
        """WRITE-AHEAD: durably record a window's admissions before any of
        them execute — fsynced, so a crash mid-window can replay it."""
        self._append({
            "kind": "window",
            "step0": int(step0),
            "arrivals": [
                [request_to_dict(r) for r in tick]
                for tick in arrivals_by_tick
            ],
        })
        self.wal.sync()
        self.obs.metrics.inc("wal_syncs_total", kind="window")
        self.obs.tracer.instant("wal_fsync", cat="durability",
                                kind="window", step0=int(step0))

    def log_event(self, kind: str, payload: Dict[str, Any]) -> None:
        """Buffered informational record (shed/evict) — made durable by
        the window's commit sync.  Suppressed during replay: the replayed
        window re-derives the same drops deterministically, and double-
        logging would corrupt the audit trail."""
        if self.suppress_events:
            return
        self._append({"kind": kind, **payload})

    def log_commit(self, step: int,
                   health: Optional[Dict[str, Any]] = None) -> None:
        rec = {"kind": "commit", "step": int(step)}
        if health:
            rec["health"] = health
        self._append(rec)
        self.wal.sync()
        self.stats.commits += 1
        self.stats.last_commit_step = int(step)
        self.obs.metrics.inc("wal_syncs_total", kind="commit")
        self.obs.tracer.instant("wal_fsync", cat="durability",
                                kind="commit", step=int(step))
        beat = {"step": int(step), "time": time.time(),
                "commits": self.stats.commits}
        if health:
            # the last known metrics snapshot rides the heartbeat, so a
            # hang/crash post-mortem reads counters, not just a step
            beat["metrics"] = health
        persist.atomic_write_json(
            self.heartbeat_path, beat,
            fsync=False,  # advisory liveness beacon, not a recovery input
        )

    def window_suffix(self, after_step: int) -> List[dict]:
        """The committed-or-torn window records to replay after a snapshot
        taken at engine step `after_step` (window records whose first tick
        is at or past it)."""
        return [
            r for r in self.read_wal()
            if r.get("kind") == "window" and r["step0"] >= after_step
        ]

    # -- snapshots ---------------------------------------------------------

    def should_snapshot(self) -> bool:
        return (
            self._windows_since_snapshot >= max(self.cfg.snapshot_interval, 1)
        )

    def window_committed(self) -> None:
        self._windows_since_snapshot += 1

    def snapshot(self, step: int, arrays: Any,
                 host_state: Dict[str, Any]) -> Path:
        """Crash-consistent snapshot: array pytree in CRC'd npz shards,
        host state in the manifest `extra` — atomic via tmp+rename, so a
        crash mid-snapshot leaves the previous snapshot intact."""
        with self.obs.tracer.span("snapshot", cat="durability",
                                  step=int(step)):
            path = persist.save_tree(
                self.snap_root, int(step), arrays,
                extra=host_state, fsync=self.cfg.fsync,
            )
            persist.prune_steps(self.snap_root, self.cfg.keep_snapshots)
        self._windows_since_snapshot = 0
        self.stats.snapshots_written += 1
        self.stats.last_snapshot_step = int(step)
        self.obs.metrics.inc("snapshots_total")
        return path

    def load_newest_valid(
        self, like: Any
    ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """Load the newest snapshot that validates (manifest + shard CRCs
        + leaf index), skipping damaged ones with accounting.  Returns
        ``(step, arrays, host_state)`` or None when nothing valid exists
        (recovery then replays the whole WAL from a fresh init)."""
        steps = persist.available_steps(self.snap_root)
        pointed = persist.latest_step(self.snap_root)
        if pointed is not None and pointed in steps:
            steps.remove(pointed)
            steps.insert(0, pointed)
        for step in steps:
            try:
                tree, manifest = persist.load_tree(self.snap_root, like, step)
            except SnapshotCorruptError:
                # absorbed with accounting — an older snapshot (or fresh
                # init) takes over; the error is still OBSERVED
                self.stats.snapshots_skipped_invalid += 1
                self.obs.metrics.inc(
                    "errors_total", code="SNAPSHOT_CORRUPT"
                )
                self.obs.tracer.instant(
                    "snapshot_skipped", cat="durability", step=int(step)
                )
                continue
            return step, tree, manifest["extra"]
        return None

    def close(self) -> None:
        self.wal.close()


__all__ = [
    "DurabilityConfig", "DurabilityStats", "DurableStore",
    "WriteAheadLog", "request_to_dict", "request_from_dict",
]
