"""Structured errors of the port's PQ stack.

Counterpart of src/repro/core/errors.py: the whole taxonomy, with the
reference's codes and messages, so callers can dispatch on them alike.

  PQError                    base — anything raised by this stack
  ├─ InvariantViolation      a PQState invariant (I1–I6) failed a runtime
  │                          validation pass
  ├─ TraceCorruptError       a Trace npz failed to load or to validate
  │                          (truncated file, bad op codes, shape mismatch)
  ├─ WindowValidationError   a scheduler window tripped validation and so
  │                          did its conservative retry; the pre-window
  │                          checkpoint has been restored when it is raised
  ├─ SnapshotCorruptError    a persisted snapshot failed validation
  └─ CrashLoopError          the serve supervisor's circuit breaker opened
"""

from __future__ import annotations

from typing import List, Optional


class PQError(Exception):
    """Base of the taxonomy; ``code`` is stable across releases."""

    code = "PQ_ERROR"


class InvariantViolation(PQError):
    """One PQState invariant failed a runtime validation pass.

    ``invariant`` is the state module's identifier ("I1".."I6"),
    ``shard`` the offending shard (or -1 for whole-state violations)."""

    code = "INVARIANT"

    def __init__(self, invariant: str, shard: int, detail: str):
        self.invariant = invariant
        self.shard = int(shard)
        self.detail = detail
        super().__init__(f"{invariant} shard={shard}: {detail}")


class TraceCorruptError(PQError):
    """A Trace npz could not be loaded/validated (truncation, flipped
    bytes, out-of-range op codes, inconsistent shapes)."""

    code = "TRACE_CORRUPT"

    def __init__(self, detail: str, path: Optional[str] = None):
        self.detail = detail
        self.path = path
        super().__init__(
            f"corrupt trace{f' {path}' if path else ''}: {detail}"
        )


class WindowValidationError(PQError):
    """A scheduler window failed validation and so did its one-shot
    conservative retry.  State has been rolled back to the pre-window
    checkpoint before this is raised: the window's work did not happen."""

    code = "WINDOW_VALIDATION"

    def __init__(
        self,
        first: List[InvariantViolation],
        retry: List[InvariantViolation],
    ):
        self.first = list(first)
        self.retry = list(retry)
        super().__init__(
            f"window validation failed and fallback retry failed too "
            f"(first: {[str(v) for v in first]}; "
            f"retry: {[str(v) for v in retry]})"
        )


class SnapshotCorruptError(PQError):
    """A persisted snapshot directory failed validation (missing or
    truncated shard, CRC mismatch, stale manifest)."""

    code = "SNAPSHOT_CORRUPT"

    def __init__(self, detail: str, path: Optional[str] = None):
        self.detail = detail
        self.path = path
        super().__init__(
            f"corrupt snapshot{f' {path}' if path else ''}: {detail}"
        )


class CrashLoopError(PQError):
    """The serve supervisor's circuit breaker opened: its child died more
    than `max_restarts` times inside `crash_window` seconds."""

    code = "CRASH_LOOP"

    def __init__(self, restarts: int, window_s: float, exit_codes):
        self.restarts = int(restarts)
        self.window_s = float(window_s)
        self.exit_codes = list(exit_codes)
        super().__init__(
            f"crash loop: {restarts} restarts within {window_s:.1f}s "
            f"(exit codes {self.exit_codes})"
        )
