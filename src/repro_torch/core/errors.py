"""Structured errors of the port's PQ stack.

Counterpart of src/repro/core/errors.py, carrying the
part of its taxonomy the port raises so far: the base class, the
`InvariantViolation` that `state.invariant_violations` returns and the
`TraceCorruptError` of `workloads.traces.load_trace`.  The codes and
messages are the reference's, so callers can dispatch on them alike.

  PQError                    base — anything raised by this stack
  ├─ InvariantViolation      a PQState invariant (I1–I6) failed a runtime
  │                          validation pass
  └─ TraceCorruptError       a Trace npz failed to load or to validate
                             (truncated file, bad op codes, shape mismatch)
"""

from __future__ import annotations

from typing import Optional


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
