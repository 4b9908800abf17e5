"""Structured errors of the port's PQ stack.

Counterpart of src/repro/core/errors.py, carrying the
part of its taxonomy this slice raises: the base class and the
`InvariantViolation` that `state.invariant_violations` returns.  The codes
are the reference's, so callers can dispatch on them alike.

  PQError                    base — anything raised by this stack
  └─ InvariantViolation      a PQState invariant (I1–I6) failed a runtime
                             validation pass
"""

from __future__ import annotations


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
