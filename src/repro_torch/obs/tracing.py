"""Window-timeline tracer: structured spans/instants, Chrome-trace export.

Counterpart of src/repro/obs/tracing.py, a host-only copy.

Records the serving stack's control flow as trace events — window
dispatches, per-tick admission, mode transitions (with the classifier's
feature vector), elimination hits, overload state changes,
checkpoint/rollback/recovery, WAL fsyncs, snapshot writes, kernel-arm
resolutions — and exports them as Chrome trace-event JSON, loadable in
Perfetto / chrome://tracing, so a full serving run renders as a timeline.

Two span flavors:

  span(name)            context manager measuring real wall time — the
                        window dispatch envelope.
  span_at(name, ts, dur)  synthesized interval — the scheduler subdivides
                        one fused K-tick device call into K logical tick
                        spans (the device executes all K ticks in one
                        dispatch; per-tick host timestamps do not exist,
                        but per-tick ARGS — mode, dispatches, eliminations
                        — do, and the timeline stays navigable).

Rollback hygiene: guarded windows `mark()` before executing and
`truncate(mark)` on rollback, so a rolled-back window's events vanish
from the timeline exactly like its state changes vanish from the queue —
the trace shows a `rollback` instant instead of phantom work.

The buffer is bounded (`max_events`); overflow drops newest events with
an explicit `dropped` count (never silently).  A disabled tracer costs
one attribute load + branch per call site.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

DEFAULT_MAX_EVENTS = 500_000


class Tracer:
    """Append-only trace-event buffer with Chrome JSON export."""

    def __init__(self, enabled: bool = False,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self.enabled = enabled
        self.max_events = max_events
        self.events: List[Dict[str, object]] = []
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- clock -------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer construction (trace-local clock)."""
        return (time.perf_counter() - self._t0) * 1e6

    # -- emission ----------------------------------------------------------

    def _emit(self, ev: Dict[str, object]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span_at(self, name: str, ts: float, dur: float,
                cat: str = "serve", **args) -> None:
        if not self.enabled:
            return
        ev: Dict[str, object] = {
            "name": name, "cat": cat, "ph": "X", "pid": 0, "tid": 0,
            "ts": float(ts), "dur": float(dur),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, name: str, cat: str = "serve",
                ts: Optional[float] = None, **args) -> None:
        if not self.enabled:
            return
        ev: Dict[str, object] = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "pid": 0, "tid": 0,
            "ts": self.now_us() if ts is None else float(ts),
        }
        if args:
            ev["args"] = args
        self._emit(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", **args):
        """Real-time complete span around the with-body."""
        if not self.enabled:
            yield None
            return
        t0 = self.now_us()
        try:
            yield None
        finally:
            self.span_at(name, t0, self.now_us() - t0, cat=cat, **args)

    # -- rollback hygiene --------------------------------------------------

    def mark(self) -> int:
        """Buffer position for `truncate` — call before a guarded window."""
        return len(self.events)

    def truncate(self, mark: int) -> None:
        """Discard everything emitted since `mark` (rolled-back work)."""
        del self.events[mark:]

    # -- export ------------------------------------------------------------

    def to_chrome(self) -> Dict[str, object]:
        """Chrome trace-event JSON object (Perfetto-loadable)."""
        return {
            "traceEvents": list(self.events),
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "repro_torch.obs.tracing",
                "dropped_events": self.dropped,
            },
        }

    def export(self, path: str | Path, fsync: bool = False) -> Path:
        from repro_torch.core.persist import atomic_write_json

        return atomic_write_json(Path(path), self.to_chrome(), fsync=fsync)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0


__all__ = ["Tracer", "DEFAULT_MAX_EVENTS"]
