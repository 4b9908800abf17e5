"""Window-timeline tracer: structured spans/instants, Chrome-trace export.

Counterpart of src/repro/obs/tracing.py, extended with real nested spans
and a clock a profiler's trace can share.

Records the serving stack's control flow as trace events — the engine's
windows and steps, the scheduler's windows and ticks, each `SmartPQ.step`
and its phases, the model's decode step and its sublayers, mode
transitions (with the classifier's feature vector), overload state
changes, checkpoint/rollback/recovery, WAL fsyncs, snapshot writes — and
exports them as Chrome trace-event JSON, loadable in Perfetto /
chrome://tracing, so a full serving run renders as a timeline.

Two span flavors:

  span(name, cat, args)   context manager around real work.  Its event
                          enters the buffer when the span opens (parents
                          precede their children) and carries `span_id`
                          and `parent_id`, the enclosing open span's id
                          (None at the top); its `dur` is set when it
                          closes.  The context's value is the event, so a
                          caller may fill in `args` it learns later.
  span_at(name, ts, dur)  an interval recorded after the fact.

A disabled tracer's `span` is one branch returning the shared
`NULL_SPAN`: no event, no allocation.

The clock.  Timestamps are microseconds on `time.perf_counter` since the
tracer was built.  A `torch.profiler` trace keeps its own clock; inside a
profiled region `anchor()` opens one `record_function` range named
``obs.anchor.<n>`` and reads the tracer's clock inside it, so the range's
interval in the profiler's trace holds that reading.
`to_profiler_clock` places every event on the profiler's timeline through
the anchors both traces hold, each of which bounds the offset between the
two clocks.  Program spans are never `record_function` ranges: a device
call is filed under the innermost range around its launch, and the spans
must not change what the ranges already there read.

Rollback hygiene: guarded windows `mark()` before executing and
`truncate(mark)` on rollback, so a rolled-back window's events vanish
from the timeline exactly like its state changes vanish from the queue —
the trace shows a `rollback` instant instead of phantom work.

The buffer is bounded (`max_events`); overflow drops newest events with
an explicit `dropped` count (never silently).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_MAX_EVENTS = 500_000
# Name prefix of the anchor ranges in a profiler's trace.
ANCHOR = "obs.anchor"


class _NullSpan:
    """A disabled tracer's span: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


NULL_SPAN = _NullSpan()


class _Span:
    """One open span of an enabled tracer (module docstring)."""

    __slots__ = ("tracer", "event")

    def __init__(self, tracer: "Tracer", event: Dict[str, object]):
        self.tracer = tracer
        self.event = event

    def __enter__(self) -> Dict[str, object]:
        tr, ev = self.tracer, self.event
        ev["span_id"] = sid = tr._next_id
        tr._next_id += 1
        ev["parent_id"] = tr._stack[-1] if tr._stack else None
        tr._stack.append(sid)
        tr._emit(ev)
        ev["ts"] = tr.now_us()
        return ev

    def __exit__(self, exc_type, exc, tb):
        tr, ev = self.tracer, self.event
        ev["dur"] = tr.now_us() - ev["ts"]
        tr._stack.pop()
        return None


class Tracer:
    """Append-only trace-event buffer with Chrome JSON export."""

    def __init__(self, enabled: bool = False,
                 max_events: int = DEFAULT_MAX_EVENTS):
        self.enabled = enabled
        self.max_events = max_events
        self.events: List[Dict[str, object]] = []
        self.dropped = 0
        self._t0 = time.perf_counter()
        self._stack: List[int] = []  # ids of the open spans
        self._next_id = 0
        self._anchors = 0

    # -- clock -------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since tracer construction (trace-local clock)."""
        return (time.perf_counter() - self._t0) * 1e6

    def anchor(self) -> None:
        """Mark the tracer's clock in a running profiler's trace: one
        `record_function` range ``obs.anchor.<n>`` holding a reading of
        `now_us`, kept as a ``clock_anchor`` instant (cat ``anchor``).
        Call it at the start and at the end of a profiled region."""
        if not self.enabled:
            return
        from torch.profiler import record_function

        n = self._anchors
        self._anchors += 1
        with record_function(f"{ANCHOR}.{n}"):
            t = self.now_us()
        self.instant("clock_anchor", cat="anchor", ts=t, id=n)

    # -- emission ----------------------------------------------------------

    def _emit(self, ev: Dict[str, object]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span(self, name: str, cat: str = "serve",
             args: Optional[Dict[str, object]] = None):
        """A real-time span around the with-body (module docstring)."""
        if not self.enabled:
            return NULL_SPAN
        ev: Dict[str, object] = {"name": name, "cat": cat, "ph": "X",
                                 "pid": 0, "tid": 0}
        if args:
            ev["args"] = args
        return _Span(self, ev)

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


def to_profiler_clock(
    events: Sequence[Dict[str, object]],
    profile_events: Sequence[Dict[str, object]],
) -> Tuple[List[Dict[str, object]], float]:
    """Copies of a tracer's `events` with `ts` on the clock of a profiler's
    Chrome trace `profile_events`, and the bound in microseconds on how far
    any of them may lie from its true place.

    Each ``clock_anchor`` instant whose ``obs.anchor.<n>`` range the trace
    holds bounds the offset between the clocks: the reading lies inside
    the range.  Where the anchors' bounds overlap, the offset is the middle
    of their overlap and the bound half its width.  Where they do not (the
    clocks drifted apart by more than the ranges' lengths), the narrowest
    range sets the offset and the bound is the widest of each anchor's
    half-length plus its distance from that offset.  Raises `ValueError`
    when no anchor is in both."""
    ranges = {e["name"]: e for e in profile_events
              if e.get("ph") == "X" and str(e.get("name", "")).startswith(
                  ANCHOR + ".")}
    found = []  # (lowest offset, highest offset)
    for e in events:
        if e.get("cat") != "anchor" or e.get("name") != "clock_anchor":
            continue
        r = ranges.get(f"{ANCHOR}.{e['args']['id']}")
        if r is not None:
            lo = float(r["ts"]) - float(e["ts"])
            found.append((lo, lo + float(r["dur"])))
    if not found:
        raise ValueError("no clock anchor of the tracer is in the "
                         "profiler's trace")
    lo, hi = max(a for a, _ in found), min(b for _, b in found)
    if lo <= hi:
        offset, bound = 0.5 * (lo + hi), 0.5 * (hi - lo)
    else:
        a, b = min(found, key=lambda x: x[1] - x[0])
        offset = 0.5 * (a + b)
        bound = max(max(offset - a2, b2 - offset) for a2, b2 in found)
    out = []
    for e in events:
        ev = dict(e)
        ev["ts"] = float(e["ts"]) + offset
        out.append(ev)
    return out, bound


__all__ = ["Tracer", "DEFAULT_MAX_EVENTS", "NULL_SPAN", "ANCHOR",
           "to_profiler_clock"]
