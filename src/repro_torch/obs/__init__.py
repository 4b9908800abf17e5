"""Observability of the port: metrics, tracing, profiling hooks.

Counterpart of src/repro/obs/__init__.py.  One `Observability` facade
bundles what the serving stack threads through its layers:

  .metrics   `MetricsRegistry` — counters/gauges/histograms, the single
             source of truth behind `ServeEngine.health()` and the SLO
             percentile reads.
  .tracer    `Tracer` — window-timeline spans/instants with a Chrome
             trace export (off by default: its buffer grows with the run).

The facade is identity-preserving under deepcopy: scheduler checkpoints
deep-copy everything a window can mutate, but telemetry must not fork — a
rolled-back window's trace cleanup goes through `Tracer.truncate`, and
counters keep counting across rollbacks.

`NULL` is the shared disabled instance (every write early-outs); layers
given no observability default to it.  `get_default()` is the process-wide
instance for call sites with nothing to thread through (`load_trace`'s
error counter).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.obs.metrics import (
    LATENCY_STEP_EDGES, PER_TOKEN_EDGES, MetricsRegistry,
)
from repro_torch.obs.tracing import Tracer


class Observability:
    """Metrics + tracer bundle (module docstring)."""

    def __init__(self, metrics: bool = True, tracing: bool = False,
                 max_trace_events: Optional[int] = None):
        self.metrics = MetricsRegistry(enabled=metrics)
        if max_trace_events is None:
            self.tracer = Tracer(enabled=tracing)
        else:
            self.tracer = Tracer(enabled=tracing,
                                 max_events=max_trace_events)

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    def __deepcopy__(self, memo):
        # Telemetry is identity under checkpoint/restore (module docstring).
        return self

    def __copy__(self):
        return self


#: Shared disabled instance — the default for layers given no obs.
NULL = Observability(metrics=False, tracing=False)

_DEFAULT: Optional[Observability] = None


def get_default() -> Observability:
    """Process-wide observability (metrics on, tracing off), made lazily."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Observability(metrics=True, tracing=False)
    return _DEFAULT


def set_default(obs: Observability) -> Observability:
    """Replace the process-wide instance; returns the previous one."""
    global _DEFAULT
    prev = get_default()
    _DEFAULT = obs
    return prev


__all__ = [
    "Observability", "MetricsRegistry", "Tracer", "NULL",
    "LATENCY_STEP_EDGES", "PER_TOKEN_EDGES",
    "get_default", "set_default",
]
