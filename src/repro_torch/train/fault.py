"""Fault tolerance: straggler watchdog, failure injection, preemption.

A copy of src/repro/train/fault.py (host-only code, copied so that the
port imports nothing of the JAX package):

At 1000+ nodes the common failures are (a) slow hosts (stragglers), (b)
preemptions, (c) hard node loss.  The runtime pieces here are host-side;
they wrap the step function, so they work the same whatever runs the step:

  * StragglerWatchdog: EWMA of step wall-times; a step slower than
    `threshold x` the EWMA raises a StragglerEvent (the loop logs it and,
    on repeated events, triggers a checkpoint so a replacement can join;
    at real scale the detection signal comes per-host from the coordinator).
  * PreemptionGuard: converts SIGTERM/SIGINT into a "checkpoint now, then
    exit cleanly" request checked once per step.
  * FailureInjector: deterministic fault schedule for tests (step k ->
    raise), proving the restart path end to end.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import List, Optional


class StragglerEvent(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 3.0  # x EWMA
    alpha: float = 0.2
    warmup_steps: int = 3
    _ewma: Optional[float] = None
    _seen: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> Optional[dict]:
        self._seen += 1
        if self._ewma is None:
            self._ewma = dt
            return None
        is_slow = self._seen > self.warmup_steps and dt > self.threshold * self._ewma
        event = None
        if is_slow:
            event = {"step": step, "dt": dt, "ewma": self._ewma}
            self.events.append(event)
        else:
            # Stragglers don't poison the baseline.
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return event


class PreemptionGuard:
    """SIGTERM/SIGINT -> graceful 'save and exit' at the next step edge."""

    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:
                    pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for sig, h in self._prev.items():
            signal.signal(sig, h)


@dataclasses.dataclass
class FailureInjector:
    """fail_at: steps at which to raise (each fires once)."""

    fail_at: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")
