"""SLO-class graceful degradation under overload.

Counterpart of src/repro/serve/overload.py, a host-only copy; the mode vote
names the port's `MODE_MULTIQ`.

The serving tier's admission path was previously open-loop: every arrival
was accepted, queueing in unbounded host lists until served.  Under
sustained overload (offered load > capacity) that design fails exactly the
clients the SLO-major priority key was built to protect — the backlog grows
without bound, memory grows with it, and once the engine's own over-
admission FIFO (which is *not* priority ordered) fills, even class-0
latency collapses.

This module closes the loop.  An `OverloadController` watches, per SLO
class, (a) backlog depth and (b) a sliding window of queueing delays, and
compares the window p99 against per-class targets.  Classes degrade
independently through three states with hysteresis:

  OK        -> admit everything
  DEGRADED  -> admit, but vote to force the PQ into relaxed MULTIQ mode
               (cheap approximate deleteMin buys throughput back at the
               cost of strict order — exactly the SmartPQ adaptation axis,
               commandeered as a load-shedding lever for best-effort work)
  SHEDDING  -> reject new arrivals of this class at admission, with
               explicit per-class drop accounting

Class 0 (interactive) is protected: it never enters SHEDDING and never
votes for relaxed mode — under overload the lower classes are sacrificed
so the highest class's p99 stays within target.  Backlogs are additionally hard-capped: `evict`
drops the newest lowest-class entries once the cap is hit, bounding memory
under any arrival storm.

Degradation decisions use *censored* observations too: under hard overload
a starved class completes nothing, so completion-time samples alone would
read as "no data, all fine".  Callers therefore also feed the current
waiting time of still-pending requests (`observe_pending`); a request that
has already waited past target is evidence of violation even though it
hasn't finished.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Controller states, ordered by severity.
OK = 0
DEGRADED = 1
SHEDDING = 2

_STATE_NAMES = {OK: "ok", DEGRADED: "degraded", SHEDDING: "shedding"}


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Per-class queueing-delay targets (steps) and controller knobs.

    ``targets[c]`` is the p99 queueing-delay budget for SLO class c;
    classes beyond the tuple reuse the last entry.  A class DEGRADES when
    its observed p99 crosses ``degrade_margin * target`` and SHEDS when it
    crosses ``target`` (class 0 exempt from shedding).  Recovery requires
    the p99 to fall below ``recover_margin * target`` — the hysteresis gap
    prevents flapping at the boundary."""

    targets: Tuple[float, ...] = (8.0, 32.0, 128.0)
    backlog_cap: int = 4096  # across all classes; evict() enforces
    window: int = 256  # queueing-delay samples kept per class
    degrade_margin: float = 0.75
    recover_margin: float = 0.5
    min_samples: int = 8  # below this, a class never escalates

    def target(self, slo_class: int) -> float:
        c = min(max(int(slo_class), 0), len(self.targets) - 1)
        return float(self.targets[c])


@dataclasses.dataclass
class OverloadStats:
    shed: Dict[int, int] = dataclasses.field(default_factory=dict)
    evicted: Dict[int, int] = dataclasses.field(default_factory=dict)
    degraded_ticks: int = 0  # ticks where >=1 class voted MULTIQ
    shedding_ticks: int = 0  # ticks where >=1 class was SHEDDING

    def total_shed(self) -> int:
        return sum(self.shed.values()) + sum(self.evicted.values())


class OverloadController:
    """Per-SLO-class backlog/latency watchdog driving graceful degradation.

    Protocol per scheduler tick:
      1. `observe(cls, delay)` for each completion's queueing delay, and
         `observe_pending(cls, waited)` for still-queued requests (censored
         samples — counted only when already past target).
      2. `update(backlog_by_class)` recomputes per-class states.
      3. `admit(requests)` filters arrivals (returns kept, shed).
      4. `mode_override()` yields the PQ mode vote (-1 = none).
      5. `evict(backlog)` trims the backlog to the cap.
    """

    def __init__(self, config: OverloadConfig | None = None, obs=None):
        self.config = config or OverloadConfig()
        self.state: Dict[int, int] = {}
        self.stats = OverloadStats()
        self._samples: Dict[int, List[float]] = {}
        self._censored: Dict[int, int] = {}  # pending-past-target counts
        # Observability bundle (`obs.Observability`) — state
        # transitions emit counters + timeline instants through it.  The
        # owning scheduler/engine attaches its own; None stays silent.
        self.obs = obs

    def _set_state(self, c: int, new: int) -> None:
        """The ONLY place a class's state changes: every edge is counted
        (``overload_transitions_total{slo=,to=}``) and lands on the
        timeline as an `overload_state` instant."""
        old = self.state.get(c, OK)
        self.state[c] = new
        if new == old or self.obs is None:
            return
        self.obs.metrics.inc(
            "overload_transitions_total", slo=c, to=_STATE_NAMES[new]
        )
        self.obs.tracer.instant(
            "overload_state", cat="overload", slo=c,
            from_state=_STATE_NAMES[old], to_state=_STATE_NAMES[new],
        )

    # -- observation ------------------------------------------------------

    def observe(self, slo_class: int, delay: float) -> None:
        buf = self._samples.setdefault(int(slo_class), [])
        buf.append(float(delay))
        if len(buf) > self.config.window:
            del buf[: len(buf) - self.config.window]

    def observe_pending(self, slo_class: int, waited: float) -> None:
        # Censored: the eventual delay is >= waited; it only becomes
        # evidence once it already exceeds the class target.
        if float(waited) > self.config.target(slo_class):
            c = int(slo_class)
            self._censored[c] = self._censored.get(c, 0) + 1

    def p99(self, slo_class: int) -> float:
        buf = self._samples.get(int(slo_class), [])
        if not buf:
            return 0.0
        return float(np.percentile(np.asarray(buf), 99))

    # -- control law ------------------------------------------------------

    def update(self, backlog_by_class: Dict[int, int] | None = None) -> None:
        cfg = self.config
        for c in set(self._samples) | set(self._censored) | set(self.state):
            tgt = cfg.target(c)
            n = len(self._samples.get(c, []))
            censored = self._censored.get(c, 0)
            # Censored observations saturate the percentile: enough
            # past-target waiters means the true p99 exceeds target no
            # matter what the completed samples say.
            p = self.p99(c)
            if censored >= max(cfg.min_samples, (n + censored) // 100 + 1):
                p = max(p, tgt + 1.0)
            cur = self.state.get(c, OK)
            if n + censored < cfg.min_samples:
                continue
            if cur == OK:
                if p > tgt and c > 0:
                    self._set_state(c, SHEDDING)
                elif p > cfg.degrade_margin * tgt:
                    self._set_state(c, DEGRADED)
            elif cur == DEGRADED:
                if p > tgt and c > 0:
                    self._set_state(c, SHEDDING)
                elif p < cfg.recover_margin * tgt:
                    self._set_state(c, OK)
            elif cur == SHEDDING:
                if p < cfg.recover_margin * tgt:
                    self._set_state(c, OK)
                elif p < cfg.degrade_margin * tgt:
                    self._set_state(c, DEGRADED)
        self._censored.clear()
        if any(s == DEGRADED for s in self.state.values()):
            self.stats.degraded_ticks += 1
        if any(s == SHEDDING for s in self.state.values()):
            self.stats.shedding_ticks += 1

    # -- actuation --------------------------------------------------------

    def admit(self, requests: Sequence) -> Tuple[list, list]:
        """Split arrivals into (kept, shed) by the current per-class state.
        Shed requests are counted in `stats.shed` — drops are explicit,
        never silent."""
        kept, shed = [], []
        for r in requests:
            c = int(getattr(r, "slo_class", 0))
            if self.state.get(c, OK) == SHEDDING and c > 0:
                shed.append(r)
                self.stats.shed[c] = self.stats.shed.get(c, 0) + 1
            else:
                kept.append(r)
        return kept, shed

    def mode_override(self) -> int:
        """PQ mode vote: MULTIQ (1) while any best-effort class (c > 0) is
        DEGRADED or worse, else -1 (no override — the classifier rules).
        Relaxed deleteMin trades strict SLO order for throughput, which is
        the right trade while ONLY lower classes are drowning — the mode is
        queue-global, so the vote is gated on the protected class being
        healthy: the moment class 0 leaves OK, the override drops and
        strict SLO order returns (measured: an ungated override inverts
        class-0 priority under mixed overload and multiplies its p99)."""
        from repro_torch.core.smartpq import MODE_MULTIQ

        if self.state.get(0, OK) != OK:
            return -1
        if any(
            s >= DEGRADED for c, s in self.state.items() if c > 0
        ):
            return int(MODE_MULTIQ)
        return -1

    def evict(self, backlog: List) -> List[object]:
        """Trim `backlog` (in place) to `config.backlog_cap`, dropping the
        newest lowest-SLO-class entries first; returns the evicted
        requests.  This bounds host memory under arrival storms no matter
        what the admission filter let through."""
        cap = self.config.backlog_cap
        excess = len(backlog) - cap
        if excess <= 0:
            return []
        # Sort victim candidates: lowest class last (class asc), newest
        # last within class — then peel from the end.
        order = sorted(
            range(len(backlog)),
            key=lambda i: (
                int(getattr(backlog[i], "slo_class", 0)),
                int(getattr(backlog[i], "arrival_step", i)),
            ),
        )
        victims = set(order[-excess:])
        evicted = [backlog[i] for i in sorted(victims)]
        backlog[:] = [r for i, r in enumerate(backlog) if i not in victims]
        for r in evicted:
            c = int(getattr(r, "slo_class", 0))
            self.stats.evicted[c] = self.stats.evicted.get(c, 0) + 1
        return evicted

    # -- persistence ------------------------------------------------------

    def state_dict(self) -> Dict[str, object]:
        """JSON-able controller state (everything `update` evolves —
        per-class states, sliding sample windows, censored counts, stats).
        The durability layer stores this inside the snapshot manifest;
        `load_state_dict` must restore it bit-for-bit, or a replayed
        window would shed a different request set than the original run."""
        return {
            "state": {str(c): s for c, s in self.state.items()},
            "samples": {str(c): list(v) for c, v in self._samples.items()},
            "censored": {str(c): n for c, n in self._censored.items()},
            "stats": {
                "shed": {str(c): n for c, n in self.stats.shed.items()},
                "evicted": {
                    str(c): n for c, n in self.stats.evicted.items()
                },
                "degraded_ticks": self.stats.degraded_ticks,
                "shedding_ticks": self.stats.shedding_ticks,
            },
        }

    def load_state_dict(self, d: Dict[str, object]) -> None:
        self.state = {int(c): int(s) for c, s in d["state"].items()}
        self._samples = {
            int(c): [float(x) for x in v]
            for c, v in d["samples"].items()
        }
        self._censored = {
            int(c): int(n) for c, n in d["censored"].items()
        }
        st = d["stats"]
        self.stats = OverloadStats(
            shed={int(c): int(n) for c, n in st["shed"].items()},
            evicted={int(c): int(n) for c, n in st["evicted"].items()},
            degraded_ticks=int(st["degraded_ticks"]),
            shedding_ticks=int(st["shedding_ticks"]),
        )

    # -- reporting --------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        return {
            "state": {
                c: _STATE_NAMES[s] for c, s in sorted(self.state.items())
            },
            "p99": {c: self.p99(c) for c in sorted(self._samples)},
            "shed": dict(self.stats.shed),
            "evicted": dict(self.stats.evicted),
            "degraded_ticks": self.stats.degraded_ticks,
            "shedding_ticks": self.stats.shedding_ticks,
        }


__all__ = [
    "OK", "DEGRADED", "SHEDDING",
    "OverloadConfig", "OverloadStats", "OverloadController",
]
