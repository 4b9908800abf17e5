"""Metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of src/repro/obs/metrics.py, a host-only copy: the same series
keys, percentiles, exposition and saved payload (`SCHEMA`).

One process-local registry unifies the serving stack's accounting surfaces
(SmartPQ device stats, scheduler conservation ledger, overload states,
durability WAL/snapshot counters, kernel-arm resolutions) behind three
primitive types:

  counter    monotone float, `inc(name, n, **labels)`
  gauge      last-write-wins float, `set_gauge(name, v, **labels)`
  histogram  fixed upper-edge buckets, `observe(name, v, edges, **labels)`
             with p50/p99 summaries via `percentile` (see below)

Labels are plain keyword arguments; each distinct label set is its own
series, keyed Prometheus-style (``errors_total{code="INVARIANT"}``).  All
series of one histogram name share the edges declared at first `observe`
— that is what makes `percentile(name, q)` with a PARTIAL label set
meaningful: bucket counts merge exactly across series, so the aggregate
percentile is computed from the true merged distribution, not from
averaging per-series percentiles (which is statistically wrong).

Percentile estimates are the UPPER EDGE of the bucket holding the rank-q
sample (the last, unbounded bucket reports the observed max): a
conservative bound, exact whenever the observations and edges are both
integers that coincide — which is why the serving-latency edges below
enumerate every small integer step count.  SLO gates compare against
edge-valued targets, so "estimate == true value" holds exactly where it
matters.

Cost contract: a disabled registry (`enabled=False`) early-outs every
write at one attribute load + branch — cheap enough to leave call sites
unconditional in hot host loops.  Reads (`to_dict`, `percentile`,
exposition, persistence) are assumed cold.

Persistence rides `core.persist.atomic_write_json` (tmp + rename):
`save()`/`load()` round-trip the full registry, so a supervisor can
inspect the last flushed state of a hung or dead process.
"""

from __future__ import annotations

import bisect
import math
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

SCHEMA = 1

# Engine-step latency edges: every integer up to 64 (queueing delays and
# the per-class SLO targets 8/16/32 are all engine-step integers — upper-
# edge percentiles are EXACT there), then power-of-two-ish coarse tail.
LATENCY_STEP_EDGES: Tuple[float, ...] = tuple(
    float(x) for x in range(65)
) + (80.0, 96.0, 128.0, 192.0, 256.0, 384.0, 512.0, 768.0, 1024.0)

# Per-token latency (e2e steps / tokens emitted) is fractional: quarter-
# step resolution to 16, then half steps to 32, then the coarse tail.
PER_TOKEN_EDGES: Tuple[float, ...] = tuple(
    x / 4 for x in range(1, 65)
) + tuple(x / 2 for x in range(33, 65)) + (48.0, 64.0, 96.0, 128.0)


def _series_key(name: str, labels: Mapping[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class _Histogram:
    """One labeled histogram series: counts per bucket + sum/min/max."""

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, edges: Sequence[float]):
        self.edges = tuple(float(e) for e in edges)
        # counts[i] <= edges[i]; counts[-1] is the +inf overflow bucket
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def as_dict(self) -> Dict[str, object]:
        return {
            "edges": list(self.edges),
            "counts": list(self.counts),
            "count": self.count,
            "sum": self.sum,
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
        }

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "_Histogram":
        h = cls(d["edges"])
        h.counts = [int(c) for c in d["counts"]]
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = math.inf if d.get("min") is None else float(d["min"])
        h.max = -math.inf if d.get("max") is None else float(d["max"])
        return h


class MetricsRegistry:
    """Counters + gauges + histograms with label support (module docstring).

    Thread-safety: the serving stack is a single-controller host loop, so
    the registry is deliberately lock-free; concurrent writers need their
    own registry instances.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Histogram] = {}
        # histogram name -> canonical edges (all series of a name share)
        self._hist_edges: Dict[str, Tuple[float, ...]] = {}

    # -- writes (hot path: one branch when disabled) -----------------------

    def inc(self, name: str, n: float = 1, **labels) -> None:
        if not self.enabled:
            return
        k = _series_key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + n

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self.enabled:
            return
        self._gauges[_series_key(name, labels)] = float(value)

    def observe(self, name: str, value: float,
                edges: Optional[Sequence[float]] = None, **labels) -> None:
        if not self.enabled:
            return
        k = _series_key(name, labels)
        h = self._hists.get(k)
        if h is None:
            canon = self._hist_edges.get(name)
            if canon is None:
                canon = tuple(
                    float(e) for e in (edges or LATENCY_STEP_EDGES)
                )
                self._hist_edges[name] = canon
            h = self._hists[k] = _Histogram(canon)
        h.observe(float(value))

    # -- reads (cold) ------------------------------------------------------

    def value(self, name: str, **labels) -> float:
        """Counter-or-gauge read; 0.0 when the series does not exist."""
        k = _series_key(name, labels)
        if k in self._counters:
            return self._counters[k]
        return self._gauges.get(k, 0.0)

    def _matching_hists(self, name: str,
                        labels: Mapping[str, object]) -> List[_Histogram]:
        """All series of `name` whose labels are a superset of `labels`
        (empty labels -> every series of the name)."""
        frags = [f'{k}="{v}"' for k, v in labels.items()]
        out = []
        for key, h in self._hists.items():
            base = key.split("{", 1)[0]
            if base != name:
                continue
            if all(f in key for f in frags):
                out.append(h)
        return out

    def hist_count(self, name: str, **labels) -> int:
        return sum(h.count for h in self._matching_hists(name, labels))

    def hist_sum(self, name: str, **labels) -> float:
        return sum(h.sum for h in self._matching_hists(name, labels))

    def percentile(self, name: str, q: float, **labels) -> float:
        """Upper-edge percentile over the MERGED bucket counts of every
        series of `name` matching the (possibly partial) label set.
        Returns nan when no observations exist."""
        hists = [h for h in self._matching_hists(name, labels) if h.count]
        if not hists:
            return float("nan")
        total = sum(h.count for h in hists)
        rank = max(math.ceil(q / 100.0 * total), 1)
        edges = hists[0].edges
        nbuckets = len(edges) + 1
        cum = 0
        for i in range(nbuckets):
            cum += sum(h.counts[i] for h in hists)
            if cum >= rank:
                if i < len(edges):
                    return edges[i]
                return max(h.max for h in hists)  # unbounded tail bucket
        return max(h.max for h in hists)  # pragma: no cover — unreachable

    def summary(self, name: str, **labels) -> Dict[str, float]:
        """The p50/p99 view the SLO benchmarks consume."""
        return {
            "count": self.hist_count(name, **labels),
            "p50": self.percentile(name, 50, **labels),
            "p99": self.percentile(name, 99, **labels),
        }

    # -- exposition --------------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        return {
            "schema": SCHEMA,
            "counters": dict(sorted(self._counters.items())),
            "gauges": dict(sorted(self._gauges.items())),
            "histograms": {
                k: h.as_dict() for k, h in sorted(self._hists.items())
            },
        }

    def compact(self) -> Dict[str, float]:
        """Counters + gauges only (no bucket arrays) — the heartbeat-sized
        snapshot the supervisor reads for hang diagnosis."""
        out: Dict[str, float] = {}
        out.update(sorted(self._counters.items()))
        out.update(sorted(self._gauges.items()))
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4): counters, gauges, and
        cumulative `_bucket`/`_sum`/`_count` histogram series."""
        lines: List[str] = []
        seen_types: set = set()

        def _type(name: str, kind: str):
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} {kind}")

        def _fmt(v: float) -> str:
            return repr(int(v)) if float(v).is_integer() else repr(v)

        for key, v in sorted(self._counters.items()):
            _type(key.split("{", 1)[0], "counter")
            lines.append(f"{key} {_fmt(v)}")
        for key, v in sorted(self._gauges.items()):
            _type(key.split("{", 1)[0], "gauge")
            lines.append(f"{key} {_fmt(v)}")
        for key, h in sorted(self._hists.items()):
            name, _, rest = key.partition("{")
            inner = rest[:-1] if rest else ""
            _type(name, "histogram")
            cum = 0
            for i, e in enumerate(h.edges):
                cum += h.counts[i]
                le = f'le="{_fmt(e)}"'
                lab = f"{{{inner},{le}}}" if inner else f"{{{le}}}"
                lines.append(f"{name}_bucket{lab} {cum}")
            lab = f'{{{inner},le="+Inf"}}' if inner else '{le="+Inf"}'
            lines.append(f"{name}_bucket{lab} {h.count}")
            suffix = f"{{{inner}}}" if inner else ""
            lines.append(f"{name}_sum{suffix} {_fmt(h.sum)}")
            lines.append(f"{name}_count{suffix} {h.count}")
        return "\n".join(lines) + "\n"

    # -- persistence (atomic, via core.persist) ----------------------------

    def save(self, path: str | Path, fsync: bool = False) -> Path:
        from repro_torch.core.persist import atomic_write_json

        return atomic_write_json(Path(path), self.to_dict(), fsync=fsync,
                                 indent=1)

    def load(self, path: str | Path) -> None:
        """Replace this registry's contents with a saved payload."""
        import json

        d = json.loads(Path(path).read_text())
        if d.get("schema") != SCHEMA:
            raise ValueError(
                f"metrics payload schema {d.get('schema')!r} != {SCHEMA}"
            )
        self._counters = {k: float(v) for k, v in d["counters"].items()}
        self._gauges = {k: float(v) for k, v in d["gauges"].items()}
        self._hists = {
            k: _Histogram.from_dict(h) for k, h in d["histograms"].items()
        }
        self._hist_edges = {
            k.split("{", 1)[0]: h.edges for k, h in self._hists.items()
        }

    def clear(self) -> None:
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        self._hist_edges.clear()


__all__ = [
    "MetricsRegistry", "LATENCY_STEP_EDGES", "PER_TOKEN_EDGES", "SCHEMA",
]
