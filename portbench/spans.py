"""The program's own spans and host-read counters, read against the
profiler's trace.

The port's tracer (`repro_torch.obs.tracing.Tracer`) records spans at its
layers' boundaries on its own clock; in a profiled region it anchors that
clock in the trace (`Tracer.anchor`), and `to_profiler_clock` places every
span on the trace's timeline.  The spans are not `record_function` ranges,
so `harness.reduce_trace` and the readers of its ranges read what they
read without them.  Over the traced region (the `harness.TRACED` range):

  idle by program span   each gap with no device call running, filed
                         under the innermost program span over its middle
                         (as `reduce_trace` files it under the innermost
                         range and host op);
  idle_sched             the share of the window idle inside
                         ``sched.window`` (the scheduler's window);
  idle_decode            inside ``model.decode_step`` (host issue of the
                         eager step lagging the card);
  idle_engine            inside ``engine.step`` but outside the two above
                         (the engine's admission, read and bookkeeping);
                         what is left of `idle.serve` lies outside them;
  attn_share_span        device time of the calls launched inside
                         ``model.attend`` over that of the calls launched
                         inside ``model.decode_step``.

And from `repro_torch.utils.hostsync.SITES` read before and after a window
of ticks: host reads per tick, and the host milliseconds per tick spent
blocked in the reads of the scheduler's sites (`SCHED_SITES`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench import harness

# Sites of the host reads made inside a scheduler window: its one read of
# the window's outputs, and those of the queue's steps.
SCHED_SITES = ("sched.", "smartpq.", "ops.", "local.", "schedules.")


def _inside(spans, name: str, points) -> List[bool]:
    """Whether each point lies inside a span named `name`."""
    iv = [(a, b, n) for a, b, n in spans if n == name]
    return [x is not None for x in harness.innermost(iv, points)]


def reduce_spans(events: List[dict], spans: List[dict]) -> Optional[dict]:
    """Idle time and device time of a traced region by program span.
    `events` are the profiler's complete ('X') events, `spans` the
    tracer's, on the profiler's clock.  None when the trace holds no
    traced range."""
    region = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == harness.TRACED]
    if not region:
        return None
    r0 = float(region[0]["ts"])
    r1 = r0 + float(region[0]["dur"])
    iv = [(float(s["ts"]), float(s["ts"]) + float(s["dur"]), s["name"])
          for s in spans if s.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in harness.DEVICE_CATS
           and r0 <= float(e["ts"]) < r1]
    busy = harness._merge((max(float(e["ts"]), r0),
                           min(float(e["ts"]) + float(e["dur"]), r1))
                          for e in dev)
    gaps, t = [], r0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if r1 > t:
        gaps.append((t, r1))
    mids = [0.5 * (a + b) for a, b in gaps]
    in_sched = _inside(iv, "sched.window", mids)
    in_decode = _inside(iv, "model.decode_step", mids)
    in_step = _inside(iv, "engine.step", mids)
    by_span: Dict[str, float] = {}
    idle = {"sched": 0.0, "decode": 0.0, "engine": 0.0, "other": 0.0}
    for (a, b), name, s, d, e in zip(gaps, harness.innermost(iv, mids),
                                     in_sched, in_decode, in_step):
        name = name or "outside program spans"
        by_span[name] = by_span.get(name, 0.0) + (b - a)
        where = ("sched" if s else "decode" if d else "engine" if e
                 else "other")
        idle[where] += b - a

    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    at = [launched.get(e.get("args", {}).get("correlation"), -1.0)
          for e in dev]
    dur = [float(e["dur"]) for e in dev]
    attend = sum(d for d, x in zip(dur, _inside(iv, "model.attend", at)) if x)
    step = sum(d for d, x in zip(dur, _inside(iv, "model.decode_step", at))
               if x)
    return {
        "window_s": (r1 - r0) / 1e6,
        "idle_s": {k: v / 1e6 for k, v in idle.items()},
        "idle_by_span": {k: v / 1e6 for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "attend_dev_s": attend / 1e6,
        "decode_dev_s": step / 1e6,
    }


def span_metrics(red: dict) -> Dict[str, float]:
    """The shares `reduce_spans` gives, in percent, by metric name."""
    out = {f"idle_{k}.serve": 100.0 * red["idle_s"][k] / red["window_s"]
           for k in ("sched", "decode", "engine")}
    if red["decode_dev_s"] > 0:
        out["attn_share_span.serve"] = (100.0 * red["attend_dev_s"]
                                        / red["decode_dev_s"])
    return out


def idle_line(red: dict) -> str:
    """Idle milliseconds of the traced window by innermost program span."""
    parts = ", ".join(f"{k} {1e3 * v:.3f}"
                      for k, v in red["idle_by_span"].items())
    return (f"[portbench] idle by program span (ms of "
            f"{1e3 * red['window_s']:.3f}): {parts}")


def sync_metrics(before: Dict[str, list], after: Dict[str, list],
                 ticks: int) -> Dict[str, float]:
    """Host reads per tick, and host ms per tick blocked in the scheduler's
    sites, between two readings of `hostsync.site_counts()`."""
    delta = {k: [v[0] - before.get(k, (0, 0.0))[0],
                 v[1] - before.get(k, (0, 0.0))[1]]
             for k, v in after.items()}
    sched_s = sum(v[1] for k, v in delta.items() if k.startswith(SCHED_SITES))
    return {
        "syncs_per_tick.serve": sum(v[0] for v in delta.values()) / ticks,
        "sched_sync_ms_per_tick.serve": 1e3 * sched_s / ticks,
    }
