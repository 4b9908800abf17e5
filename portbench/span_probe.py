"""Readings of the program's spans and host-read counters in a serving
cell, on the card, one seed a process (the benchmark's own runs do not take
them).

    python3 portbench/span_probe.py --workload g8b-decode-4k --seed <n> \\
        --seconds 51 --tracing <traced|whole|off>

It runs the cell as `run.py` does, through `systems/serve.py`, and adds:

  traced   the engine's tracer on for the two traced windows alone, its
           clock anchored at the profiler's start and end; the run's own
           per-layer readings, those of `portbench.spans` from the same
           trace, idle by innermost program span, and the anchors' bound;
  whole    the tracer on from the engine's construction (the whole timed
           window), to read what tracing costs the end-to-end metrics;
  off      the tracer off, as `run.py` runs.

Every mode prints the end-to-end metrics and the host reads of the timed
window by site, per tick; after the card's run the scheduler's windows are
replayed on the CPU from the recorded arrivals, budgets and draws, and the
replay's reads by site over the same windows are printed beside the
card's.  The last line is one JSON object.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

from portbench import harness, spans  # noqa: E402


class Probe:
    """The hooks the probe lays over one run of `systems/serve.py`: the
    engine's tracer, each scheduler window's arrivals, budgets and reads,
    the counters at the timed window's edges, and the profiler's events."""

    def __init__(self, tracing: str, setup_windows: int):
        self.tracing = tracing
        self.setup_windows = setup_windows
        self.tracer = None
        self.windows = []  # (arrivals, budgets)
        self.timed = [None, None]  # site counts at the window's edges
        self.events = None

    def engine(self, engine):
        """`serve.run`'s `faults` hook: called with the new engine."""
        from repro_torch.utils import hostsync

        self.tracer = engine.obs.tracer
        self.tracer.enabled = self.tracing == "whole"
        inner = engine.scheduler.tick_window

        def tick_window(arrivals, budgets):
            if len(self.windows) == self.setup_windows:
                self.timed[0] = hostsync.site_counts()
            self.windows.append((
                [[dataclasses.replace(r) for r in reqs] for reqs in arrivals],
                list(budgets)))
            return inner(arrivals, budgets)

        engine.scheduler.tick_window = tick_window
        return engine

    def profiler(self):
        """`harness.new_profiler`, with the tracer switched on and anchored
        inside the profiled region (traced mode)."""
        self.close_window()
        prof = _new_profiler()
        return _Anchored(prof, self.tracer) if self.tracing == "traced" \
            else prof

    def close_window(self):
        """Read the counters at the timed window's end."""
        from repro_torch.utils import hostsync

        if self.timed[1] is None:
            self.timed[1] = hostsync.site_counts()
            self.timed_windows = len(self.windows) - self.setup_windows

    def trace_events(self, prof):
        self.events = _trace_events(getattr(prof, "prof", prof))
        return self.events


class _Anchored:
    """A profiler whose region holds the tracer, switched on, with its
    clock anchored at the region's start and end."""

    def __init__(self, prof, tracer):
        self.prof = prof
        self.tracer = tracer

    def __enter__(self):
        self.prof.__enter__()
        self.tracer.enabled = True
        self.tracer.anchor()
        return self

    def __exit__(self, *exc):
        self.tracer.anchor()
        self.tracer.enabled = False
        return self.prof.__exit__(*exc)


_new_profiler = harness.new_profiler
_trace_events = harness.trace_events


def replay_reads(system, cell, seed: int, windows, first: int, count: int,
                 device):
    """Host reads by site of scheduler windows [first, first + count) when
    the recorded windows run again on the CPU from the seed's draws (made
    on `device` by the cell's `system`, as the run made them)."""
    from repro_torch.serve.scheduler import SmartPQScheduler
    from repro_torch.utils import hostsync

    sc = cell["config_file"]["scheduler"]
    draws = system.sched_draws(sc, seed, device)
    sched = SmartPQScheduler(
        batch_size=sc["lanes"], seed=seed % 2**31, device="cpu",
        draws=tuple(d.cpu() for d in draws))
    before = None
    for i, (arrivals, budgets) in enumerate(windows[:first + count]):
        if i == first:
            before = hostsync.site_counts()
        sched.tick_window(arrivals, budgets)
    return _reads(before, hostsync.site_counts())


def _reads(before, after):
    """Reads by site between two `hostsync.site_counts()`."""
    return {k: v[0] - before.get(k, (0, 0.0))[0] for k, v in after.items()
            if v[0] != before.get(k, (0, 0.0))[0]}


def probe_run(run: harness.Run, tracing: str, bench: dict) -> dict:
    """One run of the cell under the probe's hooks (module docstring)."""
    cell, catalog = run.cell, run.catalog
    system = catalog.module("systems", cell["config_file"]["system"])
    K = cell["config_file"]["engine"]["sched_window"]
    warm = int(cell["mix"].get("warm_ticks", 0))
    probe = Probe(tracing, 1 + -(-warm // K))
    saved = harness.new_profiler, harness.trace_events
    harness.new_profiler = probe.profiler
    harness.trace_events = probe.trace_events
    try:
        out = system.run(run, faults=probe.engine)
    finally:
        harness.new_profiler, harness.trace_events = saved
    probe.close_window()
    ticks = out.record["ticks"]
    result = {"seed": run.seed, "tracing": tracing, "correct": out.correct,
              "e2e": out.e2e}
    result.update(spans.sync_metrics(*probe.timed, ticks))
    card = _reads(*probe.timed)
    result["reads_by_site"] = {k: v / ticks for k, v in sorted(card.items())}
    if run.trace:
        from repro_torch.obs.tracing import to_profiler_clock

        _, per = harness.cell_metrics(bench, cell["name"])
        result["per_layer"] = {
            m["name"]: catalog.module("metrics", m["name"]).read(out.record)
            for m in per}
        placed, bound = to_profiler_clock(probe.tracer.events, probe.events)
        red = spans.reduce_spans(probe.events, placed)
        result.update(spans.span_metrics(red))
        result["idle_other.serve"] = (100.0 * red["idle_s"]["other"]
                                      / red["window_s"])
        result["clock_bound_us"] = bound
        result["spans"] = sum(e.get("ph") == "X" for e in placed)
        print(spans.idle_line(red), flush=True)
    replay = replay_reads(system, cell, run.seed, probe.windows,
                          probe.setup_windows, probe.timed_windows,
                          run.device)
    sched_card = {k: v for k, v in card.items()
                  if k.startswith(spans.SCHED_SITES)}
    result["replay_matches"] = replay == sched_card
    result["replay_reads_by_site"] = {k: v / ticks
                                      for k, v in sorted(replay.items())}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracing", choices=("traced", "whole", "off"),
                    default="traced")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    harness.cache_env()
    harness.one_thread()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_probe: no CUDA device", file=sys.stderr)
        return 3
    print(f"[span_probe] card: {harness.card_line()}", flush=True)
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    catalog = harness.Catalog()
    run = harness.Run(cell=catalog.cell(args.workload), seed=args.seed,
                      seconds=args.seconds, trace=args.tracing == "traced",
                      device=torch.device("cuda", 0), t0=t0, catalog=catalog)
    print(json.dumps(probe_run(run, args.tracing, bench)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
