"""Profiling hook on `torch.profiler`.

Counterpart of src/repro/obs/profiling.py:

  trace_session(dir, tracer)  a `torch.profiler.profile` over the CPU and,
                        where there is a card, CUDA activities, writing a
                        Chrome trace into `dir` when it ends; `None` -> a
                        no-op nullcontext, so call sites wrap
                        unconditionally.  With an enabled `tracer` the
                        session anchors the tracer's clock at its start and
                        end, and the file also holds the tracer's events on
                        the profiler's clock, as a process of their own
                        (pid 0, named "program spans"), so one timeline
                        shows the host spans above the device's rows.

`torch.profiler` ships with torch, so the hook has no silent fallback.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import ContextManager, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.obs.tracing import Tracer, to_profiler_clock

# The name a merged trace gives the process of the tracer's events (the
# tracer's own pid, 0).
SPANS_PROCESS = "program spans"


def merge_spans(trace_path: Path, tracer: Tracer) -> None:
    """Add `tracer`'s events, on the clock of the profiler's trace at
    `trace_path`, to that file (module docstring)."""
    trace = json.loads(trace_path.read_text())
    events, _ = to_profiler_clock(tracer.events, trace["traceEvents"])
    trace["traceEvents"].append({"ph": "M", "name": "process_name",
                                 "pid": 0, "tid": 0,
                                 "args": {"name": SPANS_PROCESS}})
    trace["traceEvents"].extend(events)
    trace_path.write_text(json.dumps(trace))


@contextlib.contextmanager
def _session(dump_dir: Path, tracer: Optional[Tracer]) -> Iterator[profile]:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    spans = tracer is not None and tracer.enabled
    prof = profile(activities=activities)
    with prof:
        if spans:
            tracer.anchor()
        yield prof
        if spans:
            tracer.anchor()
    dump_dir.mkdir(parents=True, exist_ok=True)
    path = dump_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    if spans:
        merge_spans(path, tracer)


def trace_session(dump_dir: Optional[str],
                  tracer: Optional[Tracer] = None) -> ContextManager[object]:
    """A profiler session writing a Chrome trace under `dump_dir` when it
    ends, with `tracer`'s events merged in when it is enabled; a no-op
    when `dump_dir` is None (the default serving configuration)."""
    if dump_dir is None:
        return contextlib.nullcontext()
    return _session(Path(dump_dir), tracer)


__all__ = ["trace_session", "merge_spans", "SPANS_PROCESS"]
