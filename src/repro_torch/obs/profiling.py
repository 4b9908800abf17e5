"""Profiling hooks on `torch.profiler`.

Counterpart of src/repro/obs/profiling.py:

  annotate(name)        a `torch.profiler.record_function` range: labels
                        the enclosing host region in the profiler's
                        timeline, with the device calls it issues under it.
  trace_session(dir)    a `torch.profiler.profile` over the CPU and, where
                        there is a card, CUDA activities, writing a Chrome
                        trace into `dir` when it ends; `None` -> a no-op
                        nullcontext, so call sites wrap unconditionally.

`torch.profiler` ships with torch, so neither hook has a silent fallback.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import ContextManager, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def annotate(name: str) -> ContextManager[None]:
    """A `torch.profiler.record_function` range named `name`."""
    return record_function(name)


@contextlib.contextmanager
def _session(dump_dir: Path) -> Iterator[profile]:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with prof:
        yield prof
    dump_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(
        dump_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def trace_session(dump_dir: Optional[str]) -> ContextManager[object]:
    """A profiler session writing a Chrome trace under `dump_dir` when it
    ends; a no-op when `dump_dir` is None (the default serving
    configuration)."""
    if dump_dir is None:
        return contextlib.nullcontext()
    return _session(Path(dump_dir))


__all__ = ["annotate", "trace_session"]
