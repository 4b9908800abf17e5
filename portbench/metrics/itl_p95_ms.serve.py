"""The 95th percentile of every gap between two consecutive tokens of one
request inside the timed window, on the host clock (the window runs
without the profiler)."""

import math


def read(rec):
    v = rec.get("itl_p95_ms")
    return v if v is not None and math.isfinite(v) else None
