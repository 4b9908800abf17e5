"""Device calls a tick: the kernels, copies and sets the profiler's trace
holds inside the traced region (`harness.reduce_trace`'s
`device_calls`: the decode steps and the scheduler's windows of the traced
ticks), over the traced ticks.  The host issues each one, so while the
card waits on the host this counts what the eager step costs it."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("traced_ticks"):
        return None
    return tr["device_calls"] / rec["traced_ticks"]
