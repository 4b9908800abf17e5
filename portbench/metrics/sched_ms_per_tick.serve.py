"""Host milliseconds a scheduler tick takes: the harness's span around
each `SmartPQScheduler.tick_window` call (its K ticks' queue steps and its
one read of their outputs), summed over the timed window, per tick (the
window runs without the profiler)."""


def read(rec):
    return rec.get("sched_ms_per_tick") if rec.get("ticks") else None
