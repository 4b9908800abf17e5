"""Share of slot-ticks in the timed window that decoded a token for an
active request (`ServeEngine.active`), over every slot of every tick (the
window runs without the profiler)."""


def read(rec):
    return rec.get("occupancy") if rec.get("ticks") else None
