"""Tokens the timed window's ticks emitted over its seconds on the host
clock (the window runs without the profiler).  The host's pace sets it
while the card waits on the host's issue of the step."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec.get("tokens") else None
