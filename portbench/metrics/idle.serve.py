"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of device calls against the window's length)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
