"""Share of the decode step's device time spent under the harness's range
around `attend_chunked` (the attention over the cache)."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    lab = tr["device_s_by_label"]
    attn = lab.get("serve.attention", 0.0)
    step = lab.get("serve.decode", 0.0) + attn
    return 100.0 * attn / step if attn > 0 else None
