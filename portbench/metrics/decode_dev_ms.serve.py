"""Device milliseconds of one decode step: the profiler's kernel time
under the harness's ranges around `Model.decode_step` (attention
included), over the traced ticks."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not rec.get("traced_ticks"):
        return None
    lab = tr["device_s_by_label"]
    s = lab.get("serve.decode", 0.0) + lab.get("serve.attention", 0.0)
    return 1e3 * s / rec["traced_ticks"] if s > 0 else None
