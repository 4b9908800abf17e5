"""Model FLOPs of the tokens the timed window emitted, each at its own
valid context (`portbench.costs.dense_token_flops` from the
configuration's sizes), over the window's seconds and the card's bf16
peak of 989 TFLOP/s.  The window runs without the profiler (the traced
run's trace covers two windows after it), so its cost is not the
model's."""


def read(rec):
    return rec.get("mfu") if rec.get("tokens") else None
