"""An offline backlog of requests, all queued at t = 0 (so every slot is
busy all window and no rate is swept): `requests` requests, each with
`max_new_tokens` and `prompt_len` geometric on 1, 2, ... with the mix's
means (a constant stop hazard a token), clipped to the mix's maxima, and
the SLO class uniform over `slo_classes` classes.  Every seed gets the
same set of lengths and classes (the distribution's quantiles at the midpoints of `n`
equal steps) in its own order, so a seed changes the order of the work
and not its amount.  The cell decodes
`warm_ticks` ticks in set-up before its window opens, so the contexts in
the window are the backlog's steady state and not a cold start.
"""

import numpy as np


def _geometric(rng, spec: dict, n: int) -> np.ndarray:
    """The geometric quantiles at (i + 1/2) / n, clipped, in the order of
    a permutation drawn from `rng`."""
    u = (np.arange(n) + 0.5) / n
    k = np.ceil(np.log1p(-u) / np.log1p(-1.0 / float(spec["mean"])))
    k = np.clip(k, 1, int(spec["max"])).astype(np.int64)
    return k[rng.permutation(n)]


def requests(mix: dict, seed: int):
    """[(uid, prompt_len, max_new_tokens, slo_class)] in uid order."""
    rng = np.random.default_rng([seed % 2**63, 0x5E12E])
    n = int(mix["requests"])
    new = _geometric(rng, mix["max_new_tokens"], n)
    plen = _geometric(rng, mix["prompt_len"], n)
    slo = (np.arange(n) % int(mix["slo_classes"]))[rng.permutation(n)]
    return [(i, int(plen[i]), int(new[i]), int(slo[i])) for i in range(n)]
