"""Phased operation traces — the paper's Figs. 10/11 workloads, in numpy.

Counterpart of part of src/repro/workloads/traces.py (:65-88, 210-287,
337-338): the `Trace` record, the paper's phase tables `TABLE2` and
`TABLE3`, the `phased_trace` generator and the bursty M/M/1 phase profile
`BURSTY_PHASES`.  The same seed gives the same arrays as the reference.  A
trace is exactly what `SmartPQ.run_window` takes: (K, B) op codes, keys and
vals, and the (K,) active-client count.  The reference's replay derives its
per-step random keys from `seed` with `jax.random`; the port takes its draws
as tensors instead (`SmartPQ.run_window`), so `seed` is only recorded here.
Saving, loading, replaying and the open-loop arrival processes are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np

from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT, OP_NOP
from repro_torch.core.pqueue.state import INF_KEY

_EMPTY = np.zeros(0, np.int32)


class Trace(NamedTuple):
    """A replayable op stream in `run_window` form (host numpy arrays);
    ``init_keys`` / ``init_vals`` are elements the recorded workload inserted
    before its first step."""

    ops: np.ndarray  # (K, B) int32 op codes (OP_NOP pads inactive lanes)
    keys: np.ndarray  # (K, B) int32 insert keys, INF for non-insert lanes
    vals: np.ndarray  # (K, B) int32 payloads
    num_clients: np.ndarray  # (K,) int32 active clients per step
    seed: int  # the reference replay's rng stream id
    init_keys: np.ndarray = _EMPTY
    init_vals: np.ndarray = _EMPTY

    @property
    def num_steps(self) -> int:
        return int(self.ops.shape[0])

    @property
    def width(self) -> int:
        return int(self.ops.shape[1])


# Paper Table 2: one feature varies per trace (num_clients, key_range and
# insert_frac pin the driving features; the size is emergent).
TABLE2: Dict[str, List[dict]] = {
    "a_keyrange": [  # vary key range (50 threads, 75-25 mix)
        dict(num_clients=50, key_range=100_000, insert_frac=0.75),
        dict(num_clients=50, key_range=2_000, insert_frac=0.75),
        dict(num_clients=50, key_range=1 << 20, insert_frac=0.75),
        dict(num_clients=50, key_range=10_000, insert_frac=0.75),
        dict(num_clients=50, key_range=50_000_000, insert_frac=0.75),
    ],
    "b_threads": [  # vary #threads (65-35 mix, range 20M)
        dict(num_clients=57, key_range=20_000_000, insert_frac=0.65),
        dict(num_clients=29, key_range=20_000_000, insert_frac=0.65),
        dict(num_clients=15, key_range=20_000_000, insert_frac=0.65),
        dict(num_clients=43, key_range=20_000_000, insert_frac=0.65),
        dict(num_clients=15, key_range=20_000_000, insert_frac=0.65),
    ],
    "c_mix": [  # vary op mix (22 threads, range 5M)
        dict(num_clients=22, key_range=5_000_000, insert_frac=0.5),
        dict(num_clients=22, key_range=5_000_000, insert_frac=1.0),
        dict(num_clients=22, key_range=5_000_000, insert_frac=0.3),
        dict(num_clients=22, key_range=5_000_000, insert_frac=1.0),
        dict(num_clients=22, key_range=5_000_000, insert_frac=0.0),
    ],
}

# Paper Table 3: several features vary at once (14 of the 15 phases).
TABLE3: List[dict] = [
    dict(num_clients=57, key_range=10_000_000, insert_frac=0.5),
    dict(num_clients=36, key_range=10_000_000, insert_frac=0.7),
    dict(num_clients=36, key_range=20_000_000, insert_frac=0.5),
    dict(num_clients=36, key_range=20_000_000, insert_frac=0.8),
    dict(num_clients=50, key_range=20_000_000, insert_frac=0.8),
    dict(num_clients=50, key_range=100_000_000, insert_frac=0.5),
    dict(num_clients=57, key_range=100_000_000, insert_frac=0.5),
    dict(num_clients=22, key_range=100_000_000, insert_frac=1.0),
    dict(num_clients=22, key_range=100_000_000, insert_frac=0.5),
    dict(num_clients=57, key_range=200_000_000, insert_frac=0.0),
    dict(num_clients=57, key_range=200_000_000, insert_frac=1.0),
    dict(num_clients=57, key_range=20_000_000, insert_frac=0.0),
    dict(num_clients=29, key_range=20_000_000, insert_frac=0.8),
    dict(num_clients=29, key_range=20_000_000, insert_frac=0.5),
]


def phased_trace(
    phases: Sequence[dict],
    steps_per_phase: int = 8,
    width: int | None = None,
    seed: int = 0,
) -> Trace:
    """Uniform-random op stream following a phase schedule: each phase dict
    pins (num_clients, key_range, insert_frac) for `steps_per_phase` steps.
    The lane width is max(num_clients) over the phases; a step with fewer
    clients pads its other lanes with OP_NOP."""
    B = width or max(int(p["num_clients"]) for p in phases)
    rng = np.random.default_rng(seed)
    K = len(phases) * steps_per_phase
    ops = np.full((K, B), OP_NOP, np.int32)
    keys = np.full((K, B), INF_KEY, np.int32)
    vals = np.zeros((K, B), np.int32)
    nc = np.zeros((K,), np.int32)
    t = 0
    for ph in phases:
        d = min(int(ph["num_clients"]), B)
        for _ in range(steps_per_phase):
            is_ins = rng.random(d) < float(ph["insert_frac"])
            ops[t, :d] = np.where(is_ins, OP_INSERT, OP_DELETE_MIN)
            k = rng.integers(
                0, max(int(ph["key_range"]), 1), d
            ).astype(np.int64)
            k = np.minimum(k, INF_KEY - 1).astype(np.int32)
            keys[t, :d] = np.where(is_ins, k, INF_KEY)
            vals[t, :d] = np.where(is_ins, k % 97, 0)
            nc[t] = d
            t += 1
    return Trace(ops=ops, keys=keys, vals=vals, num_clients=nc, seed=seed)


# The bursty M/M/1 phase profile (num_clients, arrival_frac, steps) and its
# short variant.
BURSTY_PHASES = ((512, 0.95, 30), (16, 0.6, 12), (64, 0.3, 12))
BURSTY_PHASES_QUICK = ((512, 0.95, 8), (16, 0.6, 4), (64, 0.3, 4))
