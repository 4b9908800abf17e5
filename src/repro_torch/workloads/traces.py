"""Operation traces: record, save, load, replay and generate, in PyTorch.

Counterpart of src/repro/workloads/traces.py.  A `Trace` is an
application-shaped op stream in exactly the form `SmartPQ.run_window`
takes: (K, B) op codes (`OP_NOP` pads inactive lanes), insert keys and
vals, the (K,) active-client count, the seed of its random stream, and the
elements its recording driver inserted before its first step.  So

    carry, res = replay(pq, trace)

is one `run_window` call, and the same trace replayed twice (or saved,
loaded and replayed) with the same draws gives identical outputs, mode
trace and carry.  Traces come from the recorders (`sssp.run_sssp_smartpq`
and `des.run_hold_model` with ``record=True``), from the phased generators
here (the insert/delete square wave, the size ramp, the mix drift and the
bursty DES arrivals) and from the paper's phase tables `TABLE2`/`TABLE3`.

Randomness: the reference's replay derives its per-step `jax.random` keys
from ``trace.seed`` (traces.py:88-91), a stream torch cannot reproduce
cheaply.  `replay` takes the per-step draws as tensors (``draws=``, as
`run_window` does) or draws from a `torch.Generator`, by default one seeded
with ``trace.seed``.

The serving tier's open-loop request streams (`open_loop_requests`,
`bursty_serve_workload`) turn arrival counts into the scheduler's `Request`
lists.  A damaged trace bumps ``errors_total{code=TRACE_CORRUPT}`` in the
process-wide metrics (`obs.get_default()`) before `TraceCorruptError` is
raised.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.errors import TraceCorruptError
from repro_torch.core.pqueue import ops as O
from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT, OP_NOP
from repro_torch.core.pqueue.state import INF_KEY, PQState
from repro_torch.core.persist import atomic_savez
from repro_torch.kernels.ops import MAX_MERGE_WINDOW
from repro_torch.obs import get_default
from repro_torch.utils.hostsync import host_int


def _int32_on(a, device) -> torch.Tensor:
    """A numpy array (copied: a loaded npz is read-only) or a tensor, as
    int32 on `device`."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.array(a, np.int32))
    return a.to(device=device, dtype=torch.int32)


def prefill(state: PQState, keys, vals) -> PQState:
    """Insert `keys`/`vals` (numpy or tensors, cast to int32) through the
    queue's own insert path — every driver's pre-fill.  The reference does
    it in one insert (traces.py:47-60); the card's merge takes a head row
    and a run of at most `MAX_MERGE_WINDOW` words, so here the keys go in
    slices of ``MAX_MERGE_WINDOW - H``: one insert, bit-equal to the
    reference's, for up to that many keys, and the same multiset above.
    Raises when the queue drops a key."""
    dev = state.device
    keys, vals = _int32_on(keys, dev), _int32_on(vals, dev)
    width = MAX_MERGE_WINDOW - state.head_width
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for lo in range(0, keys.shape[0], width):
        state, lost = O.insert(state, keys[lo:lo + width],
                               vals[lo:lo + width])
        dropped = dropped + lost.sum(dtype=torch.int32)
    n_dropped = host_int(dropped)
    if n_dropped:
        raise ValueError(
            f"prefill dropped {n_dropped} of {keys.shape[0]} keys: the queue "
            f"({state.num_shards} shards of {state.capacity}) is too small"
        )
    return state


_EMPTY = np.zeros(0, np.int32)


class Trace(NamedTuple):
    """A replayable op stream in `run_window` form (host numpy arrays);
    ``init_keys`` / ``init_vals`` are elements the recorded workload inserted
    before its first step."""

    ops: np.ndarray  # (K, B) int32 op codes (OP_NOP pads inactive lanes)
    keys: np.ndarray  # (K, B) int32 insert keys, INF for non-insert lanes
    vals: np.ndarray  # (K, B) int32 payloads
    num_clients: np.ndarray  # (K,) int32 active clients per step
    seed: int  # rng stream id of the replay's draws
    init_keys: np.ndarray = _EMPTY  # pre-fill before step 0
    init_vals: np.ndarray = _EMPTY

    @property
    def num_steps(self) -> int:
        return int(self.ops.shape[0])

    @property
    def width(self) -> int:
        return int(self.ops.shape[1])


def save_trace(path, trace: Trace) -> None:
    """Persist to the npz interchange format (int32 throughout), atomically
    (`core.persist.atomic_savez`): a crash mid-save leaves the previous
    trace or none.  The reference's loader reads it, and this one reads the
    reference's."""
    atomic_savez(
        path, compressed=True,
        ops=trace.ops.astype(np.int32),
        keys=trace.keys.astype(np.int32), vals=trace.vals.astype(np.int32),
        num_clients=trace.num_clients.astype(np.int32),
        seed=np.int64(trace.seed),
        init_keys=trace.init_keys.astype(np.int32),
        init_vals=trace.init_vals.astype(np.int32),
    )


def load_trace(path) -> Trace:
    """Load and validate an npz trace.  A damaged file (truncation, flipped
    bytes, missing arrays) raises `TraceCorruptError`; a half-loaded trace
    is never returned."""
    try:
        with np.load(Path(path)) as z:
            trace = Trace(
                ops=z["ops"], keys=z["keys"], vals=z["vals"],
                num_clients=z["num_clients"], seed=int(z["seed"]),
                init_keys=z["init_keys"], init_vals=z["init_vals"],
            )
    except Exception as e:  # zipfile/np errors are implementation details
        get_default().metrics.inc("errors_total", code="TRACE_CORRUPT")
        raise TraceCorruptError(
            f"unreadable npz ({type(e).__name__}: {e})", path=str(path)
        ) from e
    validate_trace(trace, path=str(path))
    return trace


def validate_trace(trace: Trace, path: str | None = None) -> Trace:
    """Structural validation: consistent (K, B) shapes, integral op codes
    in {INSERT, DELETE_MIN, NOP}, matched pre-fill arrays.  Raises
    `TraceCorruptError`."""

    def bad(detail: str):
        get_default().metrics.inc("errors_total", code="TRACE_CORRUPT")
        raise TraceCorruptError(detail, path=path)

    ops = np.asarray(trace.ops)
    if ops.ndim != 2:
        bad(f"ops must be (K, B); got shape {ops.shape}")
    if not np.issubdtype(ops.dtype, np.integer):
        bad(f"ops dtype must be integral; got {ops.dtype}")
    for name in ("keys", "vals"):
        arr = np.asarray(getattr(trace, name))
        if arr.shape != ops.shape:
            bad(f"{name} shape {arr.shape} != ops shape {ops.shape}")
    nc = np.asarray(trace.num_clients)
    if nc.shape != (ops.shape[0],):
        bad(f"num_clients shape {nc.shape} != ({ops.shape[0]},)")
    legal = np.isin(ops, (OP_INSERT, OP_DELETE_MIN, OP_NOP))
    if not legal.all():
        t, b = np.argwhere(~legal)[0]
        bad(f"illegal op code {int(ops[t, b])} at step {int(t)} lane "
            f"{int(b)}")
    if np.asarray(trace.init_keys).shape != np.asarray(
        trace.init_vals
    ).shape:
        bad("init_keys / init_vals length mismatch")
    return trace


def replay(pq, trace: Trace, carry=None, draws=None, generator=None):
    """Replay the whole trace through one `run_window` call on the queue's
    device.  `carry` defaults to a fresh `pq.init()` pre-filled with the
    trace's ``init_keys`` (the recording driver's starting state).  `draws`
    are the window's per-step draws, as `run_window` takes them; without
    them they come from `generator`, by default a `torch.Generator` on the
    queue's device seeded with ``trace.seed``.  With ``pq.config.validate``
    the carry then goes through `validate_carry`.  Returns (carry,
    WindowResult)."""
    dev = pq.device
    if carry is None:
        carry = pq.init()
        if trace.init_keys.size:
            carry = carry._replace(
                state=prefill(carry.state, trace.init_keys, trace.init_vals)
            )
    if draws is None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(trace.seed))
    if draws is not None:
        draws = tuple(d.to(dev) for d in draws)
    keys = np.asarray(trace.keys)
    if keys.dtype.kind == "f":
        # a float batch, as recorded: the window's admission check rejects
        # its non-finite keys (`ops.sanitize_keys`)
        keys = torch.as_tensor(np.array(keys, np.float32), device=dev)
    else:
        keys = _int32_on(keys, dev)
    carry, res = pq.run_window(
        carry, _int32_on(trace.ops, dev), keys, _int32_on(trace.vals, dev),
        draws=draws, num_clients=_int32_on(trace.num_clients, dev),
        generator=generator,
    )
    if pq.config.validate:
        pq.validate_carry(carry)
    return carry, res


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


def phase_flip_trace(
    B: int = 64, steps_per_phase: int = 12, n_flips: int = 4,
    key_range: int = 1 << 14, seed: int = 0,
) -> Trace:
    """Insert-storm / delete-storm square wave: each flip inverts the op
    mix edge to edge, the worst case for a sticky mode."""
    phases = [
        dict(num_clients=B, key_range=key_range,
             insert_frac=0.95 if i % 2 == 0 else 0.05)
        for i in range(n_flips)
    ]
    return phased_trace(phases, steps_per_phase=steps_per_phase, seed=seed)


def size_ramp_trace(
    B: int = 64, steps_per_phase: int = 10, key_range: int = 1 << 14,
    seed: int = 0,
) -> Trace:
    """Queue-size ramp: insert-only growth, a mixed plateau, then a
    delete-only drain — the Size feature across its range."""
    phases = [
        dict(num_clients=B, key_range=key_range, insert_frac=1.0),
        dict(num_clients=B, key_range=key_range, insert_frac=1.0),
        dict(num_clients=B, key_range=key_range, insert_frac=0.5),
        dict(num_clients=B, key_range=key_range, insert_frac=0.0),
        dict(num_clients=B, key_range=key_range, insert_frac=0.0),
    ]
    return phased_trace(phases, steps_per_phase=steps_per_phase, seed=seed)


def mix_drift_trace(
    B: int = 64, steps: int = 48, key_range: int = 1 << 14, seed: int = 0,
) -> Trace:
    """Gradual mix drift 0.9 -> 0.1, with no phase edge at all."""
    phases = [
        dict(num_clients=B, key_range=key_range,
             insert_frac=0.9 - 0.8 * t / max(steps - 1, 1))
        for t in range(steps)
    ]
    return phased_trace(phases, steps_per_phase=1, seed=seed)


# ---------------------------------------------------------------------------
# open-loop arrival processes (the serving tier's request streams)
# ---------------------------------------------------------------------------


def _hash_u32(x: np.ndarray, salt: int) -> np.ndarray:
    """splitmix32-style avalanche hash: uid -> iid uniform uint32."""
    salted = (salt * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = (np.asarray(x, np.uint64) + np.uint64(salted)) \
        & np.uint64(0xFFFFFFFF)
    z = (z ^ (z >> np.uint64(16))) * np.uint64(0x85EBCA6B) \
        & np.uint64(0xFFFFFFFF)
    z = (z ^ (z >> np.uint64(13))) * np.uint64(0xC2B2AE35) \
        & np.uint64(0xFFFFFFFF)
    return (z ^ (z >> np.uint64(16))).astype(np.uint32)


def poisson_arrival_counts(
    steps: int, rate: float, seed: int = 0
) -> np.ndarray:
    """Open-loop Poisson arrivals: iid per-step counts at `rate`."""
    return np.random.default_rng(seed).poisson(
        rate, steps
    ).astype(np.int32)


def mmpp_arrival_counts(
    steps: int,
    rates: Sequence[float] = (12.0, 0.5),
    mean_dwell: Sequence[float] = (16.0, 32.0),
    seed: int = 0,
) -> np.ndarray:
    """Markov-modulated Poisson arrivals (bursty open-loop load): a hidden
    chain over `len(rates)` states emits Poisson counts at its state's rate
    and moves on with probability 1/mean_dwell[state] per step."""
    rng = np.random.default_rng(seed)
    counts = np.zeros(steps, np.int32)
    state = 0
    for t in range(steps):
        counts[t] = rng.poisson(rates[state])
        if rng.random() < 1.0 / float(mean_dwell[state]):
            state = (state + 1) % len(rates)
    return counts


def open_loop_requests(
    counts: np.ndarray,
    seed: int = 0,
    uid_base: int = 0,
    slo_weights: Sequence[float] = (0.25, 0.5, 0.25),
    prompt_range: tuple = (4, 64),
    new_tokens_range: tuple = (2, 16),
):
    """Per-step serving `Request` lists from arrival counts: step t holds
    `counts[t]` requests.  uids are consecutive from `uid_base`, and every
    attribute derives from `_hash_u32(uid, seed*salt)`: slo_class from
    `slo_weights`, prompt length and decode budget uniform over their
    ranges (src/repro/workloads/traces.py:401-441)."""
    from repro_torch.serve.scheduler import Request  # serve dep call-local

    cum = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
    total = int(cum[-1])
    uids = uid_base + np.arange(total, dtype=np.int64)
    cw = np.cumsum(np.asarray(slo_weights, np.float64))
    cw = cw / cw[-1]
    u_slo = _hash_u32(uids, seed * 3 + 1).astype(np.float64) / 2**32
    slo = np.searchsorted(cw, u_slo, side="right").astype(np.int64)
    plo, phi = prompt_range
    prompt = plo + _hash_u32(uids, seed * 3 + 2) % max(phi - plo, 1)
    tlo, thi = new_tokens_range
    ntok = tlo + _hash_u32(uids, seed * 3 + 3) % max(thi - tlo, 1)
    workload = []
    for t in range(len(counts)):
        lo, hi = int(cum[t]), int(cum[t + 1])
        workload.append([
            Request(
                uid=int(uids[i]), prompt_len=int(prompt[i]),
                max_new_tokens=int(ntok[i]), slo_class=int(slo[i]),
                arrival_step=t,
            )
            for i in range(lo, hi)
        ])
    return workload


def bursty_serve_workload(
    steps: int = 64,
    rates: Sequence[float] = (12.0, 0.5),
    mean_dwell: Sequence[float] = (16.0, 32.0),
    seed: int = 0,
):
    """The serve_slo benchmark's open-loop bursty trace: MMPP arrival counts
    through the stateless request stream."""
    return open_loop_requests(
        mmpp_arrival_counts(steps, rates, mean_dwell, seed=seed), seed=seed
    )


def bursty_des_trace(
    B: int = 128,
    phases: Sequence[tuple] = BURSTY_PHASES,
    mean_interarrival: int = 3,
    seed: int = 0,
) -> Trace:
    """Bursty M/M/1-style discrete-event arrival process, pregenerated so
    the whole event loop runs inside one `run_window`.  Event keys are
    absolute arrival times on a shared exponential clock, so the queue
    rides the burst: arrival-heavy phases grow it, service-heavy ones
    drain it.  Each phase is (num_clients, arrival_frac, steps)."""
    rng = np.random.default_rng(seed)
    K = sum(int(p[2]) for p in phases)
    ops = np.full((K, B), OP_NOP, np.int32)
    keys = np.full((K, B), INF_KEY, np.int32)
    vals = np.zeros((K, B), np.int32)
    nc = np.zeros((K,), np.int32)
    clock = 0.0
    t = 0
    for num_clients, arrival_frac, steps in phases:
        for _ in range(int(steps)):
            n_arr = int(round(arrival_frac * B))
            n_srv = B - n_arr
            ia = rng.exponential(mean_interarrival, n_arr)
            times = clock + np.cumsum(ia)
            clock = float(times[-1]) if n_arr else clock
            ops[t, :n_arr] = OP_INSERT
            keys[t, :n_arr] = np.minimum(times, INF_KEY - 1).astype(np.int32)
            vals[t, :n_arr] = np.arange(n_arr, dtype=np.int32)
            ops[t, n_arr : n_arr + n_srv] = OP_DELETE_MIN
            nc[t] = num_clients
            t += 1
    return Trace(ops=ops, keys=keys, vals=vals, num_clients=nc, seed=seed)
