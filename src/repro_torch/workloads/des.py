"""Discrete-event-simulation drivers over the adaptive PQ, in PyTorch.

Counterpart of src/repro/workloads/des.py, whose docstring gives the
design: the classic hold model (Vaucher & Duval's PQ benchmark), where each
of B servers holds its current event for a random time and reschedules it
— pop the B most imminent events, insert B future ones at ``popped time +
hold``.  The insert keys depend on the popped keys, so the stream cannot be
pregenerated: the event loop drives `SmartPQ.step` itself, pipelined by one
step (step t inserts the events step t-1 popped).  The bursty M/M/1 variant
is a pregenerated stream (`traces.bursty_des_trace`) replayed through one
`run_window`.

With an exact schedule pinned, the per-step popped times equal
`hold_model_oracle`, a host `heapq` simulation of the same linearization.

Randomness: the hold times and initial events come from `np.random` as in
the reference; the schedules' draws are `SmartPQ.step`'s, passed as
tensors with a leading step axis (``draws=``) or drawn from `generator` (by
default a `torch.Generator` on the queue's device seeded with `seed`).
"""

from __future__ import annotations

import heapq
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.pqueue import schedules as SCH
from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT, OP_NOP
from repro_torch.core.pqueue.state import INF_KEY, make_state
from repro_torch.workloads.traces import Trace, prefill


class DESResult(NamedTuple):
    popped: np.ndarray  # (K, B) per-step event times, ascending, INF-padded
    n_out: np.ndarray  # (K,)
    modes: np.ndarray  # (K,) mode trace
    transitions: int
    events: int  # total events served
    final_size: int  # events still queued after the horizon
    trace: Optional[Trace] = None  # with record=True


def sample_holds(
    K: int, B: int, mean_hold: int = 64, seed: int = 0
) -> np.ndarray:
    """Quantized-exponential hold times >= 1 (the hold model's service
    distribution), shared by the driver and the heapq oracle."""
    rng = np.random.default_rng(seed)
    return np.maximum(
        rng.exponential(mean_hold, (K, B)).astype(np.int32), 1
    )


def initial_events(
    n_init: int, mean_hold: int = 64, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, max(mean_hold, 2), n_init).astype(np.int32)


def make_hold_engine(
    pq,  # SmartPQ (pin mode_schedules to one exact schedule for the oracle)
    B: int = 32,
    K: int = 64,
    num_clients: int | None = None,
):
    """Hold-model engine of K steps on the queue's device.  Step t inserts
    the events step t-1 popped, rescheduled at ``popped + holds[t]``, and
    pops the B most imminent; step 0 pops from the ``n_init`` (default 4B)
    pre-filled initial events.  The batch is 2B lanes wide (B inserts, B
    deleteMins), so the head tier needs H >= 2B.  Returns
    ``run(seed, mean_hold, n_init, record, draws=None, generator=None)``."""
    if num_clients is None:
        num_clients = B
    dev = pq.device
    i32 = dict(dtype=torch.int32, device=dev)
    lane = torch.arange(B, **i32)
    del_ops = torch.full((B,), OP_DELETE_MIN, **i32)
    del_keys = torch.full((B,), INF_KEY, **i32)
    del_vals = torch.zeros((B,), **i32)
    op_insert = torch.tensor(OP_INSERT, **i32)
    op_nop = torch.tensor(OP_NOP, **i32)
    nc = torch.tensor(num_clients, **i32)

    def run(seed: int = 0, mean_hold: int = 64, n_init: int | None = None,
            record: bool = False, draws=None,
            generator: Optional[torch.Generator] = None) -> DESResult:
        if n_init is None:
            n_init = 4 * B
        c = pq.config
        holds = torch.as_tensor(sample_holds(K, B, mean_hold, seed),
                                device=dev)
        init_k = initial_events(n_init, mean_hold, seed)
        init_v = np.arange(n_init, dtype=np.int32)
        st = make_state(c.num_shards, c.capacity, head_width=c.head_width,
                        device=dev)
        st = prefill(st, init_k, init_v)
        pqc = pq.init()._replace(state=st)
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(seed)
            draws = SCH.step_draws(c.mode_schedules, st.num_shards, 2 * B,
                                   st.head_width, steps=K,
                                   generator=generator, device=dev)
        else:
            draws = tuple(d.to(dev) for d in draws)
        prev_k = torch.full((B,), INF_KEY, **i32)
        prev_n = torch.zeros((), **i32)
        out_k, out_n, out_m, log = [], [], [], ([], [], [])
        for t in range(K):
            valid = lane < prev_n
            ins_k = torch.where(
                valid, torch.where(valid, prev_k, 0) + holds[t], INF_KEY)
            ops = torch.cat([torch.where(valid, op_insert, op_nop), del_ops])
            keys = torch.cat([ins_k, del_keys])
            vals = torch.cat([lane, del_vals])
            pqc, res = pq.step(
                pqc, ops, keys, vals,
                draws=None if draws is None else tuple(d[t] for d in draws),
                num_clients=nc)
            prev_k, prev_n = res.keys[:B], torch.clamp(res.n_out, max=B)
            out_k.append(prev_k)
            out_n.append(prev_n)
            out_m.append(pqc.stats.mode)
            if record:
                for x, lst in zip((ops, keys, vals), log):
                    lst.append(x)
        n_out = torch.stack(out_n).cpu().numpy()
        trace = None
        if record:
            trace = Trace(
                *(torch.stack(lst).cpu().numpy() for lst in log),
                num_clients=np.full((K,), num_clients, np.int32), seed=seed,
                init_keys=init_k, init_vals=init_v,
            )
        return DESResult(
            popped=torch.stack(out_k).cpu().numpy(), n_out=n_out,
            modes=torch.stack(out_m).cpu().numpy(),
            transitions=int(pqc.stats.transitions),
            events=int(np.sum(n_out)),
            final_size=int(pqc.state.total_size), trace=trace,
        )

    return run


def run_hold_model(
    pq,
    B: int = 32,
    K: int = 64,
    mean_hold: int = 64,
    seed: int = 0,
    num_clients: int | None = None,
    n_init: int | None = None,
    record: bool = False,
    draws=None,
    generator: Optional[torch.Generator] = None,
) -> DESResult:
    """One-shot hold-model run (see `make_hold_engine`)."""
    run = make_hold_engine(pq, B=B, K=K, num_clients=num_clients)
    return run(seed=seed, mean_hold=mean_hold, n_init=n_init, record=record,
               draws=draws, generator=generator)


def hold_model_oracle(
    B: int, K: int, mean_hold: int = 64, seed: int = 0,
    n_init: int | None = None,
) -> list:
    """Host `heapq` reference of the same linearization (inserts before
    deletes within a step; holds indexed by ascending pop order, the
    driver's lane order).  Returns per-step ascending pop lists."""
    if n_init is None:
        n_init = 4 * B
    holds = sample_holds(K, B, mean_hold, seed)
    heap = initial_events(n_init, mean_hold, seed).tolist()
    heapq.heapify(heap)
    out, prev = [], []
    for t in range(K):
        for i, k in enumerate(prev):
            heapq.heappush(heap, int(k) + int(holds[t, i]))
        prev = [heapq.heappop(heap) for _ in range(min(B, len(heap)))]
        out.append(prev)
    return out
