"""Batched wavefront-Dijkstra SSSP over the concurrent PQ, in PyTorch.

Counterpart of src/repro/workloads/sssp.py, whose docstring gives the
design: each step deleteMins an m-wide wavefront of tentative (distance,
vertex) pairs, gathers the popped vertices' padded adjacency rows (a static
(m, deg_cap) block), folds the candidate distances into the dense distance
array with one segment-min (`kernels.ops.segment_min_into`) and inserts the
strictly improving candidates back.  A popped pair whose distance exceeds
the vertex's current distance is stale: the driver counts those as
``wasted`` pops.  The loop is label-correcting, so any schedule converges
to the exact distances (`graphs.bellman_ford`) once the queue drains.

The reference runs `chunk` steps in one `lax.scan`, then checks on the
host whether the queue is empty; the port runs the same chunks step by
step and makes the same one host read a chunk, so ``SSSPResult.steps``
counts whole chunks as the reference's does.

Randomness: a run takes its per-step draws as tensors with a leading step
axis (``draws=``, in the form `schedules.step_draws` gives them), and stops
when they are spent; without them it draws each chunk's from `generator`
(by default a `torch.Generator` on the graph's device seeded with `seed`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.pqueue import ops as O
from repro_torch.core.pqueue import schedules as SCH
from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT, OP_NOP
from repro_torch.core.pqueue.schedules import Schedule
from repro_torch.core.pqueue.state import DEFAULT_HEAD_WIDTH, INF_KEY, make_state
from repro_torch.kernels.ops import segment_min_into
from repro_torch.utils.hostsync import host_bool
from repro_torch.workloads.graphs import Graph
from repro_torch.workloads.traces import Trace, prefill

Tensor = torch.Tensor


class SSSPResult(NamedTuple):
    dist: np.ndarray  # (n,) int32 tentative distances (exact on convergence)
    pops: int  # total deleteMin pops served
    wasted: int  # stale pops (priority-inversion cost, empirical)
    improved: int  # relaxations that strictly improved a distance
    steps: int  # steps executed (whole chunks)
    converged: bool  # queue drained before the step budget
    modes: Optional[np.ndarray] = None  # (steps,) SmartPQ mode trace
    transitions: int = 0


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def _relax(dist, pop_k, pop_v, n_out, nbr, wgt):
    """One bulk relaxation: fold the popped wavefront's out-edges into
    `dist` and emit the strictly improving candidates as an INF-masked
    insert batch of static width m * deg_cap.  All arithmetic stays int32:
    the masked source distance keeps the add from overflowing.

    Returns (dist, ins_keys, ins_vals, n_wasted, n_improved)."""
    n = dist.shape[0]
    m = pop_k.shape[0]
    lane = torch.arange(m, dtype=torch.int32, device=dist.device)
    valid = lane < n_out
    u = torch.clamp(pop_v, 0, n - 1).to(torch.int64)
    fresh = valid & (pop_k <= dist[u])  # stale pops carry d > dist[u]
    n_wasted = _i32(torch.sum(valid & ~fresh))

    vs = nbr[u]  # (m, deg_cap), sentinel n beyond degree
    ws = wgt[u]
    edge_ok = fresh[:, None] & (vs < n)
    d_src = torch.where(fresh, pop_k, 0)  # keep the add overflow-free
    nd = torch.where(edge_ok, d_src[:, None] + ws, INF_KEY)
    v_safe = torch.where(edge_ok, vs, 0)
    improved = edge_ok & (nd < dist[v_safe.to(torch.int64)])
    n_improved = _i32(torch.sum(improved))

    tgt = torch.where(edge_ok, vs, n)  # sentinel targets drop
    dist = segment_min_into(dist, tgt.reshape(-1), nd.reshape(-1))

    ins_keys = torch.where(improved, nd, INF_KEY).reshape(-1)
    ins_vals = v_safe.reshape(-1)
    return dist, ins_keys, ins_vals, n_wasted, n_improved


def _init_dist_and_state(graph: Graph, num_shards, capacity, head_width, src):
    dev = graph.nbr.device
    dist = torch.full((graph.n,), INF_KEY, dtype=torch.int32, device=dev)
    dist[src] = 0
    st = make_state(num_shards, capacity, head_width=head_width, device=dev)
    st = prefill(st, np.asarray([0], np.int32), np.asarray([src], np.int32))
    return dist, st


def _zero(dev) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def _chunk_draws(draws, steps, chunk, make):
    """The draws of steps [steps, steps + chunk): a slice of the caller's,
    or `make()`'s fresh ones; None when the schedules draw nothing."""
    if draws is None:
        return make()
    return tuple(d[steps:steps + chunk] for d in draws)


def _step_budget(draws, max_steps: int, chunk: int) -> int:
    """Steps a run may start chunks below: `max_steps`, and with draws no
    more than the whole chunks they cover."""
    if draws is None:
        return max_steps
    return min(max_steps, draws[0].shape[0] // chunk * chunk)


def make_sssp_engine(
    graph: Graph,
    schedule: Schedule,
    m: int = 32,
    num_shards: int = 8,
    capacity: int = 4096,
    head_width: int | None = None,
    npods: int = 2,
    chunk: int = 8,
):
    """Fixed-schedule SSSP engine on the graph's device: chunks of `chunk`
    steps, one host check of the queue's emptiness after each.  Returns
    ``run(src, seed, max_steps, draws=None, generator=None)``."""
    fn = SCH.SCHEDULE_FNS[schedule]
    nbr, wgt = graph.nbr, graph.wgt
    dev = nbr.device

    def run(src: int = 0, seed: int = 0, max_steps: int = 4096,
            draws=None, generator: Optional[torch.Generator] = None
            ) -> SSSPResult:
        dist, st = _init_dist_and_state(
            graph, num_shards, capacity, head_width, src
        )
        active = torch.tensor(m, dtype=torch.int32, device=dev)
        pops, wasted, improved = _zero(dev), _zero(dev), _zero(dev)
        if draws is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        if draws is not None:
            draws = tuple(d.to(dev) for d in draws)
        budget = _step_budget(draws, max_steps, chunk)
        steps = 0
        while steps < budget:
            cd = _chunk_draws(draws, steps, chunk, lambda: SCH.step_draws(
                (schedule,), st.num_shards, m, st.head_width, steps=chunk,
                generator=generator, device=dev))
            for t in range(chunk):
                r = None if cd is None else SCH.schedule_draws(
                    schedule, tuple(d[t] for d in cd), st.num_shards, m,
                    st.head_width)
                res = fn(st, m, active, r, npods)
                dist, ins_k, ins_v, w, imp = _relax(
                    dist, res.keys, res.vals, res.n_out, nbr, wgt)
                st, _ = O.insert(res.state, ins_k, ins_v)
                pops, wasted = pops + res.n_out, wasted + w
                improved = improved + imp
            steps += chunk
            if host_bool(st.total_size == 0, "sssp.drained"):
                break
        return SSSPResult(
            dist=dist.cpu().numpy(), pops=int(pops), wasted=int(wasted),
            improved=int(improved), steps=steps,
            converged=int(st.total_size) == 0,
        )

    return run


def run_sssp(
    graph: Graph,
    schedule: Schedule,
    m: int = 32,
    num_shards: int = 8,
    capacity: int = 4096,
    head_width: int | None = None,
    npods: int = 2,
    src: int = 0,
    seed: int = 0,
    chunk: int = 8,
    max_steps: int = 4096,
    draws=None,
    generator: Optional[torch.Generator] = None,
) -> SSSPResult:
    """One-shot fixed-schedule SSSP (see `make_sssp_engine`)."""
    run = make_sssp_engine(
        graph, schedule, m=m, num_shards=num_shards, capacity=capacity,
        head_width=head_width, npods=npods, chunk=chunk,
    )
    return run(src=src, seed=seed, max_steps=max_steps, draws=draws,
               generator=generator)


def make_smartpq_sssp_engine(
    graph: Graph,
    pq,  # SmartPQ on the graph's device; its config fixes shards, modes
    m: int = 16,
    chunk: int = 8,
    num_clients: int | None = None,
):
    """Adaptive SSSP engine through `SmartPQ.step`: the whole decision
    stack runs every step, fed by the application's own op stream.  The
    wavefront is pipelined by one step: step t inserts the candidates step
    t-1 relaxed and pops the next m-wide wavefront, one mixed batch of
    width B = m * deg_cap + m, which must fit the head tier (H >= B).

    ``run(src, seed, max_steps, record, draws=None, generator=None,
    return_carry=False)`` returns (SSSPResult, trace): the `traces.Trace` of
    the batches issued with ``record=True``, else None; with
    ``return_carry`` the queue's final `SmartPQCarry` follows.  `draws` are
    `SmartPQ.step`'s per-step draws with a leading step axis."""
    D = graph.deg_cap
    b_ins = m * D
    B = b_ins + m
    H = min(pq.config.head_width or DEFAULT_HEAD_WIDTH, pq.config.capacity)
    if B > H:
        raise ValueError(
            f"adaptive SSSP batch width {B} (m={m} * deg_cap={D} + m) "
            f"exceeds the hot head tier H={H} (H-sizing rule in state.py)"
        )
    if num_clients is None:
        num_clients = m
    nbr, wgt = graph.nbr, graph.wgt
    dev = nbr.device
    i32 = dict(dtype=torch.int32, device=dev)
    del_ops = torch.full((m,), OP_DELETE_MIN, **i32)
    del_keys = torch.full((m,), INF_KEY, **i32)
    del_vals = torch.zeros((m,), **i32)
    op_insert = torch.tensor(OP_INSERT, **i32)
    op_nop = torch.tensor(OP_NOP, **i32)
    nc = torch.tensor(num_clients, **i32)

    def run(src: int = 0, seed: int = 0, max_steps: int = 4096,
            record: bool = False, draws=None,
            generator: Optional[torch.Generator] = None,
            return_carry: bool = False):
        c = pq.config
        dist, st = _init_dist_and_state(
            graph, c.num_shards, c.capacity, c.head_width, src
        )
        pqc = pq.init()._replace(state=st)
        pend_k = torch.full((b_ins,), INF_KEY, **i32)
        pend_v = torch.zeros((b_ins,), **i32)
        pops, wasted, improved = _zero(dev), _zero(dev), _zero(dev)
        if draws is None and generator is None:
            generator = torch.Generator(device=dev).manual_seed(seed)
        if draws is not None:
            draws = tuple(d.to(dev) for d in draws)
        budget = _step_budget(draws, max_steps, chunk)
        steps = 0
        log_ops, log_keys, log_vals, log_modes = [], [], [], []
        while steps < budget:
            cd = _chunk_draws(draws, steps, chunk, lambda: SCH.step_draws(
                c.mode_schedules, st.num_shards, B, st.head_width,
                steps=chunk, generator=generator, device=dev))
            for t in range(chunk):
                ops = torch.cat([torch.where(pend_k < INF_KEY, op_insert,
                                             op_nop), del_ops])
                keys = torch.cat([pend_k, del_keys])
                vals = torch.cat([pend_v, del_vals])
                pqc, res = pq.step(
                    pqc, ops, keys, vals,
                    draws=None if cd is None else tuple(d[t] for d in cd),
                    num_clients=nc)
                dist, pend_k, pend_v, w, imp = _relax(
                    dist, res.keys[:m], res.vals[:m], res.n_out, nbr, wgt)
                pops, wasted = pops + res.n_out, wasted + w
                improved = improved + imp
                log_modes.append(pqc.stats.mode)
                if record:
                    log_ops.append(ops)
                    log_keys.append(keys)
                    log_vals.append(vals)
            steps += chunk
            if host_bool((pqc.state.total_size == 0)
                         & ~torch.any(pend_k < INF_KEY), "sssp.drained"):
                break
        # the pipelined lag means a drained queue with pending candidates
        # is not converged: their out-edges were never relaxed
        pending = int(torch.sum(pend_k < INF_KEY))
        result = SSSPResult(
            dist=dist.cpu().numpy(), pops=int(pops), wasted=int(wasted),
            improved=int(improved), steps=steps,
            converged=int(pqc.state.total_size) == 0 and pending == 0,
            modes=torch.stack(log_modes).cpu().numpy(),
            transitions=int(pqc.stats.transitions),
        )
        trace = None
        if record:
            trace = Trace(
                ops=torch.stack(log_ops).cpu().numpy(),
                keys=torch.stack(log_keys).cpu().numpy(),
                vals=torch.stack(log_vals).cpu().numpy(),
                num_clients=np.full((steps,), num_clients, np.int32),
                seed=seed,
                init_keys=np.asarray([0], np.int32),
                init_vals=np.asarray([src], np.int32),
            )
        return (result, trace, pqc) if return_carry else (result, trace)

    return run


def run_sssp_smartpq(
    graph: Graph,
    pq,
    m: int = 16,
    src: int = 0,
    seed: int = 0,
    chunk: int = 8,
    max_steps: int = 4096,
    num_clients: int | None = None,
    record: bool = False,
    draws=None,
    generator: Optional[torch.Generator] = None,
):
    """One-shot adaptive SSSP (see `make_smartpq_sssp_engine`)."""
    run = make_smartpq_sssp_engine(graph, pq, m=m, chunk=chunk,
                                   num_clients=num_clients)
    return run(src=src, seed=seed, max_steps=max_steps, record=record,
               draws=draws, generator=generator)
