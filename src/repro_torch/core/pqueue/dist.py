"""Distributed PQ backend: the schedules as real collectives over a `Mesh`.

Counterpart of src/repro/core/pqueue/dist.py, whose docstring maps each
schedule to the communication it issues:

  STRICT_FLAT : one all_gather of every device's candidate run over ALL mesh
                axes (pod axis included: candidates cross the slow tier).
  HIER        : all_gather over the intra-pod axes, a pod-local select, then
                an all_gather over the POD AXIS ONLY of the compact
                pod-winner frame (Nuddle's request/response frames), and a
                final select.
  FFWD        : a log2(n)-step ppermute funnel of candidate frames into
                device 0 (the single server), then a reverse-tree broadcast
                of the verdict.
  SPRAY       : no collectives; each device pops from its own shards (hash
                placement makes local pops a uniform sample).
  MULTIQ      : no collectives; the two-choice MultiQueue over the device's
                own shards.

Every schedule mutates the same device-local state layout `(S_loc, C)`, so
a mode switch moves no queue data.  One process is one device; where the
reference runs inside `shard_map`, these functions take the mesh in
`AxisCfg.mesh` and issue its collectives.  The tournaments go through
`local.topk_of_merged` (the `topk_smallest` kernel), the insert through
`tiered_insert` (the `windowed_merge` kernel), MULTIQ through the
`twochoice_pick` and `multiq_select` kernels.

Spray and MULTIQ take their draws as tensors (`draws`, the port's
convention, schedules.py), or draw them on the device from `generator`;
`rank_generator` seeds one from a seed and the device's rank, the
counterpart of the reference's `fold_in(key, device)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.pqueue import local as L
from repro_torch.core.pqueue import schedules as SCH
from repro_torch.core.pqueue.partition import route_dense
from repro_torch.core.pqueue.schedules import Schedule, ensure_head
from repro_torch.core.pqueue.state import INF_KEY, PQState, replace
from repro_torch.distributed.mesh import Mesh
from repro_torch.utils.hashing import shard_of_key

Tensor = torch.Tensor
DistResult = Tuple[PQState, Tensor, Tensor, Tensor]


@dataclasses.dataclass(frozen=True)
class AxisCfg:
    """Mesh-axis roles for the queue.

    shard_axes: intra-pod axes the shards are distributed over (fast tier).
    pod_axis:   the slow-tier axis (None: a single pod, and HIER is the
                flat schedule, as NUMA-aware equals NUMA-oblivious on one
                socket).
    mesh:       the mesh whose collectives the schedules issue.
    """

    shard_axes: Tuple[str, ...]
    pod_axis: Optional[str] = None
    mesh: Mesh = dataclasses.field(kw_only=True)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return ((self.pod_axis,) if self.pod_axis else ()) + tuple(
            self.shard_axes)


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def _arange(n: int, device) -> Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _at(x: Tensor, i: Tensor) -> Tensor:
    """x[i] with i clamped into range, as a JAX gather clamps it."""
    return x[torch.clamp(i, 0, x.shape[0] - 1).to(torch.int64)]


def rank_generator(seed: int, cfg: AxisCfg) -> torch.Generator:
    """A generator on the mesh's device seeded from (seed, this device's
    rank over all axes): each device draws its own stream."""
    if seed < 0:
        raise ValueError(f"seed {seed} must be >= 0")
    g = torch.Generator(device=cfg.mesh.device)
    g.manual_seed((seed << 32) + cfg.mesh.device_rank(cfg.all_axes))
    return g


# ---------------------------------------------------------------------------
# insert: hash-route over the full mesh (identical in every mode)
# ---------------------------------------------------------------------------


def insert_dist(
    state: PQState,
    keys: Tensor,  # (B_loc,) this device's insert requests
    vals: Tensor,
    mask: Tensor,  # (B_loc,) valid
    cfg: AxisCfg,
    capacity_factor: float = 2.0,
) -> Tuple[PQState, Tensor, Tensor]:
    """Returns (state, dropped per local shard, rejected mask (B_loc,)).
    Rejected ops (a destination's frame overflowed) are the caller's to
    retry."""
    mesh, axes = cfg.mesh, cfg.all_axes
    B = keys.shape[0]
    n_dev = mesh.axis_size(axes)
    S_loc = state.num_shards
    dev = state.device

    gshard = shard_of_key(keys, n_dev * S_loc)
    dest_dev = torch.where(mask, gshard // S_loc, n_dev)

    # (n_dev, cap) send frame, MoE-dispatch style.
    cap = max(1, min(B, int(-(-B * capacity_factor // n_dev))))
    hit = dest_dev[None, :] == _arange(n_dev, dev)[:, None]
    pos = torch.cumsum(_i32(hit), dim=1, dtype=torch.int32) - 1
    pos_of = _i32(torch.sum(torch.where(hit, pos, 0), dim=0))
    keep = mask & (pos_of < cap)
    rejected = mask & ~keep

    # Lanes not kept land in the spare row n_dev, which is cut off (the
    # reference's mode="drop").
    d = torch.where(keep, dest_dev, n_dev).to(torch.int64)
    p = torch.where(keep, pos_of, 0).to(torch.int64)
    send_k = torch.full((n_dev + 1, cap), INF_KEY, dtype=torch.int32,
                        device=dev)
    send_v = torch.zeros((n_dev + 1, cap), dtype=torch.int32, device=dev)
    send_k.index_put_((d, p), torch.where(keep, keys, INF_KEY))
    send_v.index_put_((d, p), torch.where(keep, vals, 0))

    recv_k = mesh.all_to_all(send_k[:n_dev], axes)
    recv_v = mesh.all_to_all(send_v[:n_dev], axes)

    flat_k, flat_v = recv_k.reshape(-1), recv_v.reshape(-1)
    rk, rv, counts = route_dense(flat_k, flat_v, flat_k < INF_KEY, S_loc)
    new_state, dropped = L.tiered_insert(state, rk, rv, counts)
    return new_state, dropped, rejected


# ---------------------------------------------------------------------------
# deleteMin schedules
# ---------------------------------------------------------------------------


def _local_candidates(state: PQState, m: int) -> Tuple[Tensor, Tensor]:
    """This device's m smallest across its local shards (an ascending run)
    from the head prefixes; callers ensure_head first."""
    ck = state.head_keys[:, :m].reshape(-1)
    cv = state.head_vals[:, :m].reshape(-1)
    return L.topk_of_merged(ck, cv, m)


def _take_from_gathered(
    gk: Tensor,  # (n_frames, m) gathered candidate runs (ascending each)
    my_frame: int,  # index of this device's frame
    my_run: Tensor,  # (m,) this device's run
    n: Tensor,  # () winners to remove globally
) -> Tuple[Tensor, Tensor, Tensor]:
    """Given all frames, (winners_k, winner order, my_take): my_take is how
    many of this device's candidates won (always a prefix)."""
    flat = gk.reshape(-1)
    order = torch.sort(flat, stable=True).indices  # ties: lower frame wins
    win_k = flat[order[: my_run.shape[0]]]
    cutoff = _at(win_k, n - 1)
    below = _i32(torch.sum(my_run < cutoff))
    at_mine = _i32(torch.sum(my_run == cutoff))
    # Tie slots go to frames in id order (the sort's stability).
    at_per_frame = _i32(torch.sum(gk == cutoff, dim=1))
    remaining = n - _i32(torch.sum(flat < cutoff))
    tie_prefix = torch.cumsum(at_per_frame, 0, dtype=torch.int32) - at_per_frame
    tie_take = torch.minimum(
        torch.clamp(remaining - tie_prefix[my_frame], min=0), at_mine)
    take = _i32(torch.where(n > 0, below + tie_take, 0))
    return win_k, order, take


def _apply_take(state: PQState, my_take: Tensor, m: int) -> PQState:
    """Remove this device's `my_take` smallest elements: per-shard prefixes
    found by a local threshold over the head prefixes, ties allotted by
    shard order."""
    ck = state.head_keys[:, :m]
    kth = _at(torch.sort(ck.reshape(-1)).values, my_take - 1)
    take = L.count_winners_per_shard(ck, kth, my_take)
    take = torch.where(my_take > 0, take, 0)
    nk, nv, nq, ns = L.remove_prefix(state.head_keys, state.head_vals,
                                     state.head_seq, state.head_size, take)
    return replace(state, head_keys=nk, head_vals=nv, head_seq=nq,
                   head_size=ns)


def _winners(m: int, n: Tensor, win_k: Tensor, win_v: Tensor):
    lane = _arange(m, win_k.device)
    return (torch.where(lane < n, win_k, INF_KEY),
            torch.where(lane < n, win_v, 0))


def _n_winners(state: PQState, active, cfg: AxisCfg) -> Tensor:
    total = cfg.mesh.psum(state.total_size, cfg.all_axes)
    active = torch.as_tensor(active, dtype=torch.int32, device=state.device)
    return _i32(torch.minimum(active, total))


def _commit_cutoff(state: PQState, run_k: Tensor, win_k: Tensor,
                   win_v: Tensor, n: Tensor, m: int,
                   cfg: AxisCfg) -> DistResult:
    """Commit a verdict every device holds: each device's take comes from
    the global cutoff applied to its own run, tie slots allotted by device
    rank over all axes, the resolution of the flat schedule (so HIER and
    FFWD equal STRICT_FLAT)."""
    mesh, axes = cfg.mesh, cfg.all_axes
    cutoff = _at(win_k, n - 1)
    my_below = _i32(torch.sum(run_k < cutoff))
    my_at = _i32(torch.sum(run_k == cutoff))
    at_all = mesh.all_gather(my_at, axes)  # (n_dev,)
    below_all = mesh.psum(my_below, axes)
    tie_prefix = torch.cumsum(at_all, 0, dtype=torch.int32) - at_all
    tie_take = torch.minimum(
        torch.clamp((n - below_all) - tie_prefix[mesh.device_rank(axes)],
                    min=0), my_at)
    take = _i32(torch.where(n > 0, my_below + tie_take, 0))
    state = _apply_take(state, take, m)
    return (state, *_winners(m, n, win_k, win_v), n)


def delete_flat_dist(state: PQState, m: int, active, draws, cfg: AxisCfg,
                     generator=None) -> DistResult:
    """lotan_shavit: one global gather over every axis (pod included)."""
    mesh, axes = cfg.mesh, cfg.all_axes
    state = ensure_head(state, m)
    run_k, run_v = _local_candidates(state, m)
    gk = mesh.all_gather(run_k, axes).reshape(-1, m)
    gv = mesh.all_gather(run_v, axes).reshape(-1, m)
    n = _n_winners(state, active, cfg)
    win_k, order, take = _take_from_gathered(gk, mesh.device_rank(axes),
                                             run_k, n)
    win_v = gv.reshape(-1)[order[:m]]
    state = _apply_take(state, take, m)
    return (state, *_winners(m, n, win_k, win_v), n)


def delete_hier_dist(state: PQState, m: int, active, draws, cfg: AxisCfg,
                     generator=None) -> DistResult:
    """Nuddle: the intra-pod semifinal on the fast tier, the pod-axis final
    on the slow tier."""
    if cfg.pod_axis is None:
        return delete_flat_dist(state, m, active, draws, cfg)
    mesh = cfg.mesh
    state = ensure_head(state, m)
    run_k, run_v = _local_candidates(state, m)
    # Phase 1: gather within the pod (fast tier), pod-local select.
    pk = mesh.all_gather(run_k, cfg.shard_axes).reshape(-1)
    pv = mesh.all_gather(run_v, cfg.shard_axes).reshape(-1)
    pod_k, pod_v = L.topk_of_merged(pk, pv, m)
    # Phase 2: only the compact pod-winner frame crosses the pod axis.
    gk = mesh.all_gather(pod_k, cfg.pod_axis).reshape(-1)  # (npods * m,)
    gv = mesh.all_gather(pod_v, cfg.pod_axis).reshape(-1)
    n = _n_winners(state, active, cfg)
    order = torch.sort(gk, stable=True).indices[:m]
    return _commit_cutoff(state, run_k, gk[order], gv[order], n, m, cfg)


def delete_ffwd_dist(state: PQState, m: int, active, draws, cfg: AxisCfg,
                     generator=None) -> DistResult:
    """ffwd: a tree funnel of candidate frames into device 0 (the single
    server), which resolves the tournament; the verdict goes back down the
    tree.  2*log2(n) ppermute phases, all converging on one device: the
    single-server ceiling of the paper's ffwd baseline."""
    mesh, axes = cfg.mesh, cfg.all_axes
    n_dev = mesh.axis_size(axes)
    if n_dev & (n_dev - 1):
        raise ValueError(f"the ffwd funnel needs a power-of-two mesh, got "
                         f"{n_dev} devices")
    state = ensure_head(state, m)
    run_k, run_v = _local_candidates(state, m)
    me = mesh.device_rank(axes)

    # Funnel up: at step s, ranks r with r % 2^(s+1) == 2^s send to r - 2^s.
    buf_k, buf_v = run_k, run_v
    steps = n_dev.bit_length() - 1
    for s in range(steps):
        stride = 1 << s
        perm = [(r + stride, r) for r in range(0, n_dev, 2 * stride)]
        rk = mesh.ppermute(buf_k, axes, perm)
        rv = mesh.ppermute(buf_v, axes, perm)
        if me % (2 * stride):  # not a receiver at this step
            rk, rv = torch.full_like(rk, INF_KEY), torch.zeros_like(rv)
        buf_k, buf_v = L.topk_of_merged(torch.cat([buf_k, rk]),
                                        torch.cat([buf_v, rv]), m)

    n = _n_winners(state, active, cfg)
    # Broadcast the verdict down the reversed tree.
    win_k, win_v = buf_k, buf_v
    for s in reversed(range(steps)):
        stride = 1 << s
        perm = [(r, r + stride) for r in range(0, n_dev, 2 * stride)]
        rk = mesh.ppermute(win_k, axes, perm)
        rv = mesh.ppermute(win_v, axes, perm)
        if me % (2 * stride) == stride:
            win_k, win_v = rk, rv
    return _commit_cutoff(state, run_k, win_k, win_v, n, m, cfg)


def _draws(schedule: Schedule, state: PQState, m: int, draws, generator):
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError(f"{schedule.name} needs draws or a generator "
                         f"(dist.rank_generator)")
    return SCH.schedule_draws(schedule, None, state.num_shards, m,
                              state.head_width, generator=generator,
                              device=state.device)


def delete_spray_dist(state: PQState, m_loc: int, active_loc, draws,
                      cfg: AxisCfg, generator=None) -> DistResult:
    """SprayList mode: every device serves its local deleters from its own
    shards, with ZERO collectives: the scaling property the oblivious mode
    trades quality for."""
    draws = _draws(Schedule.SPRAY_HERLIHY, state, m_loc, draws, generator)
    active_loc = torch.as_tensor(active_loc, dtype=torch.int32,
                                 device=state.device)
    res = SCH.delete_spray_herlihy(state, m_loc, active_loc, draws, npods=1)
    return res.state, res.keys, res.vals, res.n_out


def delete_multiq_dist(state: PQState, m_loc: int, active_loc, draws,
                       cfg: AxisCfg, generator=None) -> DistResult:
    """MultiQueue mode: two-choice sampling over the device's OWN shards
    (the sub-queues) against their cached minima; ZERO collectives, and the
    probe keeps each device's pops within shard-rank < m_loc."""
    draws = _draws(Schedule.MULTIQ, state, m_loc, draws, generator)
    active_loc = torch.as_tensor(active_loc, dtype=torch.int32,
                                 device=state.device)
    res = SCH.delete_multiq(state, m_loc, active_loc, draws, npods=1)
    return res.state, res.keys, res.vals, res.n_out


DIST_SCHEDULE_FNS = {
    Schedule.STRICT_FLAT: delete_flat_dist,
    Schedule.HIER: delete_hier_dist,
    Schedule.FFWD: delete_ffwd_dist,
    Schedule.SPRAY_HERLIHY: delete_spray_dist,
    Schedule.MULTIQ: delete_multiq_dist,
}
