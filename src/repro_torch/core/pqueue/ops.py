"""Public batched priority-queue API (insert / deleteMin), in PyTorch.

Counterpart of src/repro/core/pqueue/ops.py,
whose docstring gives the semantics: a step applies a batch of B ops,
inserts before deletes, and the elimination/combining pre-pass serves the
batch's inserts that beat the queue minimum directly to the same batch's
deleteMins without touching `PQState` — exact for exact schedules.

The reference's `lax.cond` around an insert with no live lane (ops.py:116)
is a host read of that predicate here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.pqueue import schedules as SCH
from repro_torch.core.pqueue.local import (
    sort_op_log,
    tiered_insert,
    topk_of_merged,
)
from repro_torch.core.pqueue.partition import route_capped, route_dense
from repro_torch.core.pqueue.schedules import DeleteResult, Schedule, ensure_head
from repro_torch.core.pqueue.state import INF_KEY, PQState
from repro_torch.utils.hostsync import host_bool

OP_INSERT = 0
OP_DELETE_MIN = 1
OP_NOP = 2  # inert padding lane: neither an insert nor a delete

_INT32_MIN = -(2**31)

# Largest float32 that casts into the valid int32 key range (2**31 - 256).
_MAX_FINITE_KEY_F32 = float(2**31 - 256)


def sanitize_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Admission-boundary key sanitizer: (keys_int32, rejected_mask).
    Float batches (taken as float32, like the reference with x64 off) map
    non-finite lanes to the inert INF sentinel and report them; finite keys
    clamp into the int32 key range and truncate.  Integer batches pass."""
    if not keys.dtype.is_floating_point:
        return keys.to(torch.int32), torch.zeros(keys.shape, dtype=torch.bool,
                                                 device=keys.device)
    keys = keys.to(torch.float32)
    bad = ~torch.isfinite(keys)
    clamped = torch.clamp(torch.where(bad, 0.0, keys), float(_INT32_MIN),
                          _MAX_FINITE_KEY_F32).to(torch.int32)
    return torch.where(bad, INF_KEY, clamped), bad


def insert(
    state: PQState,
    keys: torch.Tensor,
    vals: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    capacity_factor: Optional[float] = None,
) -> Tuple[PQState, torch.Tensor]:
    """Insert a batch; returns (state, dropped_per_shard).  A batch with no
    live insert leaves the state untouched."""
    if mask is None:
        mask = keys < INF_KEY
    else:
        mask = mask & (keys < INF_KEY)
    S = state.num_shards
    if not host_bool(torch.any(mask), "ops.insert"):
        return state, torch.zeros((S,), dtype=torch.int32, device=state.device)
    if capacity_factor is None:
        rk, rv, counts = route_dense(keys, vals, mask, S)
    else:
        rk, rv, counts, _rejected = route_capped(keys, vals, mask, S,
                                                 capacity_factor)
    return tiered_insert(state, rk, rv, counts)


# ---------------------------------------------------------------------------
# elimination/combining pre-pass
# ---------------------------------------------------------------------------


def elim_cutoff(state: PQState) -> torch.Tensor:
    """The elimination threshold: the global queue minimum from the head
    min cache, or INT32_MIN (eliminate nothing) when a head has drained over
    a non-empty tail."""
    stale = torch.any((state.head_size == 0) & (state.tail_size > 0))
    return torch.where(stale, _INT32_MIN, torch.min(state.shard_mins))


def elim_split(
    state: PQState,
    sorted_keys: torch.Tensor,  # (B,) insert log sorted ascending, INF-masked
    sorted_tags: torch.Tensor,  # (B,) originating lane of each sorted entry
    vals: torch.Tensor,  # (B,) lane payloads
    b_del: torch.Tensor,  # () deleteMins in the batch
):
    """Match the sorted insert log against the batch's deleteMins: returns
    (elim_keys (B,) ascending INF-padded, elim_vals, n_elim, keep_mask by
    lane)."""
    B = sorted_keys.shape[0]
    cutoff = elim_cutoff(state)
    n_below = torch.searchsorted(sorted_keys.contiguous(), cutoff.reshape(1),
                                 out_int32=True)[0]
    n_elim = torch.minimum(n_below, b_del).to(torch.int32)
    lane = torch.arange(B, dtype=torch.int32, device=sorted_keys.device)
    elim_k = torch.where(lane < n_elim, sorted_keys, INF_KEY)
    elim_v = torch.where(
        lane < n_elim,
        vals[torch.clamp(sorted_tags, 0, B - 1).to(torch.int64)], 0)
    rank = torch.zeros((B,), dtype=torch.int32, device=lane.device).scatter_(
        0, sorted_tags.to(torch.int64), lane)
    keep = rank >= n_elim
    return elim_k, elim_v, n_elim, keep


def merge_eliminated(elim_k, elim_v, n_elim, res: DeleteResult) -> DeleteResult:
    """Prepend the eliminated pairs to a schedule's delete result (every
    eliminated key is below everything the schedule could return)."""
    B = res.keys.shape[0]
    lane = torch.arange(B, dtype=torch.int32, device=res.keys.device)
    idx = torch.clamp(lane - n_elim, 0, B - 1).to(torch.int64)
    out_k = torch.where(lane < n_elim, elim_k, res.keys[idx])
    out_v = torch.where(lane < n_elim, elim_v, res.vals[idx])
    return DeleteResult(res.state, out_k, out_v, res.n_out + n_elim)


def delete_min(
    state: PQState,
    m: int,
    schedule: Schedule | int = Schedule.STRICT_FLAT,
    active=None,
    draws=None,
    npods: int = 1,
    generator: Optional[torch.Generator] = None,
) -> DeleteResult:
    """Delete (up to) `active` minima with a static bound of m.  A random
    schedule (spray, MULTIQ) without `draws` draws them from `generator`."""
    schedule = Schedule(int(schedule))
    if active is None:
        active = m
    active = torch.as_tensor(active, dtype=torch.int32, device=state.device)
    if draws is None:
        draws = SCH.schedule_draws(schedule, None, state.num_shards, m,
                                   state.head_width, generator=generator,
                                   device=state.device)
    return SCH.SCHEDULE_FNS[schedule](state, m, active, draws, npods)


def peek_min(state: PQState, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m (ascending) without removal — exact."""
    state = ensure_head(state, m)
    cand_k = state.head_keys[:, :m].reshape(-1)
    cand_v = state.head_vals[:, :m].reshape(-1)
    return topk_of_merged(cand_k, cand_v, m)


class OpBatchResult(NamedTuple):
    state: PQState
    deleted_keys: torch.Tensor  # (B,) ascending, INF-padded
    deleted_vals: torch.Tensor  # (B,)
    n_deleted: torch.Tensor  # ()
    dropped: torch.Tensor  # (S,) inserts lost to capacity overflow


def apply_op_batch(
    state: PQState,
    ops: torch.Tensor,  # (B,) OP_INSERT / OP_DELETE_MIN
    keys: torch.Tensor,  # (B,)
    vals: torch.Tensor,  # (B,)
    schedule: Schedule | int = Schedule.STRICT_FLAT,
    draws=None,
    npods: int = 1,
    eliminate: bool = False,
    generator: Optional[torch.Generator] = None,
) -> OpBatchResult:
    """One bulk step of mixed operations (inserts, then deleteMins), with
    the elimination pre-pass first when `eliminate`."""
    B = ops.shape[0]
    ins_mask = ops == OP_INSERT
    n_del = torch.sum(ops == OP_DELETE_MIN).to(torch.int32)
    if eliminate:
        sk, st = sort_op_log(torch.where(ins_mask, keys, INF_KEY))
        elim_k, elim_v, n_elim, keep = elim_split(state, sk, st, vals, n_del)
        state, dropped = insert(state, keys, vals, mask=ins_mask & keep)
        res = delete_min(state, B, schedule=schedule, active=n_del - n_elim,
                         draws=draws, npods=npods, generator=generator)
        res = merge_eliminated(elim_k, elim_v, n_elim, res)
    else:
        state, dropped = insert(state, keys, vals, mask=ins_mask)
        res = delete_min(state, B, schedule=schedule, active=n_del,
                         draws=draws, npods=npods, generator=generator)
    return OpBatchResult(res.state, res.keys, res.vals, res.n_out, dropped)
