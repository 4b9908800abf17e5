"""deleteMin schedules, in PyTorch.

Counterpart of src/repro/core/pqueue/schedules.py, whose docstring maps
each schedule to the paper's evaluation cast:

    STRICT_FLAT   lotan_shavit      exact, one flat tournament
    SPRAY_HERLIHY alistarh_herlihy  relaxed, adaptive spray window
    HIER          Nuddle            exact, pod-local semifinal then final
    FFWD          ffwd              exact, single-server funnel
    LOCAL         ablation          per-shard pops, no global order
    SPRAY_FRASER  alistarh_fraser   relaxed, uniform spray window
    MULTIQ        MultiQueue        relaxed, two-choice min-cache probes

Every schedule is a `hot_*` core that reads and writes only the head tier
(plus the scalar total) after `ensure_head`, and a full-state `delete_*`
wrapper.  The tournaments go through `local.topk_of_merged`, the
`topk_smallest` kernel; MULTIQ goes through the `twochoice_pick` and
`multiq_select` kernels.

Randomness: the random cores take their draws as tensors, the
`jax.random.randint` draws of the reference, so tests can feed both
packages the same numbers:

    spray   (shard_choice (m,) in [0, S), hi (S, W) in [0, 2**31 // (W+1) - 1))
            (schedules.py:252-256,275-276)
    MULTIQ  (choice_a (m,) in [0, S), choice_b (m,) in [0, S))
            (schedules.py:323-328)

Both draw their first tensor from the same key and call, so for one step's
key ``choice_a`` is the spray's ``shard_choice``: a step's draws are
(shard_choice, hi[, choice_b]).  `step_draws` makes them on the device from
a `torch.Generator` for every schedule of a config, and `schedule_draws`
picks one core's draws out of them.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional

import torch

from repro_torch.core.pqueue import local as L
from repro_torch.core.pqueue.state import INF_KEY, PQState, replace
from repro_torch.kernels import ops as KO
from repro_torch.utils.hostsync import host_bool

_INT32_MAX = 2**31 - 1


class Schedule(enum.IntEnum):
    STRICT_FLAT = 0
    SPRAY_HERLIHY = 1
    HIER = 2
    FFWD = 3
    LOCAL = 4
    SPRAY_FRASER = 5
    MULTIQ = 6


SPRAY_SCHEDULES = (Schedule.SPRAY_HERLIHY, Schedule.SPRAY_FRASER)


class DeleteResult(NamedTuple):
    state: PQState
    keys: torch.Tensor  # (m,) ascending; INF-padded beyond n_out
    vals: torch.Tensor  # (m,)
    n_out: torch.Tensor  # () int32


class HotTier(NamedTuple):
    """The head-tier slice every schedule core reads and writes."""

    keys: torch.Tensor  # (S, H)
    vals: torch.Tensor  # (S, H)
    seq: torch.Tensor  # (S, H)
    size: torch.Tensor  # (S,)


def hot_tier(state: PQState) -> HotTier:
    return HotTier(state.head_keys, state.head_vals, state.head_seq,
                   state.head_size)


def attach_hot(state: PQState, hot: HotTier) -> PQState:
    return replace(state, head_keys=hot.keys, head_vals=hot.vals,
                   head_seq=hot.seq, head_size=hot.size)


def _ilog2(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def spray_bound(num_shards: int, m: int) -> int:
    """Relaxation envelope of a spray deleteMin of batch m: every returned
    key is among the smallest spray_bound(S, m) keys of the queue."""
    per_shard = -(-m // num_shards) + (_ilog2(num_shards) + 1) ** 2
    return min(num_shards * per_shard, 1 << 30)


def multiq_bound(num_shards: int, m: int) -> int:
    """Relaxation envelope of the two-choice MULTIQ deleteMin of batch m:
    m + O(S log log S)."""
    loglog = _ilog2(_ilog2(max(num_shards, 2)) + 1) + 1
    return min(m + num_shards * (loglog + 2), 1 << 30)


# ---------------------------------------------------------------------------
# Hot-tier precondition shared by every schedule.
# ---------------------------------------------------------------------------


def _head_pad(num_shards: int) -> int:
    """The spray window padding — also the refill hysteresis margin."""
    return (_ilog2(num_shards) + 1) ** 2


def head_refill_pred(state: PQState, m: int) -> torch.Tensor:
    """() bool: would a delete batch of bound m fire the guarded refill?"""
    if state.tail_width == 0:
        return torch.zeros((), dtype=torch.bool, device=state.device)
    need = min(state.head_width, m + _head_pad(state.num_shards))
    return torch.any((state.head_size < need) & (state.tail_size > 0))


def ensure_head(state: PQState, m: int, pred: Optional[bool] = None) -> PQState:
    """Restore the hot-tier precondition before a delete batch of bound m:
    each head holds its shard's smallest min(H, size) elements and is at
    least m + pad deep unless the shard is smaller.  `pred` is the refill
    predicate when the caller has read it already."""
    H = state.head_width
    if m > H:
        raise ValueError(
            f"delete batch bound m={m} exceeds the hot head tier width "
            f"H={H}; raise head_width (H-sizing rule: H >= m + "
            f"(ilog2(S)+1)^2 for spray, H >= m for exact schedules)"
        )
    if state.tail_width == 0:
        return state
    if pred is None:
        pred = host_bool(head_refill_pred(state, m),
                         "schedules.ensure_head")
    return L.refill_head_guarded(state, pred)


def _pop_hot_prefix(hot: HotTier, take: torch.Tensor) -> HotTier:
    return HotTier(*L.remove_prefix(hot.keys, hot.vals, hot.seq, hot.size,
                                    take))


def _finish_tournament(hot, m, n, win_k, win_v):
    """Shared tail of the exact tournaments: every shard removes the prefix
    it lost, and lanes past n read (INF, 0)."""
    cutoff = win_k[torch.clamp(n - 1, min=0).to(torch.int64)]
    take = L.count_winners_per_shard(hot.keys[:, :m], cutoff, n)
    take = torch.where(n > 0, take, 0)
    hot = _pop_hot_prefix(hot, take)
    lane = torch.arange(m, dtype=torch.int32, device=hot.keys.device)
    out_k = torch.where(lane < n, win_k, INF_KEY)
    out_v = torch.where(lane < n, win_v, 0)
    return hot, out_k, out_v, n


def _hot_tournament(hot: HotTier, total, m: int, active):
    """Exact top-`active` removal: each shard nominates its m smallest (a
    head prefix), one global tournament picks the winners, ties broken by
    (key, shard, slot)."""
    cand_k = hot.keys[:, :m]
    cand_v = hot.vals[:, :m]
    n = torch.minimum(active, total).to(torch.int32)
    win_k, win_v = L.topk_of_merged(cand_k.reshape(-1), cand_v.reshape(-1), m)
    return _finish_tournament(hot, m, n, win_k, win_v)


def hot_strict_flat(hot, total, m, active, draws=None, npods=1):
    """lotan_shavit: one flat global tournament (all S*m candidates meet)."""
    return _hot_tournament(hot, total, m, active)


def hot_hier(hot, total, m, active, draws=None, npods=1):
    """Nuddle: pod-local semifinal (one top-k launch with a row per pod),
    then the final over the npods*m pod winners — the same winners as
    STRICT_FLAT."""
    S = hot.keys.shape[0]
    if S % npods:
        raise ValueError(f"shards {S} must split evenly over {npods} pods")
    cand_k = hot.keys[:, :m].reshape(npods, -1).contiguous()
    cand_v = hot.vals[:, :m].reshape(npods, -1)
    n_pod = cand_k.shape[1]
    tags = torch.arange(n_pod, dtype=torch.int32, device=cand_k.device)
    tags = tags[None, :].expand(npods, n_pod).contiguous()
    pod_k, pod_t = KO.topk_smallest(cand_k, tags, m)
    pod_v = torch.gather(cand_v, 1, pod_t.to(torch.int64))
    win_k, win_v = L.topk_of_merged(pod_k.reshape(-1), pod_v.reshape(-1), m)
    n = torch.minimum(active, total).to(torch.int32)
    return _finish_tournament(hot, m, n, win_k, win_v)


def hot_ffwd(hot, total, m, active, draws=None, npods=1):
    """ffwd: every candidate funnels to one server; single-controller
    semantics equal STRICT_FLAT."""
    return _hot_tournament(hot, total, m, active)


def spray_window(num_shards: int, m: int, head_width: int) -> int:
    """The static per-shard spray window W = min(m + pad, H)."""
    return min(m + _head_pad(num_shards), head_width)


def _shard_ids(num_shards: int, shape, generator, device) -> torch.Tensor:
    return torch.randint(0, num_shards, shape, generator=generator,
                         device=device, dtype=torch.int32)


def spray_draws(num_shards: int, m: int, head_width: int, steps=None,
                generator: Optional[torch.Generator] = None, device=None):
    """The spray cores' random draws, on `device`, from `generator`:
    (shard_choice, hi) of shapes (m,), (S, W) — or (steps, m),
    (steps, S, W) with `steps`."""
    W = spray_window(num_shards, m, head_width)
    lead = () if steps is None else (steps,)
    shard_choice = _shard_ids(num_shards, lead + (m,), generator, device)
    hi = torch.randint(0, (1 << 31) // (W + 1) - 1, lead + (num_shards, W),
                       generator=generator, device=device, dtype=torch.int32)
    return shard_choice, hi


def step_draws(schedules, num_shards: int, m: int, head_width: int,
               steps=None, generator: Optional[torch.Generator] = None,
               device=None):
    """The draws `SmartPQ.step` (or, with `steps`, `run_window`) takes for
    a config whose modes run `schedules`: (shard_choice, hi), plus choice_b
    when MULTIQ is among them; None when no schedule draws."""
    if not any(s in SPRAY_SCHEDULES or s == Schedule.MULTIQ
               for s in schedules):
        return None
    draws = spray_draws(num_shards, m, head_width, steps=steps,
                        generator=generator, device=device)
    if Schedule.MULTIQ in tuple(schedules):
        lead = () if steps is None else (steps,)
        draws += (_shard_ids(num_shards, lead + (m,), generator, device),)
    return draws


def schedule_draws(schedule: Schedule, draws, num_shards: int, m: int,
                   head_width: int,
                   generator: Optional[torch.Generator] = None, device=None):
    """The draws `schedule`'s core takes, picked from one step's
    (shard_choice, hi[, choice_b]); without them (`draws` None) the step's
    draws come from `step_draws((schedule,), ...)` and `generator`.  None
    when the schedule draws nothing."""
    if draws is None:
        draws = step_draws((schedule,), num_shards, m, head_width,
                           generator=generator, device=device)
    if schedule in SPRAY_SCHEDULES:
        return draws[0], draws[1]
    if schedule == Schedule.MULTIQ:
        if len(draws) < 3 or draws[2] is None:
            raise ValueError("a MULTIQ step needs draws=(shard_choice, hi, "
                             "choice_b)")
        return draws[0], draws[2]
    return None


def _hot_spray(hot: HotTier, m: int, active, draws, adaptive_window: bool):
    """Each of the `active` deleters lands on its drawn shard; each shard
    pops its deleters' picks from random distinct slots of a bounded window
    at the head of its sorted buffer (the slots whose unique random score
    is at or below the takeable-th smallest)."""
    if draws is None:
        raise ValueError("spray schedules need draws=(shard_choice, hi)")
    shard_choice, hi = draws
    S, H = hot.keys.shape
    dev = hot.keys.device
    lane = torch.arange(m, dtype=torch.int32, device=dev)
    act = lane < torch.clamp(active, max=m)
    shard_choice = torch.where(act, shard_choice, S)  # park inactive lanes
    m_s = torch.zeros((S + 1,), dtype=torch.int32, device=dev).scatter_add_(
        0, shard_choice.to(torch.int64), torch.ones_like(shard_choice))[:S]

    pad = _head_pad(S)
    W = spray_window(S, m, H)
    if adaptive_window:
        window = m_s + pad
    else:
        window = torch.full((S,), -(-m // S) + pad, dtype=torch.int32,
                            device=dev)
    window = torch.clamp(torch.minimum(window, hot.size), max=W)

    col = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    u = hi * (W + 1) + col  # unique within a row
    in_win = col < window[:, None]
    score = torch.where(in_win, u, _INT32_MAX)
    sorted_score = torch.sort(score, dim=1).values
    takeable = torch.minimum(m_s, window)
    kth = torch.gather(sorted_score, 1,
                       torch.clamp(takeable - 1, 0, W - 1)[:, None]
                       .to(torch.int64))
    remove_mask = (score <= kth) & (takeable > 0)[:, None] & in_win

    removed_k = torch.where(remove_mask, hot.keys[:, :W], INF_KEY)
    removed_v = torch.where(remove_mask, hot.vals[:, :W], 0)
    out_k, out_v = L.topk_of_merged(removed_k.reshape(-1),
                                    removed_v.reshape(-1), m)

    hot = HotTier(*L.remove_at(hot.keys, hot.vals, hot.seq, hot.size,
                               remove_mask))
    n = torch.sum(takeable).to(torch.int32)
    return hot, out_k, out_v, n


def hot_spray_herlihy(hot, total, m, active, draws=None, npods=1):
    return _hot_spray(hot, m, active, draws, adaptive_window=True)


def hot_spray_fraser(hot, total, m, active, draws=None, npods=1):
    return _hot_spray(hot, m, active, draws, adaptive_window=False)


def hot_multiq(hot, total, m, active, draws=None, npods=1):
    """Relaxed MultiQueue (Williams & Sanders): each of the `active`
    deleters samples two shards, reads their cached minima (column 0 of the
    sorted heads) and commits to the one whose minimum is smaller; every
    shard then serves its committed deleters from the head, a prefix pop.
    No cross-shard coordination, and every pop lies within
    `multiq_bound(S, m)` of the global rank w.h.p."""
    if draws is None:
        raise ValueError("MULTIQ needs draws=(choice_a, choice_b)")
    choice_a, choice_b = draws
    dev = hot.keys.device
    lane = torch.arange(m, dtype=torch.int32, device=dev)
    act = lane < torch.clamp(active, max=m)
    counts = L.twochoice_pick(hot.keys[:, 0], choice_a, choice_b, act)
    take = torch.minimum(counts, hot.size)
    out_k, out_v = L.multiq_select(hot.keys[:, :m], hot.vals[:, :m], take)
    hot = _pop_hot_prefix(hot, take)
    n = torch.sum(take).to(torch.int32)
    return hot, out_k, out_v, n


def hot_local(hot, total, m, active, draws=None, npods=1):
    """Ablation lower bound: split the batch evenly, pop per-shard
    prefixes, no ordering between shards."""
    S, H = hot.keys.shape
    dev = hot.keys.device
    base, rem = divmod(m, S)
    quota = base + (torch.arange(S, dtype=torch.int32, device=dev) < rem).to(
        torch.int32)
    excess = torch.clamp(m - active, min=0)
    cum_from_tail = torch.flip(
        torch.cumsum(torch.flip(quota, (0,)), 0, dtype=torch.int32), (0,))
    shrink = torch.minimum(torch.clamp(quota - (cum_from_tail - excess),
                                       min=0), quota)
    quota = quota - shrink
    take = torch.minimum(quota, hot.size)

    W = min(m, H)
    taken_mask = torch.arange(W, device=dev)[None, :] < take[:, None]
    removed_k = torch.where(taken_mask, hot.keys[:, :W], INF_KEY)
    removed_v = torch.where(taken_mask, hot.vals[:, :W], 0)
    out_k, out_v = L.topk_of_merged(removed_k.reshape(-1),
                                    removed_v.reshape(-1), m)
    hot = _pop_hot_prefix(hot, take)
    n = torch.sum(take).to(torch.int32)
    return hot, out_k, out_v, n


HOT_SCHEDULE_FNS = {
    Schedule.STRICT_FLAT: hot_strict_flat,
    Schedule.SPRAY_HERLIHY: hot_spray_herlihy,
    Schedule.HIER: hot_hier,
    Schedule.FFWD: hot_ffwd,
    Schedule.LOCAL: hot_local,
    Schedule.SPRAY_FRASER: hot_spray_fraser,
    Schedule.MULTIQ: hot_multiq,
}


def _wrap(hot_fn):
    def delete_fn(state: PQState, m: int, active: torch.Tensor, draws=None,
                  npods: int = 1) -> DeleteResult:
        state = ensure_head(state, m)
        hot, out_k, out_v, n = hot_fn(hot_tier(state), state.total_size, m,
                                      active, draws, npods)
        return DeleteResult(attach_hot(state, hot), out_k, out_v, n)

    delete_fn.__doc__ = hot_fn.__doc__
    return delete_fn


delete_strict_flat = _wrap(hot_strict_flat)
delete_spray_herlihy = _wrap(hot_spray_herlihy)
delete_hier = _wrap(hot_hier)
delete_ffwd = _wrap(hot_ffwd)
delete_local = _wrap(hot_local)
delete_spray_fraser = _wrap(hot_spray_fraser)
delete_multiq = _wrap(hot_multiq)

SCHEDULE_FNS = {
    Schedule.STRICT_FLAT: delete_strict_flat,
    Schedule.SPRAY_HERLIHY: delete_spray_herlihy,
    Schedule.HIER: delete_hier,
    Schedule.FFWD: delete_ffwd,
    Schedule.LOCAL: delete_local,
    Schedule.SPRAY_FRASER: delete_spray_fraser,
    Schedule.MULTIQ: delete_multiq,
}

