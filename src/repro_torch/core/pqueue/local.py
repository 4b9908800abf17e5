"""Per-shard local primitives, vectorized over the shard axis, in PyTorch.

Counterpart of src/repro/core/pqueue/local.py.
The hot-spot primitives — the windowed head merge of every insert, the
top-k of every deleteMin tournament, the op-log sort of the elimination
pre-pass and MULTIQ's two-choice probe and commit tournament — go through
`repro_torch.kernels.ops`: the hand-written CUDA kernels on the card, their
plain versions on the CPU.

Hot-path functions work on the head tier (S, H), so per-step cost follows
the batch, not the capacity; the cold tail (S, T) is touched by O(batch)
appends and by the rare guarded rebalances.  Each `lax.cond` of the
reference (local.py:388,449,562,627,644,658) is a host read of its predicate
(`utils.hostsync`) followed by the one branch it selects.

Port notes: torch's gather takes int64 indices, `torch.searchsorted` wants
contiguous rows of matching dtype, and an out-of-range scatter raises where
the reference drops it, so drop-scatters write into one spare column that is
then cut off.  The reference's lexicographic (key, seq) sorts
(`jnp.lexsort`) are stable sorts of the packed int64 pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.pqueue.state import INF_KEY, PQState, replace
from repro_torch.kernels import ops as KO
from repro_torch.kernels.ref import lex_pack
from repro_torch.utils.hostsync import host_bool

_INT32_MIN = -(2**31)
_INT32_MAX = 2**31 - 1

# Static width of the tail's unsorted append bucket (local.py:30-34).
TAIL_BUCKET_WIDTH = 256

# Renumber horizon: force a rebalance well before next_seq could wrap int32.
SEQ_RENUMBER_THRESHOLD = _INT32_MAX - (1 << 24)

Tensor = torch.Tensor


def _arange(n: int, device, start: int = 0) -> Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """Row-wise take_along_axis (axis 1); idx broadcasts over rows."""
    if idx.shape[0] != x.shape[0]:
        idx = idx.expand(x.shape[0], idx.shape[1])
    return torch.gather(x, 1, idx.to(torch.int64))


def _searchsorted(rows: Tensor, values: Tensor, right: bool = False) -> Tensor:
    """Row-wise searchsorted, int32 positions."""
    return torch.searchsorted(rows.contiguous(), values.contiguous(),
                              right=right, out_int32=True)


def _i32(x: Tensor) -> Tensor:
    return x.to(torch.int32)


def _key_seq_order(keys: Tensor, seq: Tensor) -> Tensor:
    """Row-wise stable argsort by (key, seq) lexicographic."""
    return torch.sort(lex_pack(keys, seq), dim=1, stable=True).indices


# ---------------------------------------------------------------------------
# windowed merge — the insert hot spot
# ---------------------------------------------------------------------------


def merge_head_run(head_k, head_v, head_q, run_k, run_v, run_q):
    """Full-width merge of two ascending runs, (S, H) + (S, R) -> (S, H+R),
    positional-stable (head before run): the `windowed_merge` kernel."""
    return KO.windowed_merge(*(t.contiguous() for t in (
        head_k, head_v, head_q, run_k, run_v, run_q)))


# ---------------------------------------------------------------------------
# head-tier removal primitives (O(H) per shard)
# ---------------------------------------------------------------------------


def remove_prefix(keys, vals, seq, size, take):
    """Remove the `take[s]` smallest elements (a prefix) of each shard's
    sorted head: a per-row left shift."""
    S, W = keys.shape
    idx = _arange(W, keys.device)[None, :] + take[:, None]
    in_range = idx < W
    idx = torch.clamp(idx, max=W - 1)
    new_keys = torch.where(in_range, _take(keys, idx), INF_KEY)
    new_vals = torch.where(in_range, _take(vals, idx), 0)
    new_seq = torch.where(in_range, _take(seq, idx), 0)
    new_size = _i32(torch.clamp(size - take, min=0))
    return new_keys, new_vals, new_seq, new_size


def remove_at(keys, vals, seq, size, remove_mask):
    """Remove arbitrary positions inside the static spray window W <= H:
    survivors compact to the front of the window (searchsorted over the
    cumulative keep count), then the untouched suffix shifts left behind
    them."""
    S, H = keys.shape
    W = remove_mask.shape[1]
    assert W <= H, (W, H)
    dev = keys.device
    win_k = keys[:, :W]
    hit = remove_mask & (win_k != INF_KEY)
    n_removed = _i32(torch.sum(hit, dim=1))

    keep_rank = torch.cumsum(_i32(~remove_mask), dim=1, dtype=torch.int32)
    q = _arange(W, dev, start=1)[None, :].expand(S, W)
    src = _searchsorted(keep_rank, q)
    src_ok = src < W
    src = torch.clamp(src, max=W - 1)
    win_sorted_k = torch.where(src_ok, _take(win_k, src), INF_KEY)
    win_sorted_v = torch.where(src_ok, _take(vals[:, :W], src), 0)
    win_sorted_q = torch.where(src_ok, _take(seq[:, :W], src), 0)
    pad = H - W
    if pad:
        win_sorted_k = torch.nn.functional.pad(win_sorted_k, (0, pad),
                                               value=INF_KEY)
        win_sorted_v = torch.nn.functional.pad(win_sorted_v, (0, pad))
        win_sorted_q = torch.nn.functional.pad(win_sorted_q, (0, pad))

    v_in_win = torch.clamp(size, max=W) - n_removed
    shift = W - v_in_win
    col = _arange(H, dev)[None, :]
    suf_idx = col + shift[:, None]
    suf_ok = suf_idx < H
    suf_idx = torch.clamp(suf_idx, max=H - 1)
    suf_k = torch.where(suf_ok, _take(keys, suf_idx), INF_KEY)
    suf_v = torch.where(suf_ok, _take(vals, suf_idx), 0)
    suf_q = torch.where(suf_ok, _take(seq, suf_idx), 0)

    sel = col < v_in_win[:, None]
    new_keys = torch.where(sel, win_sorted_k, suf_k)
    new_vals = torch.where(sel, win_sorted_v, suf_v)
    new_seq = torch.where(sel, win_sorted_q, suf_q)
    new_size = _i32(torch.clamp(size - n_removed, min=0))
    return new_keys, new_vals, new_seq, new_size


# ---------------------------------------------------------------------------
# bucketed tail arena: sorted run + append bucket, merge-on-rebalance
# ---------------------------------------------------------------------------


def _renumber_seqs(head_seq, tail_seq, head_size, tail_size):
    """Positional seq renumbering (head slot i -> i, tail slot j ->
    head_size + j; next_seq -> the shard population).  Precondition: slot
    order == linearization order in both tiers."""
    S, H = head_seq.shape
    T = tail_seq.shape[1]
    dev = head_seq.device
    col_h = _arange(H, dev)[None, :]
    new_hq = torch.where(col_h < head_size[:, None], col_h, 0)
    if T:
        col_t = _arange(T, dev)[None, :]
        new_tq = torch.where(col_t < tail_size[:, None],
                             head_size[:, None] + col_t, 0)
    else:
        new_tq = tail_seq
    return new_hq, new_tq, _i32(head_size + tail_size)


def _tail_window(state: PQState):
    """Masked (key, val, seq) views of the tail's sliding window: stale
    out-of-window slots read (INF, 0, 0)."""
    win = state._tail_window_mask()
    return (
        torch.where(win, state.tail_keys, INF_KEY),
        torch.where(win, state.tail_vals, 0),
        torch.where(win, state.tail_seq, 0),
    )


def _full_sort_tail(state: PQState) -> PQState:
    """Fallback compaction: (key, seq)-lex sort of the tail window, then
    renumber; the window re-anchors at 0."""
    wk, wv, wq = _tail_window(state)
    order = _key_seq_order(wk, wq)
    tk, tv, tq = (torch.gather(x, 1, order) for x in (wk, wv, wq))
    hq, tq, nseq = _renumber_seqs(state.head_seq, tq, state.head_size,
                                  state.tail_size)
    return replace(
        state, tail_keys=tk, tail_vals=tv, tail_seq=tq, head_seq=hq,
        tail_start=torch.zeros_like(state.tail_start),
        tail_sorted=state.tail_size, next_seq=nseq,
    )


def _bucket_merge_tail(state: PQState) -> PQState:
    """Sort the append bucket and rank-merge it into the sorted run: the
    count of run elements lex-below a bucket element is
    clip(ss(run.seq, b.seq), ss(run.key, b.key, L), ss(run.key, b.key, R)),
    since the run's seq column is globally ascending."""
    S, T = state.tail_keys.shape
    dev = state.device
    U = min(T, TAIL_BUCKET_WIDTH)
    a_len = state.tail_sorted
    b_len = state.tail_size - a_len
    t0 = state.tail_start
    col_t = _arange(T, dev)[None, :]
    col_u = _arange(U, dev)[None, :]

    # -- extract + lex-sort the bucket (window offset t0 + a_len) ------------
    gidx = torch.clamp(t0[:, None] + a_len[:, None] + col_u, 0, T - 1)
    b_valid = col_u < b_len[:, None]
    bk = torch.where(b_valid, _take(state.tail_keys, gidx), INF_KEY)
    bv = torch.where(b_valid, _take(state.tail_vals, gidx), 0)
    bq = torch.where(b_valid, _take(state.tail_seq, gidx), _INT32_MAX)
    order = _key_seq_order(bk, bq)
    bk, bv, bq = (torch.gather(x, 1, order) for x in (bk, bv, bq))

    # -- 0-aligned view of the sorted run ------------------------------------
    a_idx = torch.clamp(t0[:, None] + col_t, 0, T - 1)
    a_valid = col_t < a_len[:, None]
    ak = torch.where(a_valid, _take(state.tail_keys, a_idx), INF_KEY)
    av = torch.where(a_valid, _take(state.tail_vals, a_idx), 0)
    aq = torch.where(a_valid, _take(state.tail_seq, a_idx), _INT32_MAX)

    # -- lexicographic ranks of bucket elements in the run -------------------
    lo = _searchsorted(ak, bk)
    hi = _searchsorted(ak, bk, right=True)
    sq = _searchsorted(aq, bq)
    pos_b = torch.minimum(torch.maximum(sq, lo), hi) + col_u  # (S, U)

    # -- scatter bucket (positions >= T go to the spare column T and are
    # dropped), fill the run into the complement slots ---------------------
    pos_d = torch.clamp(pos_b, max=T).to(torch.int64)

    def scatter(fill, src):
        out = torch.full((S, T + 1), fill, dtype=torch.int32, device=dev)
        return out.scatter_(1, pos_d, src)[:, :T]

    occ = scatter(0, torch.ones_like(bk))
    sk = scatter(INF_KEY, bk)
    sv = scatter(0, bv)
    sq_out = scatter(0, bq)
    run_idx = torch.clamp(col_t - torch.cumsum(occ, dim=1, dtype=torch.int32),
                          0, T - 1)
    is_b = occ == 1
    mk = torch.where(is_b, sk, _take(ak, run_idx))
    mv = torch.where(is_b, sv, _take(av, run_idx))
    mq = torch.where(is_b, sq_out, _take(aq, run_idx))

    out_valid = col_t < state.tail_size[:, None]
    mk = torch.where(out_valid, mk, INF_KEY)
    mv = torch.where(out_valid, mv, 0)
    mq = torch.where(out_valid, mq, 0)
    hq, mq, nseq = _renumber_seqs(state.head_seq, mq, state.head_size,
                                  state.tail_size)
    return replace(
        state, tail_keys=mk, tail_vals=mv, tail_seq=mq, head_seq=hq,
        tail_start=torch.zeros_like(state.tail_start),
        tail_sorted=state.tail_size, next_seq=nseq,
    )


def compact_tail(state: PQState) -> PQState:
    """Make the tail fully sorted (tail_sorted == tail_size) and renumber
    seqs: the bucket merge when every shard's bucket fits the static width,
    the full sort otherwise."""
    if state.tail_width == 0:
        return state
    U = min(state.tail_width, TAIL_BUCKET_WIDTH)
    if host_bool(torch.all(state.tail_size - state.tail_sorted <= U),
                 "local.compact_tail"):
        return _bucket_merge_tail(state)
    return _full_sort_tail(state)


# ---------------------------------------------------------------------------
# tiered insert + rebalance
# ---------------------------------------------------------------------------


def tiered_insert(state: PQState, rk: Tensor, rv: Tensor,
                  counts: Tensor) -> Tuple[PQState, Tensor]:
    """Insert routed runs (S, R) into the tiered state; returns (state,
    dropped).  Head-bound keys (strictly below the head's max when the tail
    is non-empty) merge into the hot tier through the windowed merge; the
    merge's spill and the tail-bound keys append to the tail's bucket.  A
    guarded compaction runs first when the bucket would outgrow its width
    (or the window the arena, or next_seq the wrap horizon), and a guarded
    overflow path keeps the C smallest and reports the rest as dropped."""
    S, H = state.head_keys.shape
    T = state.tail_width
    R = rk.shape[1]
    dev = state.device
    col = _arange(R, dev)[None, :]
    valid = col < counts[:, None]

    if T == 0:
        rq = torch.where(valid, state.next_seq[:, None] + col, 0)
        mk, mv, mq = merge_head_run(state.head_keys, state.head_vals,
                                    state.head_seq, rk, rv, rq)
        dropped = _i32(torch.clamp(state.head_size + counts - H, min=0))
        new_state = replace(
            state,
            head_keys=mk[:, :H].contiguous(),
            head_vals=mv[:, :H].contiguous(),
            head_seq=mq[:, :H].contiguous(),
            head_size=_i32(torch.clamp(state.head_size + counts, max=H)),
            next_seq=state.next_seq + counts,
        )
        return new_state, dropped

    U = min(T, TAIL_BUCKET_WIDTH)
    bucket_after = state.tail_size - state.tail_sorted + counts
    need_compact = (
        torch.any(bucket_after > U)
        | torch.any(state.tail_start + state.tail_size + counts > T)
        | torch.any(state.next_seq + counts > SEQ_RENUMBER_THRESHOLD)
    )
    if host_bool(need_compact, "local.insert_compact"):
        state = compact_tail(state)
    rq = torch.where(valid, state.next_seq[:, None] + col, 0)

    # -- strict boundary split ------------------------------------------------
    hmax = _take(state.head_keys,
                 torch.clamp(state.head_size - 1, 0, H - 1)[:, None])[:, 0]
    hmax = torch.where(state.head_size > 0, hmax, _INT32_MIN)
    bkey = torch.where(state.tail_size > 0, hmax, INF_KEY)
    n_head = _searchsorted(rk, bkey[:, None])[:, 0]

    hb_sel = col < n_head[:, None]
    hrun_k = torch.where(hb_sel, rk, INF_KEY)
    hrun_v = torch.where(hb_sel, rv, 0)
    hrun_q = torch.where(hb_sel, rq, 0)

    n_tail_inc = counts - n_head
    t_idx = torch.clamp(col + n_head[:, None], max=R - 1)
    tb_sel = col < n_tail_inc[:, None]
    trun_k = torch.where(tb_sel, _take(rk, t_idx), INF_KEY)
    trun_v = torch.where(tb_sel, _take(rv, t_idx), 0)
    trun_q = torch.where(tb_sel, _take(rq, t_idx), 0)

    # -- hot-tier merge + spill ----------------------------------------------
    mk, mv, mq = merge_head_run(state.head_keys, state.head_vals,
                                state.head_seq, hrun_k, hrun_v, hrun_q)
    nh_k, nh_v, nh_q = mk[:, :H], mv[:, :H], mq[:, :H]
    sp_k, sp_v, sp_q = mk[:, H:], mv[:, H:], mq[:, H:]  # (S, R) spill run
    n_spill = _i32(torch.clamp(state.head_size + n_head - H, min=0))
    new_hsize = _i32(torch.clamp(state.head_size + n_head, max=H))

    n_append = n_tail_inc + n_spill
    valid_total = state.head_size + state.tail_size + counts

    if not host_bool(torch.any(state.tail_size + n_append > T),
                     "local.insert_spill"):
        # Gather append: the combined append run is trun ++ spill (width
        # 2R); tail slot t takes arun[t - window end] inside the append
        # window and keeps its value elsewhere.
        col2 = _arange(2 * R, dev)[None, :]
        in_trun = col2 < n_tail_inc[:, None]
        idx_tr = torch.clamp(col2, 0, R - 1)
        idx_sp = torch.clamp(col2 - n_tail_inc[:, None], 0, R - 1)

        def arun(trun_x, sp_x):
            return torch.where(in_trun, _take(trun_x, idx_tr),
                               _take(sp_x, idx_sp))

        colT = _arange(T, dev)[None, :]
        rel = colT - (state.tail_start + state.tail_size)[:, None]
        in_app = (rel >= 0) & (rel < n_append[:, None])
        rel_c = torch.clamp(rel, 0, 2 * R - 1)

        def splice(tail_x, trun_x, sp_x):
            return torch.where(in_app, _take(arun(trun_x, sp_x), rel_c),
                               tail_x)

        new_state = replace(
            state,
            head_keys=nh_k.contiguous(), head_vals=nh_v.contiguous(),
            head_seq=nh_q.contiguous(),
            tail_keys=splice(state.tail_keys, trun_k, sp_k),
            tail_vals=splice(state.tail_vals, trun_v, sp_v),
            tail_seq=splice(state.tail_seq, trun_q, sp_q),
            head_size=new_hsize,
            tail_size=_i32(state.tail_size + n_append),
            next_seq=state.next_seq + counts,
        )
        return new_state, torch.zeros((S,), dtype=torch.int32, device=dev)

    # -- overflow: keep the C smallest of the union, report the rest --------
    wk, wv, wq = _tail_window(state)
    cat_k = torch.cat([nh_k, wk, trun_k, sp_k], dim=1)
    cat_v = torch.cat([nh_v, wv, trun_v, sp_v], dim=1)
    cat_q = torch.cat([nh_q, wq, trun_q, sp_q], dim=1)
    order = _key_seq_order(cat_k, cat_q)[:, : H + T]
    sk, sv, sq = (torch.gather(x, 1, order) for x in (cat_k, cat_v, cat_q))
    dropped = _i32(torch.clamp(valid_total - (H + T), min=0))
    hsize_new = _i32(torch.clamp(valid_total, max=H))
    tsize_new = _i32(torch.clamp(valid_total - H, 0, T))
    hq_new, tq_new, nseq_new = _renumber_seqs(sq[:, :H], sq[:, H:],
                                              hsize_new, tsize_new)
    new_state = replace(
        state,
        head_keys=sk[:, :H].contiguous(), head_vals=sv[:, :H].contiguous(),
        head_seq=hq_new,
        tail_keys=sk[:, H:].contiguous(), tail_vals=sv[:, H:].contiguous(),
        tail_seq=tq_new,
        head_size=hsize_new, tail_size=tsize_new,
        tail_start=torch.zeros((S,), dtype=torch.int32, device=dev),
        tail_sorted=tsize_new, next_seq=nseq_new,
    )
    return new_state, dropped


def _consume_run(state: PQState) -> PQState:
    """Pull the sorted run's front into the head and advance the window
    origin (an affine per-row gather: boundary invariant I4 makes the run
    concatenate after the head prefix).  Precondition: empty bucket."""
    S, H = state.head_keys.shape
    T = state.tail_width
    dev = state.device
    take = _i32(torch.minimum(H - state.head_size, state.tail_size))
    col = _arange(H, dev)[None, :]
    rel = col - state.head_size[:, None]
    use_run = (rel >= 0) & (rel < take[:, None])
    ridx = torch.clamp(state.tail_start[:, None] + rel, 0, T - 1)

    def splice(head_x, tail_x):
        return torch.where(use_run, _take(tail_x, ridx), head_x)

    return replace(
        state,
        head_keys=splice(state.head_keys, state.tail_keys),
        head_vals=splice(state.head_vals, state.tail_vals),
        head_seq=splice(state.head_seq, state.tail_seq),
        head_size=_i32(state.head_size + take),
        tail_size=_i32(state.tail_size - take),
        tail_start=_i32(state.tail_start + take),
        tail_sorted=_i32(state.tail_size - take),
    )


def refill_head(state: PQState) -> PQState:
    """Restore the hot tier from the tail's (key, seq)-smallest elements:
    compact the tail if appends left a bucket, then consume the run."""
    if state.tail_width == 0:
        return state
    if host_bool(torch.any(state.tail_size > state.tail_sorted),
                 "local.refill_head"):
        state = compact_tail(state)
    return _consume_run(state)


def refill_head_guarded(state: PQState, pred: bool) -> PQState:
    """`refill_head` under a predicate already read on the host."""
    if state.tail_width == 0 or not pred:
        return state
    return refill_head(state)


# ---------------------------------------------------------------------------
# legacy full-width merge (the reference for the `merge_sorted` kernel; the
# insert path merges into the head tier instead, `merge_head_run`)
# ---------------------------------------------------------------------------


def merge_sorted(keys, vals, inc_keys, inc_vals, size, inc_count):
    """Merge an ascending INF-padded run (S, R) into each shard's ascending
    buffer (S, C), keeping the C smallest: a rank merge, stable toward the
    existing elements (src/repro/core/pqueue/local.py:676-714).  Returns
    (new_keys, new_vals, new_size, dropped)."""
    S, C = keys.shape
    R = inc_keys.shape[1]
    dev = keys.device
    rank_exist = _searchsorted(inc_keys, keys)
    rank_inc = _searchsorted(keys, inc_keys, right=True)
    pos_exist = _arange(C, dev)[None, :] + rank_exist
    pos_inc = _arange(R, dev)[None, :] + rank_inc
    pos_inc = torch.where(inc_keys == INF_KEY, C + R, pos_inc)
    # positions reach C + R; every one at or past C is dropped with the
    # spare columns
    out_k = torch.full((S, C + R + 1), INF_KEY, dtype=keys.dtype, device=dev)
    out_v = torch.zeros((S, C + R + 1), dtype=vals.dtype, device=dev)
    for pos, k, v in ((pos_exist, keys, vals), (pos_inc, inc_keys, inc_vals)):
        out_k.scatter_(1, pos.to(torch.int64), k)
        out_v.scatter_(1, pos.to(torch.int64), v)
    new_size = _i32(torch.clamp(size + inc_count, max=C))
    dropped = _i32(torch.clamp(size + inc_count - C, min=0))
    return out_k[:, :C], out_v[:, :C], new_size, dropped


# ---------------------------------------------------------------------------
# elimination pre-pass primitive
# ---------------------------------------------------------------------------


def sort_op_log(masked_keys: Tensor) -> Tuple[Tensor, Tensor]:
    """Stable ascending sort of each row of an operation log ((B,) or
    (K, B) insert keys, INF for non-inserts): (sorted_keys, sorted_lane_tags),
    through the `elim_sort` kernel."""
    single = masked_keys.dim() == 1
    rows = masked_keys[None, :] if single else masked_keys
    K, B = rows.shape
    tags = _arange(B, rows.device)[None, :].expand(K, B).contiguous()
    sk, st = KO.elim_sort(rows.contiguous(), tags)
    return (sk[0], st[0]) if single else (sk, st)


# ---------------------------------------------------------------------------
# tournament primitives
# ---------------------------------------------------------------------------


def topk_of_merged(cand_keys: Tensor, cand_vals: Tensor,
                   m: int) -> Tuple[Tensor, Tensor]:
    """Global tournament: the m smallest of N candidates, ascending, ties by
    position.  int32 keys go through the `topk_smallest` kernel on
    (key, position-tag) pairs and payloads follow by tag."""
    if cand_keys.dtype == torch.int32:
        n = cand_keys.shape[0]
        tags = _arange(n, cand_keys.device)[None, :]
        kk, kt = KO.topk_smallest(cand_keys.reshape(1, n).contiguous(), tags,
                                  m)
        return kk[0], cand_vals[kt[0].to(torch.int64)]
    order = torch.sort(cand_keys, stable=True).indices[:m]
    return cand_keys[order], cand_vals[order]


def twochoice_pick(shard_mins: Tensor, choice_a: Tensor, choice_b: Tensor,
                   act: Tensor) -> Tensor:
    """MULTIQ probe/commit: each active lane commits to the sampled shard
    with the smaller cached min (tie: lower id); per-shard commit counts
    (S,), through the `twochoice_pick` kernel."""
    return KO.twochoice_counts(shard_mins, choice_a, choice_b, act)


def multiq_select(win_k: Tensor, win_v: Tensor,
                  take: Tensor) -> Tuple[Tensor, Tensor]:
    """The MULTIQ commit tournament: the m smallest of the take-prefixes of
    the (S, m) ascending head windows, ascending, through the
    `multiq_select` kernel."""
    return KO.multiq_select_topm(win_k, win_v, take)


def count_winners_per_shard(cand_keys: Tensor, threshold_key: Tensor,
                            winners_needed: Tensor) -> Tensor:
    """How many elements each shard loses to the tournament: everything
    strictly below the cutoff, and cutoff ties allotted by shard id."""
    below = _i32(torch.sum(cand_keys < threshold_key, dim=1))
    at = _i32(torch.sum(cand_keys == threshold_key, dim=1))
    remaining = winners_needed - _i32(torch.sum(below))
    tie_prefix = torch.cumsum(at, dim=0, dtype=torch.int32) - at
    tie_take = torch.minimum(torch.clamp(remaining - tie_prefix, min=0), at)
    return below + tie_take
