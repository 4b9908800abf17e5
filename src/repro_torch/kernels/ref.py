"""Plain PyTorch versions of the hand-written kernels.

Counterpart of src/repro/kernels/ref.py:18-90.
The order is LEXICOGRAPHIC on (key, tag) for signed int32 keys and tags:
the pair packs into one int64, ``key * 2**32 + (tag + 2**31)``, whose
ordinary order is that lexicographic order, and a stable sort of the packed
words gives the permutation.  Callers pass unique position tags and gather
payloads by tag afterwards, which makes every network deterministic and lets
the tests demand exact equality with the kernels and with the JAX package.

These run on whatever device their tensors are on: the CPU path of
`kernels.ops` calls them, and `chip_smoke.py` holds each CUDA kernel against
them on the card.
"""

from __future__ import annotations

import torch

INF_KEY = 2**31 - 1


def lex_pack(keys: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """int64 words ordered like the (key, tag) pairs, lexicographically."""
    return keys.to(torch.int64) * (1 << 32) + (tags.to(torch.int64) + (1 << 31))


def _lex_order(keys: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    return torch.sort(lex_pack(keys, tags), dim=-1, stable=True).indices


def elim_sort_ref(keys: torch.Tensor, tags: torch.Tensor):
    """(R, N) -> full row-wise ascending sort of (key, tag) pairs."""
    order = _lex_order(keys, tags)
    return torch.gather(keys, -1, order), torch.gather(tags, -1, order)


def topk_smallest_ref(keys: torch.Tensor, vals: torch.Tensor, k: int):
    """(R, N) -> the k lexicographically smallest (key, val) per row,
    ascending (min(k, N) columns)."""
    order = _lex_order(keys, vals)[..., :k]
    return torch.gather(keys, -1, order), torch.gather(vals, -1, order)


def windowed_merge_ref(head_k, head_v, head_q, run_k, run_v, run_q):
    """(S, H) head + (S, R) run (both ascending, INF-padded) -> the full
    (S, H+R) merged (key, val, seq) window, ascending and lexicographic on
    (key, position): head before run, in position within each.  Val and seq
    follow their key; lanes holding the INF sentinel read val = seq = 0."""
    cat_k = torch.cat([head_k, run_k], dim=1)
    out_k, order = torch.sort(cat_k, dim=1, stable=True)
    valid = out_k < INF_KEY
    out_v = torch.where(valid, torch.gather(torch.cat([head_v, run_v], 1), 1,
                                            order), 0)
    out_q = torch.where(valid, torch.gather(torch.cat([head_q, run_q], 1), 1,
                                            order), 0)
    return out_k, out_v, out_q


def twochoice_counts_ref(mins, choice_a, choice_b, act):
    """Two-choice probe/commit: per-shard commit counts (S,) int32.  Lane l
    commits to choice_a[l] when its cached min is smaller, or equal with
    choice_a[l] <= choice_b[l] (ties toward the lower shard id), else to
    choice_b[l]; inactive lanes (act == 0) are parked at S and dropped."""
    S = mins.shape[0]
    min_a = mins[choice_a.to(torch.int64)]
    min_b = mins[choice_b.to(torch.int64)]
    pick_a = (min_a < min_b) | ((min_a == min_b) & (choice_a <= choice_b))
    chosen = torch.where(pick_a, choice_a, choice_b)
    chosen = torch.where(act != 0, chosen, S).to(torch.int64)
    ones = torch.ones_like(chosen, dtype=torch.int32)
    return torch.zeros((S + 1,), dtype=torch.int32,
                       device=mins.device).scatter_add_(0, chosen, ones)[:S]


def multiq_select_ref(win_k, win_v, take):
    """(S, m) ascending head windows + (S,) takes -> the m smallest of the
    windows' take-prefixes as two (m,) tensors (key, val), ascending and
    lexicographic on (key, position tag s * m + column), the vals gathered
    by tag; lanes past the popped count, and popped INF keys, read
    (INF, 0).  The reference's `multiq_select_ref` on tags plus the gather
    of its wrapper (src/repro/kernels/ops.py:180-197)."""
    S, m = win_k.shape
    dev = win_k.device
    col = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    mask = col < take[:, None]
    tags = torch.arange(S * m, dtype=torch.int32, device=dev).reshape(S, m)
    mk = torch.where(mask, win_k, INF_KEY).reshape(-1)
    mt = torch.where(mask, tags, INF_KEY).reshape(-1)
    order = _lex_order(mk, mt)[:m]
    out_k, out_t = mk[order], mt[order]
    live = out_k < INF_KEY
    safe_t = torch.clamp(out_t, 0, S * m - 1).to(torch.int64)
    out_v = torch.where(live, win_v.reshape(-1)[safe_t], 0)
    return out_k, out_v


def merge_sorted_runs_ref(buf_k, buf_v, run_k, run_v):
    """(S, C) buffer + (S, R) run (rows ascending, INF-padded) -> the
    smallest C of each row's union, ascending, lexicographic on (key, val)."""
    C = buf_k.shape[-1]
    cat_k = torch.cat([buf_k, run_k], dim=-1)
    cat_v = torch.cat([buf_v, run_v], dim=-1)
    order = _lex_order(cat_k, cat_v)[..., :C]
    return torch.gather(cat_k, -1, order), torch.gather(cat_v, -1, order)
