"""Plain PyTorch versions of the hand-written kernels.

Counterpart of src/repro/kernels/ref.py:18-35,79-90.
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
