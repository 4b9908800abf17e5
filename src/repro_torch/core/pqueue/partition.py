"""Routing a batch of (key, value) ops to their owning shards.

Counterpart of src/repro/core/pqueue/partition.py: hash each key to its shard, then build
a dense (S, R) routed matrix, each row ascending and INF-padded.  The
reference's row sorts are stable (`jnp.argsort`), so equal keys of one shard
keep their batch order; the port passes ``stable=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.pqueue.state import INF_KEY
from repro_torch.utils.hashing import shard_of_key


def route_dense(
    keys: torch.Tensor,  # (B,) int32
    vals: torch.Tensor,  # (B,) int32
    mask: torch.Tensor,  # (B,) bool — valid ops
    num_shards: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact routing: (routed_keys (S, B), routed_vals (S, B), counts (S,))."""
    dest = shard_of_key(keys, num_shards)
    dest = torch.where(mask, dest, num_shards)  # invalid -> virtual shard S
    shards = torch.arange(num_shards, dtype=torch.int32, device=keys.device)
    hit = dest[None, :] == shards[:, None]
    routed_keys = torch.where(hit, keys[None, :], INF_KEY)
    routed_keys, order = torch.sort(routed_keys, dim=1, stable=True)
    routed_vals = torch.gather(torch.where(hit, vals[None, :], 0), 1, order)
    counts = torch.sum(hit & mask[None, :], dim=1).to(torch.int32)
    return routed_keys, routed_vals, counts


def route_capped(
    keys: torch.Tensor,
    vals: torch.Tensor,
    mask: torch.Tensor,
    num_shards: int,
    capacity_factor: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoE-style capped routing with R = ceil(B / S * capacity_factor)
    receive slots per shard; ops beyond R are reported in `rejected`.
    Returns (routed_keys (S, R), routed_vals (S, R), counts (S,),
    rejected (B,) bool)."""
    B = keys.shape[0]
    R = max(1, int(-(-B * capacity_factor // num_shards)))
    R = min(R, B)
    dest = shard_of_key(keys, num_shards)
    dest = torch.where(mask, dest, num_shards)
    shards = torch.arange(num_shards, dtype=torch.int32, device=keys.device)
    hit = dest[None, :] == shards[:, None]
    pos_in_shard = torch.cumsum(hit.to(torch.int32), dim=1,
                                dtype=torch.int32) - 1
    pos = torch.sum(torch.where(hit, pos_in_shard, 0), dim=0).to(torch.int32)
    keep = mask & (pos < R)
    rejected = mask & ~keep

    # Scatter into (S + 1, R): rejected and masked lanes land in the spare
    # row S, which is then dropped (the reference's mode="drop").
    d = torch.where(keep, dest, num_shards).to(torch.int64)
    p = torch.where(keep, pos, 0).to(torch.int64)
    routed_keys = torch.full((num_shards + 1, R), INF_KEY, dtype=keys.dtype,
                             device=keys.device)
    routed_vals = torch.zeros((num_shards + 1, R), dtype=vals.dtype,
                              device=keys.device)
    routed_keys.index_put_((d, p), torch.where(keep, keys, INF_KEY))
    routed_vals.index_put_((d, p), torch.where(keep, vals, 0))
    routed_keys, routed_vals = routed_keys[:num_shards], routed_vals[:num_shards]
    routed_keys, order = torch.sort(routed_keys, dim=1, stable=True)
    routed_vals = torch.gather(routed_vals, 1, order)
    counts = torch.clamp(torch.sum(hit, dim=1), max=R).to(torch.int32)
    return routed_keys, routed_vals, counts, rejected
