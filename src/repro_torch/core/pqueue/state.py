"""Sharded priority-queue state — tiered head/tail layout, in PyTorch.

Counterpart of src/repro/core/pqueue/state.py,
whose docstring explains the layout: per shard a sorted hot head block
(S, H) and a cold tail arena (S, T = C - H) holding a bucketed sliding
window (a (key, seq)-sorted run followed by an unsorted append bucket), with
per-shard insertion seqs recording the stable linearization order.

`PQState` is a frozen dataclass of the same 11 int32 tensors, in the same
field order, so `state_fingerprint` is byte-identical to the reference's
for equal states.  Invariants (checked on the host by
`invariant_violations`):
  I1  head_keys[s] is ascending for every shard s
  I2  head_keys[s, head_size[s]:] == INF_KEY and the valid prefix < INF_KEY
  I3  the multiset of valid (key, value) pairs is conserved by every op
      batch (checked by the callers, who know what went in and out)
  I4  head/tail boundary: max(valid head keys) <= min(valid tail keys); for
      equal keys the head holds the smaller sequence numbers
  I5  the tail's valid entries are exactly the window
      [tail_start, tail_start + tail_size); seqs are unique and < next_seq
  I6  the window's leading tail_sorted entries are (key, seq)-lex sorted
      with the seq column ascending, and tail_sorted <= tail_size
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core.errors import InvariantViolation
from repro_torch.utils.hostsync import resolve_device

INF_KEY = 2**31 - 1
DEFAULT_HEAD_WIDTH = 256


@dataclasses.dataclass(frozen=True)
class PQState:
    """Tiered shard state: head_* (S, H) sorted hot tier, tail_* (S, T) cold
    arena, and five (S,) per-shard counters.  Every leaf is int32."""

    head_keys: torch.Tensor  # (S, H) ascending, INF-padded
    head_vals: torch.Tensor  # (S, H) payload
    head_seq: torch.Tensor  # (S, H) per-shard insertion seq
    tail_keys: torch.Tensor  # (S, T) valid in the sliding window only
    tail_vals: torch.Tensor  # (S, T)
    tail_seq: torch.Tensor  # (S, T)
    head_size: torch.Tensor  # (S,)
    tail_size: torch.Tensor  # (S,)
    tail_start: torch.Tensor  # (S,) window origin in the arena
    tail_sorted: torch.Tensor  # (S,) length of the window's sorted run
    next_seq: torch.Tensor  # (S,)

    @property
    def device(self) -> torch.device:
        return self.head_keys.device

    @property
    def num_shards(self) -> int:
        return self.head_keys.shape[0]

    @property
    def head_width(self) -> int:
        return self.head_keys.shape[1]

    @property
    def tail_width(self) -> int:
        return self.tail_keys.shape[1]

    @property
    def capacity(self) -> int:
        return self.head_width + self.tail_width

    @property
    def size(self) -> torch.Tensor:
        """(S,) valid entries per shard across both tiers."""
        return self.head_size + self.tail_size

    @property
    def total_size(self) -> torch.Tensor:
        """() int32."""
        return torch.sum(self.head_size + self.tail_size).to(torch.int32)

    def _tail_window_mask(self) -> torch.Tensor:
        """(S, T) bool — True inside the valid sliding window."""
        col = torch.arange(self.tail_width, dtype=torch.int32,
                           device=self.device)[None, :]
        return (col >= self.tail_start[:, None]) & (
            col < (self.tail_start + self.tail_size)[:, None]
        )

    @property
    def keys(self) -> torch.Tensor:
        """(S, C) head then tail window (stale slots read INF); for
        multiset reads, not for order."""
        if self.tail_width == 0:
            return self.head_keys
        tail_view = torch.where(self._tail_window_mask(), self.tail_keys,
                                INF_KEY)
        return torch.cat([self.head_keys, tail_view], dim=1)

    @property
    def vals(self) -> torch.Tensor:
        """(S, C) payload view matching ``keys``."""
        if self.tail_width == 0:
            return self.head_vals
        tail_view = torch.where(self._tail_window_mask(), self.tail_vals, 0)
        return torch.cat([self.head_vals, tail_view], dim=1)

    @property
    def shard_mins(self) -> torch.Tensor:
        """(S,) cached per-shard minimum: head column 0 (INF when empty)."""
        return self.head_keys[:, 0]


def replace(state: PQState, **changes) -> PQState:
    return dataclasses.replace(state, **changes)


def make_state(num_shards: int, capacity: int, head_width: int | None = None,
               device=None) -> PQState:
    """Empty queue: S shards of capacity C, head tier of min(H, C), on the
    card unless `device` names another."""
    dev = resolve_device(device)
    H = min(head_width if head_width is not None else DEFAULT_HEAD_WIDTH,
            capacity)
    T = capacity - H
    i32 = dict(dtype=torch.int32, device=dev)
    return PQState(
        head_keys=torch.full((num_shards, H), INF_KEY, **i32),
        head_vals=torch.zeros((num_shards, H), **i32),
        head_seq=torch.zeros((num_shards, H), **i32),
        tail_keys=torch.full((num_shards, T), INF_KEY, **i32),
        tail_vals=torch.zeros((num_shards, T), **i32),
        tail_seq=torch.zeros((num_shards, T), **i32),
        head_size=torch.zeros((num_shards,), **i32),
        tail_size=torch.zeros((num_shards,), **i32),
        tail_start=torch.zeros((num_shards,), **i32),
        tail_sorted=torch.zeros((num_shards,), **i32),
        next_seq=torch.zeros((num_shards,), **i32),
    )


def invariant_violations(state: PQState, first_only: bool = True):
    """Host-side validation pass (I1, I2, I4, I5, I6) — a list of
    `InvariantViolation`, empty when the state is healthy; ``first_only``
    stops at the first one."""
    out: list = []

    def _bad(invariant: str, shard: int, detail: str) -> bool:
        out.append(InvariantViolation(invariant, shard, detail))
        return first_only

    def host(t):
        return t.detach().cpu().numpy()

    hk, hq = host(state.head_keys), host(state.head_seq)
    tk, tq = host(state.tail_keys), host(state.tail_seq)
    hsize, tsize = host(state.head_size), host(state.tail_size)
    tstart, tsorted = host(state.tail_start), host(state.tail_sorted)
    nseq = host(state.next_seq)
    S, H = hk.shape
    T = tk.shape[1]
    for s in range(S):
        row, n = hk[s], int(hsize[s])
        if not np.all(row[:-1] <= row[1:]):
            if _bad("I1", s, f"shard {s}: head keys not ascending (I1)"):
                return out
        if n < H and not np.all(row[n:] == INF_KEY):
            if _bad("I2", s,
                    f"shard {s}: head padding not INF beyond size={n} (I2)"):
                return out
        if np.any(row[:n] == INF_KEY):
            if _bad("I2", s, f"shard {s}: INF sentinel inside head prefix (I2)"):
                return out
        tn = int(tsize[s])
        t0 = int(tstart[s])
        if t0 < 0 or t0 + tn > T:
            if _bad("I5", s,
                    f"shard {s}: tail window [{t0},{t0 + tn}) outside arena "
                    f"[0,{T}) (I5)"):
                return out
            tn = 0
        tvalid = tk[s, t0:t0 + tn]
        tqwin = tq[s, t0:t0 + tn]
        if np.any(tvalid == INF_KEY):
            if _bad("I5", s, f"shard {s}: INF inside tail window (I5)"):
                return out
        if tn > 0 and n > 0:
            hmax, tmin = int(row[n - 1]), int(tvalid.min())
            if hmax > tmin:
                if _bad("I4", s,
                        f"shard {s}: head max {hmax} > tail min {tmin} (I4)"):
                    return out
            at_h = hq[s, :n][row[:n] == tmin]
            at_t = tqwin[tvalid == tmin]
            if at_h.size and at_t.size and at_h.max() > at_t.min():
                if _bad("I4", s,
                        f"shard {s}: boundary-tie seq inversion (I4)"):
                    return out
        srt = int(tsorted[s])
        if srt < 0 or srt > tn:
            if _bad("I6", s,
                    f"shard {s}: tail_sorted {srt} outside [0,{tn}] (I6)"):
                return out
            srt = 0
        if srt > 1:
            rk_ = tvalid[:srt].astype(np.int64)
            rq_ = tqwin[:srt].astype(np.int64)
            if np.any(np.diff(rk_) < 0):
                if _bad("I6", s,
                        f"shard {s}: tail sorted run keys descend (I6)"):
                    return out
            if np.any(np.diff(rq_) < 0):
                if _bad("I6", s,
                        f"shard {s}: tail sorted run seqs descend (I6)"):
                    return out
        seqs = np.concatenate([hq[s, :n], tqwin])
        if seqs.size and (seqs.max() >= int(nseq[s]) or
                          np.unique(seqs).size != seqs.size):
            if _bad("I5", s, f"shard {s}: seq not unique/bounded (I5)"):
                return out
        for k in np.unique(row[:n][np.r_[False, row[1:n] == row[: n - 1]]]
                           if n > 1 else []):
            grp = hq[s, :n][row[:n] == k]
            if np.any(np.diff(grp) < 0):
                if _bad("I4", s,
                        f"shard {s}: head equal-key seq disorder (I4)"):
                    return out
    return out


def leaf_bytes(x) -> bytes:
    """A tensor's or numpy array's bytes, C order."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x).tobytes()


def state_fingerprint(state: PQState) -> int:
    """Order-stable CRC32 over every field's bytes (field order fixed by the
    dataclass) — equal to the reference's `state_fingerprint` for a
    bit-identical state.  The leaves may be tensors or numpy arrays (a
    state read to the host)."""
    crc = 0
    for f in dataclasses.fields(state):
        crc = zlib.crc32(leaf_bytes(getattr(state, f.name)),
                         zlib.crc32(f.name.encode(), crc))
    return crc & 0xFFFFFFFF
