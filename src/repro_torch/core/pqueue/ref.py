"""Host oracle of the sharded bulk priority queue, in numpy.

Counterpart of src/repro/core/pqueue/ref.py, copied: it models the
linearized semantics the queue promises —
  * insert batch: every valid key is added (minus reported drops);
  * exact deleteMin batch: the n smallest (key, then owning shard id, then
    insertion order within the shard) leave, ascending;
  * spray deleteMin batch: any multiset of n keys from the global top
    `spray_bound(S, m)` is admissible, so the oracle checks the envelope
    and multiset conservation instead of equality.
Only the shard hash differs: the port's `utils.hashing` on a CPU tensor.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.pqueue.schedules import (  # noqa: F401  (re-export)
    multiq_bound,
    spray_bound,
)
from repro_torch.core.pqueue.state import INF_KEY
from repro_torch.utils.hashing import shard_of_key


def _shard_of_key_np(keys: np.ndarray, num_shards: int) -> np.ndarray:
    return shard_of_key(torch.as_tensor(np.asarray(keys, np.int32)),
                        num_shards).numpy()


def _per_shard_sorted_keys(items) -> dict:
    per_shard: dict = {}
    for key, shard, _seq, _v in items:
        per_shard.setdefault(shard, []).append(key)
    for s in per_shard:
        per_shard[s].sort()
    return per_shard


class RefPQ:
    """Exact reference: a sorted multiset of (key, shard, seq, val)."""

    def __init__(self, num_shards: int, capacity: int):
        self.S = num_shards
        self.C = capacity
        self._items: List[Tuple[int, int, int, int]] = []
        self._seq_per_shard = [0] * num_shards
        self.total_dropped = 0

    # -- operations ---------------------------------------------------------

    def insert_batch(self, keys, vals, mask=None) -> int:
        keys = np.asarray(keys)
        vals = np.asarray(vals)
        if mask is None:
            mask = keys < INF_KEY
        mask = np.asarray(mask, bool)
        shards = _shard_of_key_np(keys, self.S)
        # The queue's merge order: within a batch the routed runs are sorted
        # by key before merging, and ties with elements already queued go
        # after them, so existing elements have the lower seq.
        order = np.lexsort((np.arange(len(keys)), keys))
        dropped = 0
        per_shard_count = {s: self.shard_size(s) for s in range(self.S)}
        for i in order:
            if not mask[i]:
                continue
            s = int(shards[i])
            if per_shard_count[s] >= self.C:
                dropped += 1
                continue
            self._items.append(
                (int(keys[i]), s, self._seq_per_shard[s], int(vals[i]))
            )
            self._seq_per_shard[s] += 1
            per_shard_count[s] += 1
        self._items.sort()
        self.total_dropped += dropped
        return dropped

    def delete_min_exact(self, n: int):
        """Remove and return the n globally smallest, ascending, ties by
        (key, shard, seq) as the tournament breaks them."""
        n = min(n, len(self._items))
        taken = self._items[:n]
        self._items = self._items[n:]
        return (
            np.array([t[0] for t in taken], np.int64),
            np.array([t[3] for t in taken], np.int64),
        )

    def check_spray_result(self, returned_keys, m: int) -> Tuple[bool, str]:
        """Validate a spray batch against the pre-delete state: every
        returned key lies within the first m + (ilog2(S)+1)^2 elements of
        some shard (the window policy's deterministic guarantee)."""
        pad = (max(int(self.S - 1).bit_length(), 1) + 1) ** 2
        return self._check_shard_window(returned_keys, m + pad)

    def check_multiq_result(self, returned_keys, m: int) -> Tuple[bool, str]:
        """Validate a MULTIQ batch against the pre-delete state: every
        returned key lies within the first m entries of some shard."""
        return self._check_shard_window(returned_keys, m)

    def _check_shard_window(self, returned_keys,
                            window: int) -> Tuple[bool, str]:
        returned_keys = [int(k) for k in returned_keys if k < INF_KEY]
        if not returned_keys:
            return True, "empty"
        per_shard = _per_shard_sorted_keys(self._items)
        for k in returned_keys:
            ranks = [
                keys.index(k) for keys in per_shard.values() if k in keys
            ]
            if not ranks:
                return False, f"key {k} not present pre-delete"
            if min(ranks) >= window:
                return False, (
                    f"key {k} at best shard-rank {min(ranks)} >= window "
                    f"{window}"
                )
        return True, "ok"

    def global_envelope_violations(
        self, returned_keys, m: int, bound: int | None = None
    ) -> Tuple[int, int]:
        """(violations, total): returned keys beyond the probabilistic
        global top-`bound` envelope (default spray_bound(S, m); pass
        multiq_bound(S, m) for MULTIQ)."""
        returned_keys = [int(k) for k in returned_keys if k < INF_KEY]
        if not returned_keys:
            return 0, 0
        if bound is None:
            bound = spray_bound(self.S, m)
        all_keys = sorted(t[0] for t in self._items)
        if len(all_keys) <= bound:
            return 0, len(returned_keys)
        cutoff = all_keys[bound - 1]
        return sum(1 for k in returned_keys if k > cutoff), len(returned_keys)

    def remove_multiset(self, keys) -> bool:
        """Remove an arbitrary returned multiset (relaxed schedules); False
        if a key was not present (a conservation violation)."""
        want = Counter(int(k) for k in keys if k < INF_KEY)
        kept = []
        for item in self._items:
            if want.get(item[0], 0) > 0:
                want[item[0]] -= 1
            else:
                kept.append(item)
        if any(v > 0 for v in want.values()):
            return False
        self._items = kept
        return True

    # -- views --------------------------------------------------------------

    def shard_size(self, s: int) -> int:
        return sum(1 for it in self._items if it[1] == s)

    def key_multiset(self) -> np.ndarray:
        return np.array(sorted(t[0] for t in self._items), np.int64)

    def __len__(self) -> int:
        return len(self._items)
