"""Plain reference of the serving scheduler's dispatch: which queued
requests each tick hands to the engine, in which order.

A request waits in the priority queue under the key

    (slo_class << 27) + max(prompt_len - 4 * age, 0)

(smaller is sooner; age in ticks since its arrival when it is inserted,
capped below INF_KEY).  A window of K ticks takes the arrival backlog
(first in, first out) and the window's arrivals, at most `ring_capacity`
of them; tick t inserts the next of them that have arrived by t, at most
`lanes`, and spends up to its dispatch budget on deleteMins in the lanes
left over; the remaining lanes are inert inserts (INF key).  The queue is
`portbench.ref.pq.RefSmartPQ`, stepped with the tick's draws and the mode
the program reports.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from portbench.ref import pq as R

# (uid, prompt_len, slo_class, arrival_step)
Req = Tuple[int, int, int, int]


class RefScheduler:
    def __init__(self, cfg: dict):
        self.B = cfg["lanes"]
        self.R = cfg["ring_capacity"]
        self.pq = R.RefSmartPQ(cfg["num_shards"], cfg["capacity"],
                               cfg["head_width"], cfg["lanes"], cfg["npods"],
                               cfg["decision_interval"],
                               cfg["mode_schedules"], cfg["eliminate"],
                               cfg["initial_mode"])
        self.backlog: List[Req] = []
        self.queued = set()
        self.step = 0

    def window(self, arrivals: Sequence[Sequence[Req]],
               budgets: Sequence[int], modes: Sequence[int],
               draws: Sequence) -> List[List[int]]:
        """The uids each of the K ticks dispatches; `draws[t]` is tick t's
        (shard_choice, hi, choice_b)."""
        K, B = len(arrivals), self.B
        for reqs in arrivals:
            self.queued.update(r[0] for r in reqs)
        pending = [(r, 0) for r in self.backlog] + [
            (r, t) for t, reqs in enumerate(arrivals) for r in reqs]
        loaded = pending[:self.R]
        avail = np.searchsorted(np.array([t for _, t in loaded], np.int64),
                                np.arange(K), side="right")
        step0 = self.step
        self.step += K
        head = deferred = 0
        out = []
        for t in range(K):
            n_arr = min(max(int(avail[t]) - head, 0), B)
            n_del = min(max(int(budgets[t]), 0), B - n_arr)
            deferred += max(int(avail[t]) - head - n_arr, 0)
            ops = np.full(B, R.OP_INSERT, np.int64)
            keys = np.full(B, R.INF_KEY, np.int64)
            vals = np.zeros(B, np.int64)
            for i in range(n_arr):
                uid, plen, slo, at = loaded[head + i][0]
                age = max(step0 + t - at, 0)
                keys[i] = min((slo << 27) + max(plen - 4 * age, 0),
                              R.INF_KEY - 1)
                vals[i] = uid
            ops[n_arr:n_arr + n_del] = R.OP_DELETE_MIN
            head += n_arr
            k, v, n = self.pq.step(ops, keys, vals, int(modes[t]), draws[t])
            got = []
            for j in range(n):
                if k[j] < R.INF_KEY and int(v[j]) in self.queued:
                    self.queued.discard(int(v[j]))
                    got.append(int(v[j]))
            out.append(got)
        self.pq.stats["ring_deferred"] += deferred
        self.backlog = [r for r, _ in pending[head:]]
        return out
