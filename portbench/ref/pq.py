"""Plain reference of the SmartPQ semantics, in numpy and Python lists.

It replays the same operations on the same data as the program and says
what every deleteMin must return, what every shard must hold and what the
statistics must read.  It imports nothing of the program: the shard hash
is re-implemented here from its definition (a 32-bit xorshift-multiply
finalizer), and each schedule from the semantics it promises:

* a shard is one sequence ordered by (key, insertion order); its hot head
  is a prefix of that sequence, of a length modelled below;
* an insert batch goes to each key's shard; within a batch equal keys of
  one shard keep their lane order, after everything already queued;
* the elimination pre-pass serves the batch's smallest inserts that lie
  strictly below the queue minimum straight to the batch's deleteMins;
* the exact schedules (HIER, STRICT_FLAT, FFWD) remove the n smallest by
  (key, shard, position), n = min(active deleters, queue size);
* the spray (SPRAY_HERLIHY) sends each active deleter to its drawn shard;
  each shard removes, from a window at its head, the slots with the
  smallest drawn scores;
* MULTIQ sends each active deleter to the drawn shard whose minimum is
  smaller (ties to the lower id); each shard pops that many from its head.

The decision tree is the program's own state and is not re-derived: the
reference follows the mode each step reports, and checks that it changes
only on a decision step.  Everything else is computed here.
"""

from __future__ import annotations

import bisect
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

INF_KEY = 2**31 - 1
INT32_MIN = -(2**31)
OP_INSERT, OP_DELETE_MIN, OP_NOP = 0, 1, 2
EXACT = ("STRICT_FLAT", "HIER", "FFWD")  # schedules as configurations name them
_MASK = 0xFFFFFFFF


def shard_of_key(keys, num_shards: int) -> np.ndarray:
    """The owning shard of each int32 key: the 32-bit finalizer
    h ^= h >> 16; h *= 0x9E3779B1; h ^= h >> 13; h *= 0xC2B2AE35;
    h ^= h >> 16 (uint32 arithmetic), then h mod S."""
    h = np.asarray(keys, np.int64) & _MASK
    h ^= h >> 16
    h = (h * 0x9E3779B1) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return (h % num_shards).astype(np.int64)


def ilog2(n: int) -> int:
    return max(int(n - 1).bit_length(), 1)


def head_pad(num_shards: int) -> int:
    """The spray window's padding, (ilog2(S) + 1)^2."""
    return (ilog2(num_shards) + 1) ** 2


def _key(p: int) -> int:
    return p >> 32


class Sorted:
    """A sorted sequence of ints kept in blocks (a list of sorted lists
    with their largest items), so an insert moves one block's items and
    not the whole shard's."""

    BLOCK = 1024

    def __init__(self, items=()):
        items = list(items)
        B = self.BLOCK
        self.blocks = [items[i:i + B] for i in range(0, len(items), B)]
        self.maxes = [b[-1] for b in self.blocks]
        self.n = len(items)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> int:
        for b in self.blocks:
            if i < len(b):
                return b[i]
            i -= len(b)
        raise IndexError(i)

    def __iter__(self):
        for b in self.blocks:
            yield from b

    def first(self, k: int) -> List[int]:
        out: List[int] = []
        for b in self.blocks:
            if len(out) >= k:
                break
            out += b[:k - len(out)]
        return out

    def copy(self) -> "Sorted":
        out = Sorted()
        out.blocks = [list(b) for b in self.blocks]
        out.maxes = list(self.maxes)
        out.n = self.n
        return out

    def insort(self, w: int) -> None:
        """Insert after every equal item."""
        self.n += 1
        if not self.blocks:
            self.blocks, self.maxes = [[w]], [w]
            return
        i = min(bisect.bisect_right(self.maxes, w), len(self.blocks) - 1)
        b = self.blocks[i]
        bisect.insort(b, w)
        self.maxes[i] = b[-1]
        if len(b) > 2 * self.BLOCK:
            half = len(b) // 2
            self.blocks[i:i + 1] = [b[:half], b[half:]]
            self.maxes[i:i + 1] = [b[half - 1], b[-1]]

    def delete(self, positions) -> None:
        """Remove the items at `positions` (of the current order)."""
        for p in sorted(positions, reverse=True):
            for i, b in enumerate(self.blocks):
                if p < len(b):
                    del b[p]
                    if b:
                        self.maxes[i] = b[-1]
                    else:
                        del self.blocks[i], self.maxes[i]
                    break
                p -= len(b)
        self.n -= len(positions)

    def truncate(self, n: int) -> None:
        items = list(self)[:n]
        self.__init__(items)


class RefSmartPQ:
    """The queue as S sorted sequences of packed (key << 32) + insertion
    counter words (signed, so their order is (key, counter)), the modelled
    head length of each shard, the payloads by counter, and the
    statistics."""

    def __init__(self, num_shards: int, capacity: int, head_width: int,
                 lanes: int, npods: int, decision_interval: int,
                 schedules: Sequence[str], eliminate: bool,
                 initial_mode: int):
        self.S, self.C, self.H = num_shards, capacity, head_width
        self.B = lanes
        self.npods = npods
        self.di = decision_interval
        self.schedules = tuple(schedules)
        self.eliminate = eliminate
        self.pad = head_pad(num_shards)
        self.W = min(lanes + self.pad, head_width)  # the spray window
        self.shards: List[Sorted] = [Sorted() for _ in range(num_shards)]
        self.head = [0] * num_shards
        self.vals: List[int] = []
        self.dropped = 0
        self.stats = dict(step=0, mode=initial_mode, n_insert=0, n_delete=0,
                          min_key=INF_KEY, max_key=0, transitions=0,
                          eliminated=0, rejected=0,
                          mode_steps=[0] * len(schedules), head_refills=0,
                          ring_deferred=0)
        self.faults: List[str] = []
        # Work tallies for the least bytes a window needs: head rows changed
        # (a shard's in one step counts once) and inserts that reached a
        # shard.
        self.head_rows = 0
        self.queued = 0
        self._touched: set = set()

    # -- copies --------------------------------------------------------------

    def snapshot(self):
        return ([s.copy() for s in self.shards], list(self.head),
                {k: (list(v) if isinstance(v, list) else v)
                 for k, v in self.stats.items()})

    def restore(self, snap) -> None:
        shards, head, stats = snap
        self.shards = [s.copy() for s in shards]
        self.head = list(head)
        self.stats = {k: (list(v) if isinstance(v, list) else v)
                      for k, v in stats.items()}

    # -- insert --------------------------------------------------------------

    def _new_words(self, keys, vals) -> List[int]:
        base = len(self.vals)
        self.vals.extend(int(v) for v in vals)
        return [(int(k) << 32) + base + i for i, k in enumerate(keys)]

    def prefill(self, keys: np.ndarray, vals: np.ndarray,
                batch: int) -> None:
        """Fill an empty queue with `keys` inserted in batches of `batch`
        lanes.  While a queue is only filled, every head stays full (a
        first batch finds the tails empty, so all of it goes to the head,
        which spills to the tail; later keys below the head's largest
        merge in, and the head spills again), so each head ends at
        min(size, H)."""
        keys = np.asarray(keys, np.int64)
        n = keys.shape[0]
        lane = np.arange(n) % batch
        bidx = np.arange(n) // batch
        order = np.lexsort((lane, keys, bidx))  # the insertion order
        ctr = np.empty(n, np.int64)
        ctr[order] = np.arange(n)
        base = len(self.vals)
        v = np.empty(n, np.int64)
        v[ctr] = np.asarray(vals, np.int64)
        self.vals.extend(v.tolist())
        words = (keys << 32) + ctr + base
        sh = shard_of_key(keys, self.S)
        for s in range(self.S):
            w = np.sort(words[sh == s])
            if w.shape[0] > self.C:
                raise ValueError("prefill beyond a shard's capacity")
            self.shards[s] = Sorted(w.tolist())
            self.head[s] = min(len(self.shards[s]), self.H)

    def insert(self, keys, vals, mask) -> None:
        """One insert batch (the lanes of `mask` with a finite key)."""
        keys = np.asarray(keys, np.int64)
        lanes = np.nonzero(np.asarray(mask, bool) & (keys < INF_KEY))[0]
        if lanes.shape[0] == 0:
            return
        order = lanes[np.lexsort((lanes, keys[lanes]))]
        words = self._new_words(keys[order], np.asarray(vals)[order])
        sh = shard_of_key(keys[order], self.S)
        inc_by: Dict[int, List[int]] = {}
        for w, d in zip(words, sh.tolist()):
            inc_by.setdefault(d, []).append(w)
        new_head = list(self.head)
        overflow = False
        for s, inc in inc_by.items():
            lst, h = self.shards[s], self.head[s]
            if len(lst) > h:  # keys strictly below the head's largest
                bkey = _key(lst[h - 1]) if h > 0 else INT32_MIN
            else:
                bkey = INF_KEY
            n_head = sum(1 for w in inc if _key(w) < bkey)
            if n_head:
                self._touched.add(s)
            self.queued += len(inc)
            new_head[s] = min(h + n_head, self.H)
            if len(lst) + len(inc) - new_head[s] > self.C - self.H:
                overflow = True
        for s, inc in inc_by.items():
            for w in inc:
                self.shards[s].insort(w)
        if not overflow:
            self.head = new_head
            return
        # The tail's arena overflows in some shard: every shard keeps its C
        # smallest and refills its head whole.
        self._touched.update(range(self.S))
        for s in range(self.S):
            self.dropped += max(len(self.shards[s]) - self.C, 0)
            self.shards[s].truncate(self.C)
            self.head[s] = min(len(self.shards[s]), self.H)

    # -- the hot head --------------------------------------------------------

    def _ensure_head(self) -> bool:
        need = min(self.H, self.B + self.pad)
        fire = any(self.head[s] < need and len(self.shards[s]) > self.head[s]
                   for s in range(self.S))
        if fire:
            self.head = [min(self.H, len(s)) for s in self.shards]
        return fire

    def _cutoff(self) -> int:
        if any(self.head[s] == 0 and len(self.shards[s]) > 0
               for s in range(self.S)):
            return INT32_MIN
        mins = [_key(self.shards[s][0]) for s in range(self.S)
                if self.head[s] > 0]
        return min(mins) if mins else INF_KEY

    def _pop(self, s: int, positions) -> List[tuple]:
        """Remove shard s's entries at `positions` (all inside its head);
        returns their (key, shard, position, val)."""
        lst = self.shards[s]
        positions = list(positions)
        out = []
        for p in positions:
            w = lst[p]
            out.append((_key(w), s, p, self.vals[w & _MASK]))
        lst.delete(positions)
        self.head[s] -= len(positions)
        self._touched.add(s)
        return out

    def _delete(self, schedule: str, active: int, draws) -> List[tuple]:
        m, S = self.B, self.S
        total = sum(len(s) for s in self.shards)
        if schedule in EXACT:
            n = min(active, total)
            # the n smallest (key, shard, position) of each shard's first m
            depth = [min(m, self.head[s]) for s in range(S)]
            firsts = [self.shards[s].first(depth[s]) for s in range(S)]
            heap = [(_key(f[0]), s, 0) for s, f in enumerate(firsts) if f]
            heapq.heapify(heap)
            take: Dict[int, int] = {}
            for _ in range(n):
                _, s, p = heapq.heappop(heap)
                take[s] = take.get(s, 0) + 1
                if p + 1 < len(firsts[s]):
                    heapq.heappush(heap, (_key(firsts[s][p + 1]), s, p + 1))
            out = []
            for s, t in take.items():
                out += self._pop(s, range(t))
            return out
        act = min(max(active, 0), m)
        if act == 0:
            return []
        if schedule == "SPRAY_HERLIHY":
            choice, hi = draws[0], draws[1]
            m_s = np.bincount(np.asarray(choice[:act], np.int64),
                              minlength=S)
            out = []
            col = np.arange(self.W, dtype=np.int64)
            for s in range(S):
                if m_s[s] == 0:
                    continue
                win = min(int(m_s[s]) + self.pad, self.head[s], self.W)
                takeable = min(int(m_s[s]), win)
                if takeable <= 0:
                    continue
                u = np.asarray(hi[s], np.int64) * (self.W + 1) + col
                picks = np.argsort(u[:win], kind="stable")[:takeable]
                out += self._pop(s, sorted(int(p) for p in picks))
            return out
        if schedule == "MULTIQ":
            a = np.asarray(draws[0][:act], np.int64)
            b = np.asarray(draws[2][:act], np.int64)
            mins = np.array([_key(self.shards[s][0]) if self.head[s] > 0
                             else INF_KEY for s in range(S)], np.int64)
            pick_a = (mins[a] < mins[b]) | ((mins[a] == mins[b]) & (a <= b))
            counts = np.bincount(np.where(pick_a, a, b), minlength=S)
            out = []
            for s in range(S):
                t = min(int(counts[s]), self.head[s])
                if t:
                    out += self._pop(s, range(t))
            return out
        raise ValueError(f"no reference for schedule {schedule}")

    # -- one step ------------------------------------------------------------

    def step(self, ops, keys, vals, mode: int, draws=None):
        """One `SmartPQ.step` with integer keys: returns the deleteMin
        output (keys, vals) as the program lays it out (eliminated pairs
        first, then the schedule's removals ascending by (key, shard,
        position); INF_KEY, 0 beyond)."""
        ops = np.asarray(ops, np.int64)
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        st = self.stats
        ins = ops == OP_INSERT
        b_ins, b_del = int(ins.sum()), int((ops == OP_DELETE_MIN).sum())
        n_insert = st["n_insert"] + b_ins
        n_delete = st["n_delete"] + b_del
        if b_ins:
            st["min_key"] = min(st["min_key"], int(keys[ins].min()))
            st["max_key"] = max(st["max_key"], int(keys[ins].max()))
        decide = st["step"] % self.di == 0
        if not decide and mode != st["mode"]:
            self.faults.append(f"step {st['step']}: mode {st['mode']} -> "
                               f"{mode} off a decision step")
        st["transitions"] += int(mode != st["mode"])
        st["mode"] = mode
        st["n_insert"], st["n_delete"] = ((0, 0) if decide
                                          else (n_insert, n_delete))

        elim = []
        active = b_del
        if self.eliminate:
            masked = np.where(ins, keys, INF_KEY)
            order = np.argsort(masked, kind="stable")
            cutoff = self._cutoff()
            n_elim = min(int((masked[order] < cutoff).sum()), b_del)
            elim = [(int(masked[i]), int(vals[i])) for i in order[:n_elim]]
            ins = ins.copy()
            ins[order[:n_elim]] = False
            active = b_del - n_elim
            st["eliminated"] += n_elim
        self.insert(keys, vals, ins)
        st["head_refills"] += int(self._ensure_head())
        out = sorted(self._delete(self.schedules[mode], active, draws))
        st["mode_steps"][mode] += 1
        st["step"] += 1
        self.head_rows += len(self._touched)
        self._touched = set()
        res_k = [k for k, _ in elim] + [o[0] for o in out]
        res_v = [v for _, v in elim] + [o[3] for o in out]
        B = ops.shape[0]
        k = np.full(B, INF_KEY, np.int64)
        v = np.zeros(B, np.int64)
        k[:len(res_k)] = res_k
        v[:len(res_v)] = res_v
        return k, v, len(res_k)

    # -- views ---------------------------------------------------------------

    def size(self) -> int:
        return sum(len(s) for s in self.shards)

    def contents(self, s: int):
        """Shard s's (keys, vals) in (key, insertion) order."""
        lst = self.shards[s]
        return (np.array([_key(w) for w in lst], np.int64),
                np.array([self.vals[w & _MASK] for w in lst], np.int64))


def program_contents(state: Dict[str, np.ndarray], s: int):
    """Shard s of a program state (host arrays by field name) in
    (key, seq) order: the head's valid prefix, then the tail's window
    sorted by (key, seq)."""
    h = int(state["head_size"][s])
    k = state["head_keys"][s, :h].astype(np.int64)
    v = state["head_vals"][s, :h].astype(np.int64)
    t0, tn = int(state["tail_start"][s]), int(state["tail_size"][s])
    tk = state["tail_keys"][s, t0:t0 + tn].astype(np.int64)
    tq = state["tail_seq"][s, t0:t0 + tn].astype(np.int64)
    tv = state["tail_vals"][s, t0:t0 + tn].astype(np.int64)
    o = np.lexsort((tq, tk))
    return np.concatenate([k, tk[o]]), np.concatenate([v, tv[o]])


def compare_state(ref: RefSmartPQ, state: Dict[str, np.ndarray]) -> int:
    """Shards whose contents or head length differ from the reference's."""
    bad = 0
    for s in range(ref.S):
        pk, pv = program_contents(state, s)
        rk, rv = ref.contents(s)
        if (pk.shape != rk.shape or not np.array_equal(pk, rk)
                or not np.array_equal(pv, rv)
                or int(state["head_size"][s]) != ref.head[s]):
            bad += 1
    return bad


def compare_stats(ref: RefSmartPQ, stats: Dict[str, np.ndarray]) -> List[str]:
    """Names of the statistics that differ from the reference's."""
    bad = []
    for name, want in ref.stats.items():
        got = np.asarray(stats[name]).astype(np.int64).reshape(-1).tolist()
        if got != (want if isinstance(want, list) else [want]):
            bad.append(name)
    return bad


def window_mismatches(ref: RefSmartPQ, ops, keys, vals, modes,
                      draws: Optional[Sequence[np.ndarray]], out_k, out_v,
                      out_n) -> int:
    """Replay a (K, B) window step by step, following the program's modes;
    returns the number of steps whose deleteMin output (keys, values and
    count) differs."""
    bad = 0
    for t in range(ops.shape[0]):
        d = None if draws is None else tuple(x[t] for x in draws)
        k, v, n = ref.step(ops[t], keys[t], vals[t], int(modes[t]), d)
        if (n != int(out_n[t]) or not np.array_equal(k, out_k[t])
                or not np.array_equal(v, out_v[t])):
            bad += 1
    return bad
