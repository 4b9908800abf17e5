#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the script exits
non-zero before its last line):

  1. device   the card's name and power limit, torch and CUDA versions, and
              the time to build the CUDA kernels from `src/repro_torch/kernels/csrc`;
  2. kernels  each kernel against its plain PyTorch version on the card,
              bit-exact, at the kernel's validation shapes and at the shapes
              the main path gives it, with times of the kernel, the plain
              version and one library call computing the same function on
              inputs packed into int64 words beforehand (and, beside it, the
              same call with the packing inside it): per call as the
              host issues them (CUDA events), and on the card alone (CUDA
              events around a replayed CUDA graph of the calls); and the
              launch floor, the same two times of one elementwise PyTorch
              op on a one-element tensor (`x.add_(1)`), the least a launch
              costs;
  3. path A   the adaptive 2-mode SmartPQ (SPRAY_HERLIHY / HIER) fused window
              at the fig9 ins0 coordinates (S=16, C=1<<14, B=K=64, 4096 keys
              prefilled), 8 windows, each on a carry freshly prefilled through
              the queue's insert path, with invariants, key conservation and
              kernel launch counts checked; then one more window under
              torch.profiler for the card's busy share;
  4. cpu      path A's first 2 windows rerun on the CPU (plain versions) with
              the same inputs and random draws: carry and outputs must be
              bit-identical to the card's;
  5. path B   the fig9 size_1048576 ins50 queue (S=16, 2,097,152 slots,
              1,048,576 keys prefilled), 4 windows in a row on one carry, and
              one more under torch.profiler;
  6. path C   the default three-mode SmartPQ (SPRAY_HERLIHY / MULTIQ / HIER)
              on the paper's adaptive traces at the coordinates of
              benchmarks/fig10_dynamic.py (S=16, C=1<<15, 8192 keys
              prefilled): Fig. 11's Table 3 trace (K=84, B=57) and Fig. 10's
              c_mix trace (K=30, B=22), each window 3 times on a fresh carry,
              modes 0, 1 and 2 seen, then one more under torch.profiler; both
              windows rerun on the CPU (plain versions) bit-identical;
  7. path D   MULTIQ at a capacity-sized queue: path B's final carry continued
              under the three-mode config for 2 windows (B=K=64, ins50) with
              the mode pinned to MULTIQ (`mode_override=1`);
  8. the total time; then the kernels JSON line, the card line, and the
     result line.

Each path sets the kernels' launch counts to 0 just before it runs and reads
them just after its timed windows; a kernel that the path's windows must
launch (`PATH_KERNELS`) and that no `run_window` call of the path launched
fails the run (prefill launches do not count towards this).  `merge_sorted` has no caller
on any path; phase 2 alone launches it.  The profiler traces go to
build/chip_smoke/.  The
script imports nothing of JAX and nothing of the JAX package `repro`.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
CMP_OPS_PER_S = 67e12  # H100 SXM float32 peak outside the tensor cores
INF_KEY = 2**31 - 1


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

# Validation shapes copied from the JAX package's kernel registry
# (src/repro/kernels/registry.py:481-546), then the main path's shapes.
TOPK_SHAPES = [
    ((8, 256, 16), "validation"), ((3, 100, 7), "validation"),
    ((1, 64, 64), "validation"), ((5, 1024, 128), "validation"),
    ((1, 1424, 64), "main: SPRAY tournament"),
    ((2, 512, 64), "main: HIER pod semifinal"),
    ((1, 128, 64), "main: HIER final"),
    ((1, 1312, 57), "main: path C Fig. 11 SPRAY"),
    ((2, 456, 57), "main: path C Fig. 11 HIER semifinal"),
    ((1, 114, 57), "main: path C Fig. 11 HIER final"),
    ((1, 752, 22), "main: path C Fig. 10 c_mix SPRAY"),
    ((2, 176, 22), "main: path C Fig. 10 c_mix HIER semifinal"),
    ((1, 44, 22), "main: path C Fig. 10 c_mix HIER final"),
    ((16, 4096, 64), "registry tuning shape"),
    ((1, 1024, 64), "registry tuning shape"),
    ((1, 512, 64), "registry tuning shape"),
    ((2, 2048, 300), "run wider than registers (k' = 512)"),
]
ELIM_SHAPES = [
    ((1, 16), "validation"), ((4, 64), "validation"),
    ((6, 37), "validation"), ((8, 128), "validation"),
    ((64, 64), "main: window op log"),
    ((84, 57), "main: path C Fig. 11 op log"),
    ((30, 22), "main: path C Fig. 10 c_mix op log"),
    ((2, 1000), "row wider than registers (B > 256): block body"),
]
MERGE_SHAPES = [
    ((4, 64, 16), "validation"), ((2, 256, 7), "validation"),
    ((6, 100, 60), "validation"), ((3, 8, 8), "validation"),
    ((16, 256, 64), "main: step insert"),
    ((16, 256, 57), "main: path C Fig. 11 step insert"),
    ((16, 256, 22), "main: path C Fig. 10 c_mix step insert"),
    ((16, 256, 4096), "main: prefill insert"),
]
# (S, m): validation shapes (src/repro/kernels/registry.py:516-533), then
# the MULTIQ steps of paths C and D
TWOCHOICE_SHAPES = [
    ((4, 16), "validation"), ((16, 64), "validation; main: path D"),
    ((8, 5), "validation"), ((16, 57), "main: path C Fig. 11 trace"),
    ((16, 22), "main: path C Fig. 10 c_mix trace"),
]
MULTIQ_SHAPES = [
    ((4, 16), "validation"), ((16, 64), "validation; main: path D"),
    ((2, 8), "validation"), ((16, 57), "main: path C Fig. 11 trace"),
    ((16, 22), "main: path C Fig. 10 c_mix trace"),
]
# (S, C, R): validation shapes (registry.py:549-557), the tuning shape,
# then rows holding equal (key, val) words across buffer and run (all vals
# 0, keys in [0, 8)), R = C, and a C whose buffer fills 128 KB of shared
# memory
MERGE_DUPLICATES = "duplicate (key, val) words"
MERGE_SORTED_SHAPES = [
    ((4, 64, 16), "validation"), ((2, 256, 7), "validation"),
    ((1, 64, 1), "validation"),
    ((8, 1024, 128), "registry tuning shape; no caller on any path"),
    ((4, 256, 64), MERGE_DUPLICATES), ((2, 4096, 4096), "R = C"),
    ((1, 16384, 4), "C = 16384, the widest row"),
]
MAIN_SHAPE = {"topk_smallest": (1, 1424, 64), "elim_sort": (64, 64),
              "windowed_merge": (16, 256, 64), "twochoice_pick": (16, 57),
              "multiq_select": (16, 57), "merge_sorted": (8, 1024, 128)}
REPLACES = {
    "windowed_merge": "src/repro/kernels/windowed_merge.py:52",
    "topk_smallest": "src/repro/kernels/bitonic_topk.py:128",
    "elim_sort": "src/repro/kernels/elim_match.py:42",
    "twochoice_pick": "src/repro/kernels/twochoice.py:67",
    "multiq_select": "src/repro/kernels/twochoice.py:122",
    "merge_sorted": "src/repro/kernels/sorted_merge.py:50",
}
# Kernels with no caller on any path: their launches are phase 2's.
NO_CALLER = ("merge_sorted",)


def _sorted_rows(rng, S, W, lo=0, hi=200):
    import numpy as np

    out = np.full((S, W), INF_KEY, np.int32)
    for s in range(S):
        n = rng.integers(0, W + 1)
        out[s, :n] = np.sort(rng.integers(lo, hi, n)).astype(np.int32)
    return out


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CMP_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _log2(x):
    import math

    return math.log2(max(x, 2))


def _us(ms) -> str:
    return "none" if ms is None else f"{ms * 1e3:.2f}us"


def check_kernels(seed: int = 0):
    """Hold each kernel against its plain version at every shape; return
    the per-kernel records of the kernels JSON line (launches filled in
    later from the main path's run) and this phase's launch counts."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as KO
    from repro_torch.kernels import ref as KR
    from repro_torch.kernels.timing import cuda_ms, graph_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    records = {}
    KO.reset_launches()

    def run_case(name, shape, label, args, kernel, plain, library, nbytes,
                 ops, packed=None):
        """`library` is one PyTorch call computing the same function on
        inputs prepared outside it (a closure of no arguments), or None
        where there is none; `packed` (of the kernel's arguments) is the
        same call with the int64 packing of its inputs inside, an earlier
        yardstick that also timed the packing."""
        got = kernel(*args)
        want = plain(*args)
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(
                    f"{name} {shape}: kernel shape {tuple(g.shape)} != "
                    f"plain {tuple(w.shape)}")
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        match = err == 0
        k_ms = cuda_ms(lambda: kernel(*args))
        p_ms = cuda_ms(lambda: plain(*args))
        l_ms = cuda_ms(library) if library else None
        q_ms = cuda_ms(lambda: packed(*args)) if packed else None
        kd_ms = graph_ms(lambda: kernel(*args))
        pd_ms = graph_ms(lambda: plain(*args))
        ld_ms = graph_ms(library) if library else None
        qd_ms = graph_ms(lambda: packed(*args)) if packed else None
        b_ms, b_by = _bound(nbytes, ops)
        rec = {"shape": list(shape), "label": label, "match": match,
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "device_ms": kd_ms,
               "plain_device_ms": pd_ms, "library_device_ms": ld_ms,
               "library_packed_ms": q_ms, "library_packed_device_ms": qd_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        records.setdefault(name, []).append(rec)
        log(f"  {name} {shape} [{label}] match={match} per call: kernel="
            f"{_us(k_ms)} plain={_us(p_ms)} library={_us(l_ms)} (packing "
            f"inside {_us(q_ms)}) | device (graph): kernel={_us(kd_ms)} "
            f"plain={_us(pd_ms)} library={_us(ld_ms)} (packing inside "
            f"{_us(qd_ms)}) | bound={b_ms*1e3:.3f}us ({b_by})")
        if not match:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")

    for (R, N, k), label in TOPK_SHAPES:
        keys = rng.integers(0, 1 << 20, (R, N)).astype(np.int32)
        if label.startswith("main"):
            keys[rng.random((R, N)) < 0.5] = INF_KEY
        vals = np.tile(np.arange(N, dtype=np.int32), (R, 1))
        args = (t(keys), t(vals), k)
        words = KR.lex_pack(*args[:2])
        run_case(
            "topk_smallest", (R, N, k), label, args, KO.topk_smallest,
            KR.topk_smallest_ref,
            lambda w=words, kk=min(k, N): torch.topk(
                w, kk, dim=1, largest=False, sorted=True),
            4 * (2 * R * N + 2 * R * min(k, N)),
            R * N * (_log2(k) + 1),
            packed=lambda a, b, kk: torch.topk(
                KR.lex_pack(a, b), min(kk, b.shape[1]), dim=1, largest=False,
                sorted=True),
        )
    for (R, B), label in ELIM_SHAPES:
        keys = rng.integers(0, 64, (R, B)).astype(np.int32)
        keys[rng.random((R, B)) < 0.3] = INF_KEY
        tags = np.tile(np.arange(B, dtype=np.int32), (R, 1))
        lg = _log2(B)
        args = (t(keys), t(tags))
        run_case(
            "elim_sort", (R, B), label, args, KO.elim_sort, KR.elim_sort_ref,
            lambda w=KR.lex_pack(*args): torch.sort(w, dim=1, stable=True),
            4 * 4 * R * B, R * (B / 2) * lg * (lg + 1) / 2,
            packed=lambda a, b: torch.sort(KR.lex_pack(a, b), dim=1,
                                           stable=True),
        )
    for (S, H, Rw), label in MERGE_SHAPES:
        head_k = _sorted_rows(rng, S, H)
        run_k = _sorted_rows(rng, S, Rw)
        head_v = rng.integers(0, 1 << 20, (S, H)).astype(np.int32)
        run_v = rng.integers(0, 1 << 20, (S, Rw)).astype(np.int32)
        head_q = np.tile(np.arange(H, dtype=np.int32), (S, 1))
        run_q = 1000 + np.tile(np.arange(Rw, dtype=np.int32), (S, 1))
        args = tuple(t(x) for x in (head_k, head_v, head_q, run_k, run_v,
                                    run_q))
        W = H + Rw
        tags = torch.arange(W, dtype=torch.int32, device=dev).expand(S, W)

        def packed(hk, hv, hq, rk, rv, rq, _tags=tags):
            cat = torch.cat([hk, rk], dim=1)
            return torch.sort(KR.lex_pack(cat, _tags), dim=1, stable=True)

        words = KR.lex_pack(torch.cat([args[0], args[3]], dim=1), tags)
        # bytes: every key read, the val and seq of each live (non-INF)
        # input word (an INF word's are written as 0), three outputs.
        # Operations: the rank merge's compares, a binary search of each
        # head word in its run and of each live run word in its head.
        live_head = int((head_k != INF_KEY).sum())
        live_run = int((run_k != INF_KEY).sum())
        run_case(
            "windowed_merge", (S, H, Rw), label, args, KO.windowed_merge,
            KR.windowed_merge_ref,
            lambda w=words: torch.sort(w, dim=1, stable=True),
            4 * (S * W + 2 * (live_head + live_run) + 3 * S * W),
            S * H * _log2(Rw + 1) + live_run * _log2(H + 1),
            packed=packed,
        )
    # The MULTIQ kernels read the (S, H=256) head tier in place, as on the
    # main path: `mins` is its column 0, the windows its first m columns.
    # No one PyTorch call computes either function (a gather and histogram;
    # a take-masked top-m), so they have no library time.
    for (S, m), label in TWOCHOICE_SHAPES:
        head = rng.integers(0, 1 << 20, (S, 256)).astype(np.int32)
        head[:, 0] = rng.integers(0, 2 * S, S)  # close minima: some ties
        a, b = (rng.integers(0, S, m).astype(np.int32) for _ in range(2))
        act = rng.random(m) < 0.8
        # bytes: S minima, m mask bytes, two ids per active lane, S counts
        run_case(
            "twochoice_pick", (S, m), label,
            (t(head)[:, 0], t(a), t(b), t(act)), KO.twochoice_counts,
            KR.twochoice_counts_ref, None,
            4 * (2 * S + 2 * int(act.sum())) + m, 2.0 * m * S,
        )
    for (S, m), label in MULTIQ_SHAPES:
        head_k = _sorted_rows(rng, S, 256, hi=1 << 20)
        head_v = rng.integers(0, 1 << 20, (S, 256)).astype(np.int32)
        take = rng.integers(0, m + 1, S).astype(np.int32)
        # bytes: S takes, this run's popped keys, the vals of the non-INF
        # winners (gathered by tag), 2 m outputs
        popped = np.concatenate([head_k[s, :take[s]] for s in range(S)])
        winners = min(m, int((popped != INF_KEY).sum()))
        run_case(
            "multiq_select", (S, m), label,
            (t(head_k)[:, :m], t(head_v)[:, :m], t(take)),
            KO.multiq_select_topm, KR.multiq_select_ref, None,
            4 * (S + popped.size + winners + 2 * m), S * m * _log2(m),
        )
    for (S, C, Rw), label in MERGE_SORTED_SHAPES:
        if label == MERGE_DUPLICATES:
            buf_k = _sorted_rows(rng, S, C, hi=8)
            run_k = _sorted_rows(rng, S, Rw, hi=8)
            buf_v = np.zeros((S, C), np.int32)
            run_v = np.zeros((S, Rw), np.int32)
        else:
            buf_k = _sorted_rows(rng, S, C)
            run_k = _sorted_rows(rng, S, Rw)
            buf_v = np.tile(np.arange(C, dtype=np.int32), (S, 1))
            run_v = (1 << 20) + np.tile(np.arange(Rw, dtype=np.int32),
                                        (S, 1))

        def packed(bk, bv, rk, rv):
            return torch.sort(KR.lex_pack(torch.cat([bk, rk], dim=1),
                                          torch.cat([bv, rv], dim=1)),
                              dim=1, stable=True)

        args = tuple(t(x) for x in (buf_k, buf_v, run_k, run_v))
        words = KR.lex_pack(torch.cat([args[0], args[2]], dim=1),
                            torch.cat([args[1], args[3]], dim=1))
        # operations: the rank merge's compares, a binary search of each
        # buffer word in its run and of each run word in its buffer
        run_case(
            "merge_sorted", (S, C, Rw), label, args, KO.merge_sorted_runs,
            KR.merge_sorted_runs_ref,
            lambda w=words: torch.sort(w, dim=1, stable=True),
            4 * (2 * S * C + 2 * S * Rw + 2 * S * C),
            S * C * _log2(Rw + 1) + S * Rw * _log2(C + 1),
            packed=packed,
        )
    return records, dict(KO.LAUNCHES)


def launch_floor():
    """(device ms, per-call ms) of one elementwise PyTorch op on a
    one-element int32 tensor, timed as the kernels are: what a launch costs
    with no work in it."""
    import torch

    from repro_torch.kernels.timing import cuda_ms, graph_ms

    x = torch.zeros(1, dtype=torch.int32, device="cuda")
    per_call = cuda_ms(lambda: x.add_(1))
    device = graph_ms(lambda: x.add_(1))
    log(f"  launch floor: x.add_(1) on one int32 per call={_us(per_call)} | "
        f"device (graph)={_us(device)}")
    return device, per_call


# ---------------------------------------------------------------------------
# phases 3-5: the port's main path
# ---------------------------------------------------------------------------

TWO_MODE = ("SPRAY_HERLIHY", "SPRAY_HERLIHY", "HIER")
THREE_MODE = ("SPRAY_HERLIHY", "MULTIQ", "HIER")

# Path A: the fig9 ins0 latency slice (benchmarks/window_amortization.py:35-39)
PATH_A = dict(S=16, C=1 << 14, B=64, K=64, prefill=4096, key_range=8192,
              ins_frac=0.0, windows=8)
# Path B: the fig9 size_1048576 ins50 queue (benchmarks/fig9_grid.py:30-37)
PATH_B = dict(S=16, C=1 << 17, B=64, K=64, prefill=1 << 20,
              key_range=1 << 21, ins_frac=0.5, windows=4)
# Path C: the paper's adaptive traces at benchmarks/fig10_dynamic.py:25-31,
# 60-66 (16 shards, C=1<<15, 8192 keys from the first phase's key range),
# with the default three-mode config; each trace's window runs `reps` times
PATH_C = dict(S=16, C=1 << 15, prefill=8192, steps_per_phase=6, reps=3)
# Path D: MULTIQ pinned on path B's final carry, three-mode config
PATH_D = dict(S=16, C=1 << 17, B=64, K=64, key_range=1 << 21, ins_frac=0.5,
              windows=2, mode_override=1)
# The kernels each path's windows must launch (`run_window` calls only:
# path A inserts only in its prefills, so its windows merge nothing)
PATH_KERNELS = {
    "A": ("topk_smallest", "elim_sort"),
    "B": ("windowed_merge", "topk_smallest", "elim_sort"),
    "C": ("windowed_merge", "topk_smallest", "elim_sort", "twochoice_pick",
          "multiq_select"),
    "D": ("windowed_merge", "elim_sort", "twochoice_pick", "multiq_select"),
}
PREFILL_BATCH = 4096
# Kernel launches inside `run_window` calls only (prefills excluded), per
# kernel, summed over the path that is running; reset with the counts.
WINDOW_LAUNCHES: dict = {}


def make_pq(cfg, device, tree=None, schedules=TWO_MODE):
    from repro_torch.core.pqueue.schedules import Schedule
    from repro_torch.core.smartpq import SmartPQ, SmartPQConfig

    return SmartPQ(SmartPQConfig(
        num_shards=cfg["S"], capacity=cfg["C"], npods=2, decision_interval=2,
        mode_schedules=tuple(Schedule[s] for s in schedules), eliminate=True,
    ), tree=tree, device=device)


def prefill(pq, cfg, seed, device):
    """A fresh carry holding `prefill` keys, inserted through the queue's
    own insert path in batches of 4096 (benchmarks/common.py:54-67)."""
    import numpy as np
    import torch

    from repro_torch.core.pqueue import ops as O

    rng = np.random.default_rng(seed)
    carry = pq.init()
    st = carry.state
    remaining = cfg["prefill"]
    while remaining > 0:
        n = min(remaining, PREFILL_BATCH)
        keys = np.full(PREFILL_BATCH, INF_KEY, np.int32)
        keys[:n] = rng.integers(0, cfg["key_range"], n)
        st, dropped = O.insert(
            st, torch.as_tensor(keys, device=device),
            torch.zeros(PREFILL_BATCH, dtype=torch.int32, device=device))
        if int(dropped.sum()):
            raise AssertionError("prefill dropped keys")
        remaining -= n
    return carry._replace(state=st)


def make_window(cfg, rng, draw_gen, pq):
    """One window's (ops, keys, vals) from numpy and its draws (those its
    config's schedules take) from a CPU generator, so a CPU rerun can take
    the very same inputs."""
    import numpy as np
    import torch

    from repro_torch.core.pqueue import schedules as SCH

    K, B = cfg["K"], cfg["B"]
    ops = (rng.random((K, B)) > cfg["ins_frac"]).astype(np.int32)
    keys = rng.integers(0, cfg["key_range"], (K, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (K, B)).astype(np.int32)
    H = min(256, cfg["C"])
    draws = SCH.step_draws(pq.config.mode_schedules, cfg["S"], B, H, steps=K,
                           generator=draw_gen, device="cpu")
    return (torch.as_tensor(ops), torch.as_tensor(keys),
            torch.as_tensor(vals), draws)


def run_checked(pq, carry, window, device, expect_size,
                around=contextlib.nullcontext(), num_clients=None,
                mode_override=None):
    """Run one window inside the context `around` (a profiler, say) and
    check it: invariants, key conservation (no drops), well-formed outputs.
    `num_clients` (default: the lane width) and `mode_override` go to
    `run_window`.  Returns (carry, result, seconds, host syncs, size after);
    adds the window's own kernel launches to WINDOW_LAUNCHES."""
    import torch

    from repro_torch.core.pqueue.ops import OP_INSERT
    from repro_torch.core.pqueue.state import invariant_violations
    from repro_torch.kernels import ops as KO
    from repro_torch.utils import hostsync

    ops, keys, vals, draws = window
    dev_args = [t.to(device) for t in (ops, keys, vals)]
    draws = tuple(d.to(device) for d in draws)
    if num_clients is None:
        num_clients = ops.shape[1]
    elif torch.is_tensor(num_clients):
        num_clients = num_clients.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    syncs = hostsync.SYNCS["count"]
    launches = dict(KO.LAUNCHES)
    with around:
        t0 = time.perf_counter()
        carry, res = pq.run_window(carry, *dev_args, draws=draws,
                                   num_clients=num_clients,
                                   mode_override=mode_override)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    syncs = hostsync.SYNCS["count"] - syncs
    for name, n in KO.LAUNCHES.items():
        WINDOW_LAUNCHES[name] = WINDOW_LAUNCHES.get(name, 0) + n - launches[name]

    viols = invariant_violations(carry.state, first_only=True)
    if viols:
        raise viols[0]
    admitted = int(((ops == OP_INSERT) & (keys < INF_KEY)).sum())
    returned = int(res.n_out.sum())
    size = int(carry.state.total_size)
    if expect_size + admitted - returned != size:
        raise AssertionError(
            f"keys not conserved: {expect_size} + {admitted} inserted - "
            f"{returned} returned != {size} held")
    k = res.keys.cpu()
    n = res.n_out.cpu()
    lane = torch.arange(k.shape[1])[None, :]
    live = lane < n[:, None]
    if bool((n > k.shape[1]).any()) or bool((k[live] == INF_KEY).any()) \
            or bool((k[~live] != INF_KEY).any()):
        raise AssertionError("delete outputs not INF-padded beyond n_out")
    asc = (k[:, 1:] >= k[:, :-1]) | ~live[:, 1:]
    if not bool(asc.all()):
        raise AssertionError("delete outputs not ascending")
    return carry, res, dt, syncs, size


TRACE_DIR = ROOT / "build" / "chip_smoke"


def device_share(pq, carry, window, device, expect_size, window_s, tag,
                 **kw):
    """Run one more window under torch.profiler (`kw` go to `run_checked`)
    and sum the card's busy time in its trace (kernels, copies, sets);
    against the median unprofiled window time `window_s` that gives the
    card's busy share.  Returns ((busy ms or None when the trace holds no
    device work, share or None, device calls in the window, the five
    busiest device functions as (name, calls, ms)), carry after the window,
    size after the window)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    carry, _, _, _, size = run_checked(pq, carry, window, device,
                                       expect_size, around=prof, **kw)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"window_{tag}.json"
    prof.export_chrome_trace(str(path))
    busy = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            calls, us = busy.get(e["name"], (0, 0.0))
            busy[e["name"]] = (calls + 1, us + float(e["dur"]))
    if not busy:
        return (None, None, 0, []), carry, size
    busy_ms = sum(us for _, us in busy.values()) / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1][1])[:5]
    share = (busy_ms, busy_ms / (window_s * 1e3),
             sum(c for c, _ in busy.values()),
             [(name[:80], calls, us / 1e3) for name, (calls, us) in top])
    return share, carry, size


def share_line(busy_ms, share, calls, top) -> str:
    if busy_ms is None:
        return "card busy share not measured (no device events in the trace)"
    tops = "; ".join(f"{n} x{c} {ms:.3f}ms" for n, c, ms in top)
    return (f"card busy {busy_ms:.3f} ms per window in {calls} device calls, "
            f"share {share:.4f} of the median window (idle {1 - share:.4f}); "
            f"busiest: {tops}")


def counts_reset():
    from repro_torch.kernels import ops as KO

    KO.reset_launches()
    WINDOW_LAUNCHES.clear()


def counts_read(path: str):
    """The launch counts since `counts_reset`, in all and inside the
    windows; fails when a kernel `path`'s windows must launch
    (`PATH_KERNELS`) was never launched inside them."""
    from repro_torch.kernels import ops as KO

    in_windows = dict(WINDOW_LAUNCHES)
    missing = [k for k in PATH_KERNELS[path] if in_windows.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"path {path}: kernels {missing} never "
                             f"launched inside the path's windows")
    return dict(KO.LAUNCHES), in_windows


def path_a(seed: int = 0):
    """Phase 3: 8 windows, each from a freshly prefilled carry (the
    benchmark's `fresh_carry`, benchmarks/common.py:182).  Returns the
    launch counts and what phase 4 needs to rerun windows 0-1 on the CPU."""
    import numpy as np
    import torch

    from repro_torch.convert import carry_to_numpy

    cfg, dev = PATH_A, torch.device("cuda")
    pq = make_pq(cfg, dev)
    rng = np.random.default_rng(seed + 1)
    draw_gen = torch.Generator().manual_seed(seed + 2)
    windows = [make_window(cfg, rng, draw_gen, pq)
               for _ in range(cfg["windows"])]
    prefill(pq, cfg, seed, dev)  # warm-up: first launches, allocator
    counts_reset()
    times, modes, kept = [], set(), []
    transitions = syncs = 0
    for w, window in enumerate(windows):
        carry = prefill(pq, cfg, seed, dev)
        carry, res, dt, n_sync, _ = run_checked(pq, carry, window, dev,
                                                cfg["prefill"])
        times.append(dt)
        syncs += n_sync
        modes |= set(res.mode.cpu().tolist())
        transitions += int(carry.stats.transitions)
        if w < 2:
            kept.append((cfg, window, {}, (carry_to_numpy(carry),
                                           [x.cpu().numpy() for x in res])))
    launches, in_windows = counts_read("A")
    steps = cfg["windows"] * cfg["K"]
    us_op = [t * 1e6 / (cfg["K"] * cfg["B"]) for t in times]
    share, _, _ = device_share(pq, prefill(pq, cfg, seed, dev), windows[0],
                               dev, cfg["prefill"], float(np.median(times)),
                               "A")
    log(f"[3 path A] S={cfg['S']} C={cfg['C']} B={cfg['B']} K={cfg['K']} "
        f"ins0, {cfg['windows']} windows from fresh 4096-key carries: "
        f"us/op median {float(np.median(us_op)):.3f} (all {us_op}) | modes "
        f"seen {sorted(modes)} | transitions {transitions} | host syncs "
        f"{syncs / steps:.2f}/step | launches {launches} (inside the windows "
        f"{in_windows}) | invariants ok, keys conserved")
    log(f"[3 path A profile] {share_line(*share)}")
    return (launches, in_windows, cfg["windows"]), (pq, kept)


def cpu_agreement(tag, pq_gpu, kept, seed: int = 0):
    """Rerun windows of a path on the CPU (plain versions) with the same
    config, tree, prefill, inputs and draws: carry and outputs must be
    bit-identical to the card's.  `kept` holds (prefill config, window,
    run_window arguments, the card's (carry, result) as numpy)."""
    import numpy as np
    import torch

    from repro_torch.convert import carry_to_numpy
    from repro_torch.core.smartpq import SmartPQ

    dev = torch.device("cpu")
    pq = SmartPQ(pq_gpu.config, tree=pq_gpu.tree, device=dev)
    for w, (cfg, window, kw, (want_carry, want_res)) in enumerate(kept):
        carry = prefill(pq, cfg, seed, dev)
        carry, res, *_ = run_checked(pq, carry, window, dev, cfg["prefill"],
                                     **kw)
        got_state, got_stats = carry_to_numpy(carry)
        for name, got, want in (
                [(f, got_state[f], want_carry[0][f]) for f in got_state]
                + [(f, got_stats[f], want_carry[1][f]) for f in got_stats]
                + [(f, x.numpy(), y) for f, x, y in
                   zip(res._fields, res, want_res)]):
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"path {tag} window {w}: {name} differs "
                                     f"between the card and the CPU")
    return len(kept)


def path_b(seed: int = 0):
    """Phase 5: the 1M-key queue, 4 windows in a row on one carry.  Returns
    the launch counts, and the carry and size after the profiled window for
    path D."""
    import numpy as np
    import torch

    cfg, dev = PATH_B, torch.device("cuda")
    pq = make_pq(cfg, dev)
    rng = np.random.default_rng(seed + 1)
    draw_gen = torch.Generator().manual_seed(seed + 2)
    windows = [make_window(cfg, rng, draw_gen, pq)
               for _ in range(cfg["windows"] + 1)]  # the last one profiled
    torch.cuda.reset_peak_memory_stats()
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry = prefill(pq, cfg, seed, dev)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    size = int(carry.state.total_size)
    if size != cfg["prefill"]:
        raise AssertionError(f"prefill holds {size} keys")
    times, modes = [], set()
    syncs = 0
    for window in windows[:-1]:
        carry, res, dt, n_sync, size = run_checked(pq, carry, window, dev,
                                                   size)
        times.append(dt)
        syncs += n_sync
        modes |= set(res.mode.cpu().tolist())
    launches, in_windows = counts_read("B")
    steps = cfg["windows"] * cfg["K"]
    us_op = [t * 1e6 / (cfg["K"] * cfg["B"]) for t in times]
    max_mib = torch.cuda.max_memory_allocated() / 2**20
    transitions = int(carry.stats.transitions)
    share, carry, size_after = device_share(
        pq, carry, windows[-1], dev, size, float(np.median(times)), "B")
    log(f"[5 path B] S={cfg['S']} C={cfg['C']}/shard prefill "
        f"{cfg['prefill']} keys in {prefill_s:.2f}s | ins50 B={cfg['B']} "
        f"K={cfg['K']}, {cfg['windows']} windows on one carry: us/op median "
        f"{float(np.median(us_op)):.3f} (all {us_op}) | modes seen "
        f"{sorted(modes)} | transitions {transitions} | "
        f"host syncs {syncs / steps:.2f}/step | size {size} | max memory "
        f"allocated {max_mib:.1f} MiB | "
        f"launches {launches} (inside the windows {in_windows}) | invariants "
        f"ok, keys conserved")
    log(f"[5 path B profile] {share_line(*share)}")
    return (launches, in_windows, cfg["windows"]), (carry, size_after)


def path_c(seed: int = 0):
    """Phase 6: the default three-mode SmartPQ on the paper's Fig. 11
    (Table 3) and Fig. 10 (c_mix) traces, each window `reps` times from a
    freshly prefilled carry; modes 0, 1 and 2 must all run.  Then one
    profiled window, and both traces' first runs rerun on the CPU."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.convert import carry_to_numpy
    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.workloads import traces as T

    cfg, dev = PATH_C, torch.device("cuda")
    pq = make_pq(cfg, dev, schedules=THREE_MODE)
    draw_gen = torch.Generator().manual_seed(seed + 3)
    runs = []
    for name, phases in (("Fig. 11 Table 3", T.TABLE3),
                         ("Fig. 10 c_mix", T.TABLE2["c_mix"])):
        tr = T.phased_trace(phases, steps_per_phase=cfg["steps_per_phase"],
                            seed=seed)
        K, B = tr.ops.shape
        draws = SCH.step_draws(pq.config.mode_schedules, cfg["S"], B, 256,
                               steps=K, generator=draw_gen, device="cpu")
        window = (torch.as_tensor(tr.ops), torch.as_tensor(tr.keys),
                  torch.as_tensor(tr.vals), draws)
        pcfg = dict(cfg, key_range=int(phases[0]["key_range"]))
        runs.append((name, pcfg, window,
                     {"num_clients": torch.as_tensor(tr.num_clients)},
                     int(tr.num_clients.sum())))
    prefill(pq, runs[0][1], seed, dev)  # warm-up: allocator
    counts_reset()
    kept, stats, modes_seen, first_times = [], [], set(), []
    syncs = steps = 0
    for name, pcfg, window, kw, n_ops in runs:
        us_op, times, modes = [], [], None
        for rep in range(cfg["reps"]):
            carry = prefill(pq, pcfg, seed, dev)
            carry, res, dt, n_sync, _ = run_checked(pq, carry, window, dev,
                                                    pcfg["prefill"], **kw)
            us_op.append(dt * 1e6 / n_ops)
            times.append(dt)
            syncs += n_sync
            steps += window[0].shape[0]
            trace_modes = res.mode.cpu().tolist()
            if modes is not None and trace_modes != modes:
                raise AssertionError(f"{name}: the mode trace changed between "
                                     f"runs of the same window")
            modes = trace_modes
            if rep == 0:
                kept.append((pcfg, window, kw, (
                    carry_to_numpy(carry), [x.cpu().numpy() for x in res])))
        modes_seen |= set(modes)
        first_times.append(times)
        runs_of = [(m, len(list(g))) for m, g in itertools.groupby(modes)]
        stats.append(f"{name} K={window[0].shape[0]} B={window[0].shape[1]} "
                     f"({n_ops} ops): us/op median "
                     f"{float(np.median(us_op)):.3f} (all {us_op}), modes "
                     f"(mode, steps) {runs_of}, transitions "
                     f"{int(carry.stats.transitions)}")
    launches, in_windows = counts_read("C")
    if not {0, 1, 2} <= modes_seen:
        raise AssertionError(f"path C saw modes {sorted(modes_seen)}, not "
                             f"all of 0, 1 and 2")
    n_windows = len(runs) * cfg["reps"]
    name, pcfg, window, kw, _ = runs[0]
    share, _, _ = device_share(pq, prefill(pq, pcfg, seed, dev), window, dev,
                               pcfg["prefill"],
                               float(np.median(first_times[0])), "C", **kw)
    log(f"[6 path C] three-mode SmartPQ, S={cfg['S']} C={cfg['C']} "
        f"{cfg['prefill']} keys prefilled per window, {cfg['reps']} runs per "
        f"trace: " + " || ".join(stats) + f" | modes seen "
        f"{sorted(modes_seen)} | host syncs {syncs / steps:.2f}/step | "
        f"launches {launches} (inside the windows {in_windows}) | "
        f"invariants ok, keys conserved")
    log(f"[6 path C profile] {name}: {share_line(*share)}")
    n = cpu_agreement("C", pq, kept, seed)
    log(f"[6 cpu] path C's {n} trace windows rerun on the CPU with the plain "
        f"versions: carry and outputs bit-identical to the card")
    return launches, in_windows, n_windows


def path_d(carry, size, seed: int = 0):
    """Phase 7: path B's final 1M-key carry continued under the three-mode
    config, 2 windows at ins50 with the mode pinned to MULTIQ."""
    import numpy as np
    import torch

    cfg, dev = PATH_D, torch.device("cuda")
    pq = make_pq(cfg, dev, schedules=THREE_MODE)
    rng = np.random.default_rng(seed + 5)
    draw_gen = torch.Generator().manual_seed(seed + 6)
    windows = [make_window(cfg, rng, draw_gen, pq)
               for _ in range(cfg["windows"])]
    counts_reset()
    times, syncs, modes = [], 0, set()
    for window in windows:
        carry, res, dt, n_sync, size = run_checked(
            pq, carry, window, dev, size,
            mode_override=cfg["mode_override"])
        times.append(dt)
        syncs += n_sync
        modes |= set(res.mode.cpu().tolist())
    launches, in_windows = counts_read("D")
    if modes != {cfg["mode_override"]}:
        raise AssertionError(f"path D ran modes {sorted(modes)}")
    us_op = [t * 1e6 / (cfg["K"] * cfg["B"]) for t in times]
    log(f"[7 path D] MULTIQ pinned on path B's carry, S={cfg['S']} "
        f"C={cfg['C']}/shard, ins50 B={cfg['B']} K={cfg['K']}, "
        f"{cfg['windows']} windows: us/op median "
        f"{float(np.median(us_op)):.3f} (all {us_op}) | modes {sorted(modes)}"
        f" | host syncs {syncs / (cfg['windows'] * cfg['K']):.2f}/step | size "
        f"{size} | launches {launches} (inside the windows {in_windows}) | "
        f"invariants ok, keys conserved")
    return launches, in_windows, cfg["windows"]


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def kernels_line(records, paths, phase2, floor):
    """`paths` maps a path's name to (launches, launches inside its
    windows, windows); `phase2` holds phase 2's launch counts, the
    launches of a kernel with no caller on any path (`NO_CALLER`);
    `floor` is the launch floor, (device ms, per-call ms)."""
    from repro_torch.kernels import build

    out = []
    for name in build.SOURCES:
        main = [r for r in records[name]
                if tuple(r["shape"]) == MAIN_SHAPE[name]][0]
        rec = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(p[0][name] for p in paths.values()),
            "launches_by_path": {k: p[0][name] for k, p in paths.items()},
            "launches_per_window": {k: p[1].get(name, 0) / p[2]
                                    for k, p in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in records[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "device_ms": main["device_ms"],
            "plain_device_ms": main["plain_device_ms"],
            "library_device_ms": main["library_device_ms"],
            "library_packed_ms": main["library_packed_ms"],
            "library_packed_device_ms": main["library_packed_device_ms"],
            "shape": main["shape"],
            "shapes": records[name],
        }
        if name in NO_CALLER:
            rec["launches"] = phase2[name]
            rec["launches_from"] = ("phase 2 (kernel vs plain): no caller on "
                                    "any path")
        out.append(rec)
    return {"kernels": out, "launch_floor_device_ms": floor[0],
            "launch_floor_ms": floor[1]}


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels.timing import card_line

    t_start = time.perf_counter()
    card = card_line()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    build_s = time.perf_counter() - t0
    log(f"[1 device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | kernels built in {build_s:.1f}s "
        f"({build.BUILD_INFO.get('dir')})")
    for name, text in build.BUILD_INFO.get("logs", {}).items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("[2 kernels] kernel vs plain on the card")
    records, phase2 = check_kernels()
    floor = launch_floor()
    path_a_counts, (pq_a, kept_a) = path_a()
    n = cpu_agreement("A", pq_a, kept_a)
    log(f"[4 cpu] path A windows 0-{n - 1} rerun on the CPU with the plain "
        f"versions: carry and outputs bit-identical to the card")
    path_b_counts, (carry_b, size_b) = path_b()
    path_c_counts = path_c()
    path_d_counts = path_d(carry_b, size_b)
    log(f"[8 done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps(kernels_line(records, {
        "A": path_a_counts, "B": path_b_counts, "C": path_c_counts,
        "D": path_d_counts}, phase2, floor)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
