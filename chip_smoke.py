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
  8. path E   SSSP (`workloads.sssp`) on `random_graph(n=65536, avg_deg=4,
              deg_cap=8, seed=0)`, made on the host: the fixed HIER engine
              (m=32) and the adaptive three-mode engine (m=16, B=144), S=16,
              C=1<<14, both converging to `bellman_ford`'s distances; then
              the adaptive engine on a 4096-vertex graph on the card and on
              the CPU with the same draws: result, trace and final carry
              bit-identical;
  9. path F   the DES hold model (`workloads.des`) at S=16, C=1<<17 with
              1,048,576 pending events (mean hold 2^20), B=64 servers, K=64
              steps: STRICT_FLAT equal to `hold_model_oracle` step by step,
              MULTIQ pinned conserving events, the adaptive run recorded and
              its trace replayed to the same pops; then the bursty M/M/1
              trace (`bursty_des_trace(BURSTY_PHASES, seed=5)`) saved, loaded
              and replayed on the card and on the CPU: outputs, mode trace
              and carry bit-identical;
  10. path G  the serving tier (`serve`) at the scheduler's default queue
              (16 shards x 8,192 slots, B = 64 lanes, three modes, HIER at
              first): G1 the reference's SLO run (benchmarks/serve_slo.py)
              on `bursty_serve_workload(steps=64, seed=1)` with 8 decode
              slots at K = 1, 4 and 16, forecast off and on, every request
              completed, each window's dispatch stream equal to K `tick`
              calls replayed with its budgets, the K = 4 forecast run rerun
              on the CPU; G2 a deep backlog under 4x overload (the shape of
              benchmarks/overload.py at 64 slots: about 15,400 open-loop
              requests over 512 ticks), open loop and controlled, the
              conservation identities of `health()` after every window, the
              controlled run's first 128 ticks rerun on the CPU, 64 deep
              ticks of the open-loop run profiled; G3 the guard tier: a
              window tripped once recovers on the fallback queue as a direct
              fallback run does, tripped twice raises
              `WindowValidationError` with the checkpoint restored;
  11. path H  durable serving (`EngineConfig.durable_dir`: write-ahead log,
              snapshots, `recover`) on the same queue: H1 G1's K = 4 run not
              durable, durable with fsync and without, and not durable
              again (benchmarks/durability.py), µs/tick and the ratios, log
              records, bytes and syncs, the durable calls' ms by part (log
              records, registry read, a snapshot's card read, write and
              prune) and a snapshot's bytes, all four runs equal, 16 deep
              durable ticks profiled; H2 the SIGKILL drill of
              tests/test_durability.py with worker processes on the card
              (`python -m repro_torch.serve.worker --device cuda`) at K = 1
              and 16, killed at step 9 and restarted, and a supervised run
              at K = 4 ending with exit codes [-9, 0], every artifact equal
              to the uninterrupted run's; H3 recovery time against
              snapshot cadence (intervals 2, 8, 32); H4 recovery from each
              damage injector (`torn_wal`, `partial_snapshot`,
              `stale_manifest`) on copies of H1's store; H5 G2's 2x
              controlled workload as a durable run paused at step 8 and
              resumed, equal to the uninterrupted run on the card and on
              the CPU;
  12. the total time; then the kernels JSON line, the card line, and the
     result line.

Each path sets the kernels' launch counts to 0 just before it runs and reads
them just after its timed windows; a kernel that the path's windows must
launch (`PATH_KERNELS`) and that no `run_window` call of the path launched
fails the run (prefill launches do not count towards this).  On paths E and
F a driver's step counts as a window of one step, and a replay's steps
count alike; on paths G and H an engine tick does (path H counts its
engine runs and recoveries in this process, not its worker processes).
`merge_sorted` has no caller
on any path; phase 2 alone launches it.  The profiler traces go to
build/chip_smoke/, path H's stores to build/chip_smoke/durable/.  The
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
    ((2, 256, 32), "main: path E fixed HIER semifinal"),
    ((1, 64, 32), "main: path E fixed HIER final"),
    ((1, 2704, 144), "main: path E adaptive SPRAY"),
    ((2, 1152, 144), "main: path E adaptive HIER semifinal"),
    ((1, 288, 144), "main: path E adaptive HIER final"),
    ((1, 2448, 128), "main: path F SPRAY"),
    ((2, 1024, 128), "main: path F HIER semifinal"),
    ((1, 256, 128), "main: path F HIER final"),
    ((1, 2048, 128), "main: path F STRICT_FLAT"),
    ((16, 4096, 64), "registry tuning shape"),
    ((1, 1024, 64), "registry tuning shape; main: path G STRICT_FLAT "
                    "fallback"),
    ((1, 512, 64), "registry tuning shape"),
    ((2, 2048, 300), "run wider than registers (k' = 512)"),
]
ELIM_SHAPES = [
    ((1, 16), "validation"), ((4, 64), "validation; main: path G K=4 "
                                         "window op log"),
    ((6, 37), "validation"), ((8, 128), "validation"),
    ((64, 64), "main: window op log"),
    ((84, 57), "main: path C Fig. 11 op log"),
    ((30, 22), "main: path C Fig. 10 c_mix op log"),
    ((1, 144), "main: path E adaptive step op log"),
    ((1, 128), "main: path F step op log"),
    ((54, 128), "main: path F bursty replay op log"),
    ((1, 64), "main: path G tick op log"),
    ((16, 64), "main: path G K=16 window op log"),
    ((2, 1000), "row wider than registers (B > 256): block body"),
]
MERGE_SHAPES = [
    ((4, 64, 16), "validation"), ((2, 256, 7), "validation"),
    ((6, 100, 60), "validation"), ((3, 8, 8), "validation"),
    ((16, 256, 64), "main: step insert; path G tick insert"),
    ((16, 256, 57), "main: path C Fig. 11 step insert"),
    ((16, 256, 22), "main: path C Fig. 10 c_mix step insert"),
    ((16, 256, 4096), "main: prefill insert"),
    ((16, 256, 256), "main: path E fixed relax insert"),
    ((16, 256, 144), "main: path E adaptive step insert"),
    ((16, 256, 1), "main: path E source insert"),
    ((16, 256, 128), "main: path F step insert"),
    ((16, 256, 32512), "main: path F prefill slice"),
    ((16, 256, 8192), "main: path F prefill last slice"),
]
# (S, m): validation shapes (src/repro/kernels/registry.py:516-533), then
# the MULTIQ steps of paths C and D
TWOCHOICE_SHAPES = [
    ((4, 16), "validation"), ((16, 64), "validation; main: paths D, G"),
    ((8, 5), "validation"), ((16, 57), "main: path C Fig. 11 trace"),
    ((16, 22), "main: path C Fig. 10 c_mix trace"),
    ((16, 128), "main: path F MULTIQ step"),
    ((16, 144), "main: path E adaptive MULTIQ step"),
]
MULTIQ_SHAPES = [
    ((4, 16), "validation"), ((16, 64), "validation; main: paths D, G"),
    ((2, 8), "validation"), ((16, 57), "main: path C Fig. 11 trace"),
    ((16, 22), "main: path C Fig. 10 c_mix trace"),
    ((16, 128), "main: path F MULTIQ step"),
    ((16, 144), "main: path E adaptive MULTIQ step"),
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
    "E": ("windowed_merge", "topk_smallest", "elim_sort"),
    "F": ("windowed_merge", "topk_smallest", "elim_sort", "twochoice_pick",
          "multiq_select"),
    "G": ("windowed_merge", "topk_smallest", "elim_sort", "twochoice_pick",
          "multiq_select"),
    "H": ("windowed_merge", "topk_smallest", "elim_sort", "twochoice_pick",
          "multiq_select"),
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


def new_profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def busy_share(prof, tag, window_s):
    """Sum the card's busy time (kernels, copies, sets) in the trace of the
    finished profiler `prof`; against the unprofiled time `window_s` of the
    same work that gives the card's busy share.  Returns (busy ms or None
    when the trace holds no device work, share or None, device calls, the
    five busiest device functions as (name, calls, ms))."""
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
        return None, None, 0, []
    busy_ms = sum(us for _, us in busy.values()) / 1e3
    top = sorted(busy.items(), key=lambda kv: -kv[1][1])[:5]
    return (busy_ms, busy_ms / (window_s * 1e3),
            sum(c for c, _ in busy.values()),
            [(name[:80], calls, us / 1e3) for name, (calls, us) in top])


def device_share(pq, carry, window, device, expect_size, window_s, tag,
                 **kw):
    """Run one more window under torch.profiler (`kw` go to `run_checked`)
    and read the card's busy share against the median unprofiled window
    time `window_s` (`busy_share`).  Returns (the share, carry after the
    window, size after the window)."""
    prof = new_profiler()
    carry, _, _, _, size = run_checked(pq, carry, window, device,
                                       expect_size, around=prof, **kw)
    return busy_share(prof, tag, window_s), carry, size


def share_line(busy_ms, share, calls, top, per="window",
               of="the median window") -> str:
    if busy_ms is None:
        return "card busy share not measured (no device events in the trace)"
    tops = "; ".join(f"{n} x{c} {ms:.3f}ms" for n, c, ms in top)
    return (f"card busy {busy_ms:.3f} ms per {per} in {calls} device calls, "
            f"share {share:.4f} of {of} (idle {1 - share:.4f}); "
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
    import torch

    from repro_torch.convert import carry_to_numpy
    from repro_torch.core.smartpq import SmartPQ

    dev = torch.device("cpu")
    pq = SmartPQ(pq_gpu.config, tree=pq_gpu.tree, device=dev)
    for w, (cfg, window, kw, (want_carry, want_res)) in enumerate(kept):
        carry = prefill(pq, cfg, seed, dev)
        carry, res, *_ = run_checked(pq, carry, window, dev, cfg["prefill"],
                                     **kw)
        what = f"path {tag} window {w}"
        _same_carry(what, carry_to_numpy(carry), want_carry)
        for f, x, y in zip(res._fields, res, want_res):
            _same_arrays(f"{what}: {f}", x.numpy(), y)
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
# phases 8-9: the application workloads
# ---------------------------------------------------------------------------

# Path E: SSSP on a random graph of 2^16 vertices (the road-graph size of
# about 2^18 takes more steps than a run can afford while the host issues
# each step), the fixed HIER engine and the adaptive default three-mode one;
# then a 4096-vertex adaptive run on the card and on the CPU
PATH_E = dict(n=65536, avg_deg=4, deg_cap=8, graph_seed=0, seed=0, S=16,
              C=1 << 14, H=256, fixed="HIER", fixed_m=32, m=16,
              max_steps=1 << 15, small_n=4096, small_seed=1,
              small_steps=2048, profile_steps=64)
# Path F: the DES hold model at a backlog of 1,048,576 events spread over
# [0, 2^20), B = 64 servers, K = 64 steps, then the bursty M/M/1 trace
PATH_F = dict(S=16, C=1 << 17, H=256, n_init=1 << 20, mean_hold=1 << 20,
              B=64, K=64, seed=0, bursty_seed=5)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed_prefills(module, device):
    """Route `module.prefill` (the drivers' pre-fill) through a wrapper
    that records its seconds, host syncs and kernel launches, so a driver's
    steps can be read apart from its pre-fill."""
    from repro_torch.kernels import ops as KO
    from repro_torch.utils import hostsync

    rec = {"s": 0.0, "syncs": 0, "launches": {}, "calls": 0}
    orig = module.prefill

    def wrapped(state, keys, vals):
        _sync(device)
        syncs, launches = hostsync.SYNCS["count"], dict(KO.LAUNCHES)
        t0 = time.perf_counter()
        out = orig(state, keys, vals)
        _sync(device)
        rec["s"] += time.perf_counter() - t0
        rec["syncs"] += hostsync.SYNCS["count"] - syncs
        rec["calls"] += 1
        for k, n in KO.LAUNCHES.items():
            rec["launches"][k] = rec["launches"].get(k, 0) + n - launches[k]
        return out

    module.prefill = wrapped
    try:
        yield rec
    finally:
        module.prefill = orig


def run_driver(module, call, device):
    """Run `call()` (a workload driver or a replay) and measure it: wall
    seconds, the pre-fill's part, and the host syncs and kernel launches of
    its steps (the pre-fill's taken out); the launches go to
    WINDOW_LAUNCHES.  Returns (what `call` returned, measurements)."""
    from repro_torch.kernels import ops as KO
    from repro_torch.utils import hostsync

    _sync(device)
    syncs, launches = hostsync.SYNCS["count"], dict(KO.LAUNCHES)
    t0 = time.perf_counter()
    with timed_prefills(module, device) as pre:
        out = call()
    _sync(device)
    wall = time.perf_counter() - t0
    steps_launches = {k: n - launches[k] - pre["launches"].get(k, 0)
                      for k, n in KO.LAUNCHES.items()}
    for k, n in steps_launches.items():
        WINDOW_LAUNCHES[k] = WINDOW_LAUNCHES.get(k, 0) + n
    return out, {"wall_s": wall, "prefill_s": pre["s"],
                 "steps_s": wall - pre["s"],
                 "syncs": hostsync.SYNCS["count"] - syncs - pre["syncs"],
                 "launches": {k: n for k, n in steps_launches.items() if n}}


def _step_line(meas, steps):
    return (f"wall {meas['wall_s']:.3f}s (pre-fill {meas['prefill_s']:.3f}s)"
            f" | {meas['steps_s'] * 1e6 / steps:.1f} us/step | host syncs "
            f"{meas['syncs'] / steps:.2f}/step | launches "
            f"{meas['launches']}")


def _modes_line(modes) -> str:
    import itertools

    runs = [(int(m), len(list(g))) for m, g in itertools.groupby(modes)]
    return f"modes seen {sorted(set(int(m) for m in modes))}, runs " + (
        f"{runs}" if len(runs) <= 12 else f"{runs[:12]} ... ({len(runs)})")


def _same_arrays(what, got, want):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{what} differs between the card and the CPU")


def _same_carry(what, got, want):
    """`got` and `want` are carries as `convert.carry_to_numpy` gives them."""
    for g, w in zip(got, want):
        for f in g:
            _same_arrays(f"{what}: carry field {f}", g[f], w[f])


def path_e(cfg=PATH_E, device=None):
    """Phase 8: SSSP.  Both engines on the 2^16-vertex graph must converge
    to `bellman_ford`'s distances; the 4096-vertex adaptive run on the card
    and on the CPU, with the same draws, must agree bit for bit (result,
    recorded trace and final carry).  Returns the launch counts, the steps
    and the adaptive queue's tree."""
    import numpy as np
    import torch

    from repro_torch.convert import carry_to_numpy
    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.core.smartpq import SmartPQ, SmartPQConfig
    from repro_torch.workloads import graphs, sssp

    dev = torch.device("cuda") if device is None else torch.device(device)
    t0 = time.perf_counter()
    g = graphs.random_graph(n=cfg["n"], avg_deg=cfg["avg_deg"],
                            deg_cap=cfg["deg_cap"], seed=cfg["graph_seed"],
                            device=dev)
    want = graphs.bellman_ford(g)
    log(f"[8 path E] random_graph n={g.n} avg_deg={cfg['avg_deg']} "
        f"deg_cap={g.deg_cap}: {g.num_edges} edges, "
        f"{int((want < INF_KEY).sum())} reachable, made on the host and "
        f"Bellman-Ford'd in {time.perf_counter() - t0:.2f}s")
    pq = SmartPQ(SmartPQConfig(num_shards=cfg["S"], capacity=cfg["C"],
                               head_width=cfg["H"], npods=2,
                               decision_interval=2), device=dev)
    counts_reset()
    steps = 0
    fixed = SCH.Schedule[cfg["fixed"]]
    runs = (
        (f"fixed {cfg['fixed']} m={cfg['fixed_m']}", lambda: sssp.run_sssp(
            g, fixed, m=cfg["fixed_m"], num_shards=cfg["S"],
            capacity=cfg["C"], head_width=cfg["H"], npods=2, seed=cfg["seed"],
            max_steps=cfg["max_steps"])),
        (f"adaptive three-mode m={cfg['m']} (B={cfg['m'] * (g.deg_cap + 1)})",
         lambda: sssp.run_sssp_smartpq(g, pq, m=cfg["m"], seed=cfg["seed"],
                                       max_steps=cfg["max_steps"])[0]),
    )
    for name, call in runs:
        res, meas = run_driver(sssp, call, dev)
        if not res.converged:
            raise AssertionError(f"path E {name}: no convergence in "
                                 f"{res.steps} steps")
        if not np.array_equal(res.dist, want):
            raise AssertionError(f"path E {name}: distances differ from "
                                 f"bellman_ford")
        steps += res.steps
        modes = "" if res.modes is None else (
            f" | {_modes_line(res.modes)}, transitions {res.transitions}")
        log(f"[8 path E] {name}, S={cfg['S']} C={cfg['C']}: {res.steps} "
            f"steps, {res.pops} pops ({res.wasted} wasted), {res.improved} "
            f"improved relaxations{modes} | {_step_line(meas, res.steps)} | "
            f"distances equal bellman_ford")

    # the card's busy share over the adaptive engine's first steps
    n = cfg["profile_steps"]

    def first_steps():
        return sssp.run_sssp_smartpq(g, pq, m=cfg["m"], seed=cfg["seed"],
                                     max_steps=n)

    _, meas = run_driver(sssp, first_steps, dev)
    steps += n
    prof = new_profiler()
    with prof:
        first_steps()
    log(f"[8 path E profile] adaptive, its first {n} steps: " + share_line(
        *busy_share(prof, "E", meas["wall_s"]), per=f"{n} steps",
        of="the same steps unprofiled"))

    # the 4096-vertex adaptive run, card and CPU, one stream of draws
    cpu = SmartPQ(pq.config, tree=pq.tree, device="cpu")
    B = cfg["m"] * (cfg["deg_cap"] + 1)
    draws = SCH.step_draws(pq.config.mode_schedules, cfg["S"], B, cfg["H"],
                           steps=cfg["small_steps"],
                           generator=torch.Generator().manual_seed(7))
    engines = [sssp.make_smartpq_sssp_engine(graphs.random_graph(
        n=cfg["small_n"], avg_deg=cfg["avg_deg"], deg_cap=cfg["deg_cap"],
        seed=cfg["small_seed"], device=q.device), q, m=cfg["m"])
        for q in (pq, cpu)]

    def small_run(engine):
        return engine(seed=cfg["seed"], max_steps=cfg["small_steps"],
                      record=True, draws=draws, return_carry=True)

    (rg, tg, cg), meas = run_driver(sssp, lambda: small_run(engines[0]), dev)
    steps += rg.steps
    rc, tc, cc = small_run(engines[1])
    if not rc.converged:
        raise AssertionError("path E 4096-vertex run: no convergence")
    for f in rc._fields:
        _same_arrays(f"path E SSSPResult.{f}", getattr(rg, f), getattr(rc, f))
    for f in tc._fields:
        _same_arrays(f"path E trace.{f}", getattr(tg, f), getattr(tc, f))
    _same_carry("path E", carry_to_numpy(cg), carry_to_numpy(cc))
    log(f"[8 path E cpu] adaptive n={cfg['small_n']}: {rc.steps} steps, "
        f"{rc.pops} pops, {_modes_line(rc.modes)} | card: "
        f"{_step_line(meas, rg.steps)} | SSSPResult, trace and final carry "
        f"bit-identical on the card and the CPU")
    launches, in_windows = counts_read("E")
    return (launches, in_windows, steps), pq.tree


def path_f(cfg=PATH_F, tree=None, device=None):
    """Phase 9: the DES hold model at a 1,048,576-event backlog: STRICT_FLAT
    against `hold_model_oracle` step by step, MULTIQ conserving events, the
    adaptive three-mode run recorded and its trace replayed to the same
    pops; then the bursty M/M/1 trace saved, loaded and replayed on the
    card and on the CPU with the same draws, bit-identical.  Returns the
    launch counts and steps."""
    import numpy as np
    import torch

    from repro_torch.convert import carry_to_numpy
    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.core.smartpq import SmartPQ, SmartPQConfig
    from repro_torch.workloads import des, traces

    dev = torch.device("cuda") if device is None else torch.device(device)
    B, K = cfg["B"], cfg["K"]

    def make(schedules=None, device=dev):
        kw = {} if schedules is None else {
            "mode_schedules": (SCH.Schedule[schedules],) * 3}
        return SmartPQ(SmartPQConfig(num_shards=cfg["S"], capacity=cfg["C"],
                                     head_width=cfg["H"], npods=2,
                                     decision_interval=2, **kw),
                       tree=tree, device=device)

    run_kw = dict(B=B, K=K, mean_hold=cfg["mean_hold"], seed=cfg["seed"],
                  n_init=cfg["n_init"])
    counts_reset()
    steps = 0
    t0 = time.perf_counter()
    oracle = des.hold_model_oracle(B, K, cfg["mean_hold"], cfg["seed"],
                                   cfg["n_init"])
    oracle_s = time.perf_counter() - t0
    adaptive = make()
    draws = SCH.step_draws(adaptive.config.mode_schedules, cfg["S"], 2 * B,
                           cfg["H"], steps=K,
                           generator=torch.Generator().manual_seed(11))
    for name, pq, kw in (("STRICT_FLAT", make("STRICT_FLAT"), {}),
                         ("MULTIQ pinned", make("MULTIQ"), {}),
                         ("adaptive three-mode, recorded", adaptive,
                          dict(record=True, draws=draws))):
        res, meas = run_driver(
            des, lambda pq=pq, kw=kw: des.run_hold_model(pq, **run_kw, **kw),
            dev)
        steps += K
        check = ""
        if name == "STRICT_FLAT":
            for t in range(K):
                got = res.popped[t][: res.n_out[t]]
                if not np.array_equal(got, np.asarray(oracle[t], np.int32)):
                    raise AssertionError(f"path F STRICT_FLAT step {t}: pops "
                                         f"differ from hold_model_oracle")
            check = (f"pops equal hold_model_oracle step by step (heapq "
                     f"{oracle_s:.2f}s)")
        rescheduled = int(np.sum(res.n_out[:-1]))
        if res.events + res.final_size != cfg["n_init"] + rescheduled:
            raise AssertionError(f"path F {name}: events not conserved")
        check = check or "events conserved"
        log(f"[9 path F] hold model {name}, S={cfg['S']} C={cfg['C']} "
            f"n_init={cfg['n_init']} mean_hold={cfg['mean_hold']} B={B} "
            f"K={K}: {res.events} events, {res.final_size} queued after, "
            f"{res.events / meas['steps_s']:.0f} events/s | "
            f"{_modes_line(res.modes)}, transitions {res.transitions} | "
            f"{_step_line(meas, K)} | {check}")
    (_, rep), meas = run_driver(
        traces, lambda: traces.replay(adaptive, res.trace, draws=draws), dev)
    steps += K
    if not (np.array_equal(rep.keys[:, :B].cpu().numpy(), res.popped)
            and np.array_equal(rep.mode.cpu().numpy(), res.modes)):
        raise AssertionError("path F: the recorded trace's replay differs "
                             "from the live run")
    log(f"[9 path F] recorded trace replayed in one window: pops and modes "
        f"equal the live run | {_step_line(meas, K)}")

    trace = traces.bursty_des_trace(phases=traces.BURSTY_PHASES,
                                    seed=cfg["bursty_seed"])
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "bursty_des.npz"
    traces.save_trace(path, trace)
    loaded = traces.load_trace(path)
    draws = SCH.step_draws(adaptive.config.mode_schedules, cfg["S"],
                           loaded.width, cfg["H"], steps=loaded.num_steps,
                           generator=torch.Generator().manual_seed(13))
    (cg, rg), meas = run_driver(
        traces, lambda: traces.replay(adaptive, loaded, draws=draws), dev)
    steps += loaded.num_steps
    prof = new_profiler()
    with prof:
        traces.replay(adaptive, loaded, draws=draws)
    log(f"[9 path F profile] bursty DES replay: " + share_line(
        *busy_share(prof, "F", meas["wall_s"]), per="window",
        of="the same window unprofiled"))
    cc, rc = traces.replay(make(device="cpu"), loaded, draws=draws)
    for f in rc._fields:
        _same_arrays(f"path F bursty replay {f}", getattr(rg, f).cpu(),
                     getattr(rc, f))
    _same_carry("path F bursty replay", carry_to_numpy(cg),
                carry_to_numpy(cc))
    log(f"[9 path F cpu] bursty DES trace (K={loaded.num_steps}, "
        f"B={loaded.width}) saved, loaded and replayed: "
        f"{int(rc.n_out.sum())} events, {_modes_line(rc.mode.tolist())}, "
        f"transitions {int(cc.stats.transitions)} | card: "
        f"{_step_line(meas, loaded.num_steps)} | outputs, mode trace and "
        f"carry bit-identical on the card and the CPU")
    launches, in_windows = counts_read("F")
    return launches, in_windows, steps


# ---------------------------------------------------------------------------
# phase 10: the serving tier
# ---------------------------------------------------------------------------

# Path G: the serving scheduler's default queue (src/repro/serve/
# scheduler.py:163-166, 16 shards x 8,192 slots, B = 64 lanes, HIER at
# first) under the synthetic-decode engine.  G1: benchmarks/serve_slo.py:
# 25-58 (8 decode slots); G2: benchmarks/overload.py:31-56 at 64 slots:
# load x 64 / 8.5 arrivals a tick (8.5 tokens the mean request), 4x open
# loop and controlled, and 2x controlled: at 4x class 0 alone (a quarter
# of the arrivals) loads the slots fully, so the controller's MULTIQ vote,
# gated on class 0 being OK, never comes; at 2x it does.  G3: the guard
# tier.
PATH_G = dict(
    slo=dict(steps=64, seed=1, batch_size=8, windows=(1, 4, 16),
             max_steps=100_000, draws=512),
    overload=dict(ticks=512, seed=7, batch_size=64, K=4,
                  backlog_cap=4096, targets=(8.0, 16.0, 32.0),
                  runs=(("open loop", 4, False), ("controlled", 4, True),
                        ("controlled", 2, True)),
                  max_steps=3 * 512, cpu_ticks=128, profile=(448, 512),
                  min_peak=2000),
    guard=dict(K=4, windows=6, per_tick=40, budget=24, trip_window=2,
               seed=3),
    S=16, B=64, H=256, max_seq=512)


def serve_draws(ticks, seed):
    """`ticks` ticks of the default three-mode queue's draws, from a CPU
    generator, so a CPU rerun can take the very same ones."""
    import torch

    from repro_torch.core.pqueue import schedules as SCH

    c = PATH_G
    return SCH.step_draws((SCH.Schedule.SPRAY_HERLIHY, SCH.Schedule.MULTIQ,
                           SCH.Schedule.HIER), c["S"], c["B"], c["H"],
                          steps=ticks,
                          generator=torch.Generator().manual_seed(seed))


def serve_run(eng, workload, max_steps, check=False, capture_at=None,
              profile=None):
    """`eng.run(workload, max_steps)`, measured: wall seconds and host
    syncs less the probe's own, kernel launches (added to WINDOW_LAUNCHES),
    each window's seconds.  A probe after every window reads `health()`
    when `check` and fails unless ``inserted == dispatched + on_device``
    and ``inserted + arrival_backlog + shed + evicted == submitted``
    (requeued requests counted as submitted again); it counts the windows
    after which the overload controller votes MULTIQ for the next; at step
    `capture_at` it keeps the carry, health, completion steps and mode
    trace;
    `profile` = (first tick, end tick) runs those windows under
    torch.profiler.  Returns (summary, measurements)."""
    from repro_torch.convert import carry_to_numpy
    from repro_torch.kernels import ops as KO
    from repro_torch.utils import hostsync

    dev = eng.device
    rec = {"probe_s": 0.0, "probe_syncs": 0, "peak_on_device": 0,
           "capture": None, "requeued": 0, "submitted": 0, "window_s": {},
           "prof": None, "checks": 0, "votes": 0}
    sched = eng.scheduler
    advance, requeue = eng._advance, sched.requeue

    def counted_requeue(reqs):
        rec["requeued"] += len(reqs)
        requeue(reqs)

    def probed(arr, step0, max_steps):
        if profile and step0 == profile[0]:
            rec["prof"] = new_profiler()
            rec["prof"].start()
        t0 = time.perf_counter()
        out = advance(arr, step0, max_steps)
        _sync(dev)
        rec["window_s"][step0] = (out[1], time.perf_counter() - t0)
        if profile and step0 + out[1] == profile[1]:
            rec["prof"].stop()
        t0, syncs = time.perf_counter(), hostsync.SYNCS["count"]
        rec["submitted"] += sum(map(len, arr))
        if eng.overload is not None:
            rec["votes"] += eng.overload.mode_override() == 1
        if check:
            h = eng.health()
            if h["inserted"] != h["dispatched"] + h["on_device"]:
                raise AssertionError(f"step {step0}: inserted {h['inserted']}"
                                     f" != dispatched + on_device {h}")
            if (h["inserted"] + h["arrival_backlog"] + h["shed"]
                    + h["evicted"] != rec["submitted"] + rec["requeued"]):
                raise AssertionError(f"step {step0}: requests not conserved "
                                     f"({rec['submitted']} submitted, "
                                     f"{rec['requeued']} requeued, {h})")
            rec["peak_on_device"] = max(rec["peak_on_device"],
                                        h["on_device"])
            rec["checks"] += 1
        if capture_at is not None and step0 + out[1] == capture_at:
            rec["capture"] = (carry_to_numpy(sched.carry), eng.health(),
                              dict(eng.done_step),
                              list(sched.stats.mode_trace))
        rec["probe_s"] += time.perf_counter() - t0
        rec["probe_syncs"] += hostsync.SYNCS["count"] - syncs
        return out

    eng._advance, sched.requeue = probed, counted_requeue
    try:
        _sync(dev)
        syncs, launches = hostsync.SYNCS["count"], dict(KO.LAUNCHES)
        t0 = time.perf_counter()
        summary = eng.run(workload, max_steps=max_steps)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        del eng._advance, sched.requeue
    run_launches = {k: n - launches[k] for k, n in KO.LAUNCHES.items()}
    for k, n in run_launches.items():
        WINDOW_LAUNCHES[k] = WINDOW_LAUNCHES.get(k, 0) + n
    rec.update(
        wall_s=wall - rec["probe_s"],
        syncs=hostsync.SYNCS["count"] - syncs - rec["probe_syncs"],
        launches={k: n for k, n in run_launches.items() if n})
    return summary, rec


def _slo_line(eng, summary, meas) -> str:
    m = eng.obs.metrics
    tokens = float(m.value("tokens_emitted_total"))
    ticks = summary["steps"]
    classes = "; ".join(
        f"c{c}: queue p50/p99 {m.percentile('latency_queue_steps', 50, slo=c)}"
        f"/{m.percentile('latency_queue_steps', 99, slo=c)}, per-token "
        f"p50/p99 {m.percentile('latency_per_token_steps', 50, slo=c)}/"
        f"{m.percentile('latency_per_token_steps', 99, slo=c)} steps "
        f"({m.hist_count('latency_queue_steps', slo=c)} done)"
        for c in range(3))
    return (f"{summary['completed']} completed in {ticks} ticks | "
            f"{meas['wall_s'] * 1e6 / max(tokens, 1):.1f} us/token, "
            f"{meas['wall_s'] * 1e6 / ticks:.1f} us/tick, "
            f"{tokens / ticks:.3f} tokens/step | {classes} | "
            f"{_modes_line(summary['mode_trace'])}, transitions "
            f"{summary['pq_transitions']} | host syncs "
            f"{meas['syncs'] / ticks:.2f}/tick | launches/tick "
            + str({k: round(n / ticks, 3)
                   for k, n in sorted(meas['launches'].items())}))


def _same_serving(what, eng, want_carry, want_health, want_done, want_modes):
    from repro_torch.convert import carry_to_numpy

    _same_carry(what, carry_to_numpy(eng.scheduler.carry), want_carry)
    if eng.health() != want_health:
        raise AssertionError(f"{what}: health() differs between the card "
                             f"and the CPU")
    if eng.done_step != want_done:
        raise AssertionError(f"{what}: completion steps differ")
    if eng.scheduler.stats.mode_trace != want_modes:
        raise AssertionError(f"{what}: mode traces differ")


def path_g1(tree, cfg=PATH_G, device=None):
    """G1: the SLO run at K = 1, 4, 16, forecast off and on, on injected
    draws, then K = 4 with the forecast on the scheduler's own CUDA
    generator (what `ServeEngine` runs when no draws are given), with the
    conservation identities after every window.  Each window's arrivals and
    budgets are logged and replayed as K `tick` calls on a fresh scheduler
    with the same draws or the same seed: the same dispatch stream, mode
    trace and carry (but `ring_deferred`, a window's own counter).  The
    K = 4 forecast run on injected draws is rerun on the CPU.  Returns the
    engine runs' ticks."""
    import torch

    from repro_torch.convert import carry_to_numpy
    from repro_torch.serve import EngineConfig, ServeEngine, SmartPQScheduler
    from repro_torch.workloads import traces

    c = cfg["slo"]
    dev = torch.device("cuda") if device is None else torch.device(device)
    draws = serve_draws(c["draws"], 17)
    ticks = 0
    runs = ([(1, True, draws)] + [(K, f, draws) for K in c["windows"][1:]
                                  for f in (False, True)]
            + [(4, True, None)])
    for K, forecast, run_draws in runs:
        ecfg = EngineConfig(batch_size=c["batch_size"],
                            max_seq=cfg["max_seq"], sched_window=K,
                            forecast=forecast)
        wl = traces.bursty_serve_workload(steps=c["steps"], seed=c["seed"])
        total = sum(map(len, wl))
        eng = ServeEngine(None, None, ecfg, seed=0, device=dev, tree=tree,
                          draws=run_draws)
        log_ = []
        tick_window = eng.scheduler.tick_window

        def logged(arrivals, budgets, _tw=tick_window, _log=log_):
            out = _tw(arrivals, budgets)
            _log.append(([list(a) for a in arrivals], list(budgets),
                         [[r.uid for r in t] for t in out]))
            return out

        eng.scheduler.tick_window = logged
        summary, meas = serve_run(eng, wl, c["max_steps"], check=True)
        del eng.scheduler.tick_window
        ticks += summary["steps"]
        if summary["completed"] != total:
            raise AssertionError(f"path G1 K={K}: {summary['completed']} of "
                                 f"{total} requests completed")
        check = ""
        if K > 1:
            seq = SmartPQScheduler(batch_size=cfg["B"], seed=0, device=dev,
                                   tree=tree, draws=run_draws)
            for arrivals, budgets, want in log_:
                got = [[r.uid for r in seq.tick(a, b)]
                       for a, b in zip(arrivals, budgets)]
                if got != want:
                    raise AssertionError(f"path G1 K={K}: a window's "
                                         f"dispatch stream differs from K "
                                         f"ticks")
            if seq.stats != eng.scheduler.stats:
                raise AssertionError(f"path G1 K={K}: scheduler stats "
                                     f"differ from K ticks")
            got_c, want_c = (carry_to_numpy(x) for x in (eng.scheduler.carry,
                                                         seq.carry))
            got_c[1].pop("ring_deferred"), want_c[1].pop("ring_deferred")
            _same_carry(f"path G1 K={K} window against ticks", got_c, want_c)
            check = (f" | {len(log_)} windows equal K ticks replayed with "
                     f"their budgets")
        if K == 4 and forecast and run_draws is not None:
            cpu = ServeEngine(None, None, ecfg, device="cpu", tree=tree,
                              draws=draws)
            cpu.run(traces.bursty_serve_workload(steps=c["steps"],
                                                 seed=c["seed"]),
                    max_steps=c["max_steps"])
            _same_serving("path G1 K=4 forecast", cpu,
                          carry_to_numpy(eng.scheduler.carry), eng.health(),
                          eng.done_step, eng.scheduler.stats.mode_trace)
            check += " | rerun on the CPU: completion steps, mode trace, " \
                     "health and carry bit-identical"
        log(f"[10 path G1] serve_slo K={K} forecast={forecast}, draws "
            f"{'injected' if run_draws is not None else 'CUDA generator'}, "
            f"{total} requests, {c['batch_size']} slots: "
            f"{_slo_line(eng, summary, meas)} | conservation identities held "
            f"after {meas['checks']} windows{check}")
    return ticks


def path_g2(tree, cfg=PATH_G, device=None):
    """G2: the deep backlog under overload (`runs`: name, load, control),
    with the conservation identities after every window.  The open-loop
    runs draw from the scheduler's own CUDA generator, as a `ServeEngine`
    given no draws does; the controlled runs take injected draws, so that
    their first ticks can be rerun on the CPU, and the 2x one must vote
    MULTIQ (launching `twochoice_pick` and `multiq_select`); then 64 deep
    ticks of the 4x open-loop run under the profiler.  Returns the ticks
    run."""
    import torch

    from repro_torch.kernels import ops as KO
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.workloads import traces

    c = cfg["overload"]
    dev = torch.device("cuda") if device is None else torch.device(device)
    draws = serve_draws(c["max_steps"] + c["K"], 19)

    def workload(load):
        return traces.open_loop_requests(traces.poisson_arrival_counts(
            c["ticks"], load * c["batch_size"] / 8.5, seed=c["seed"]),
            seed=c["seed"])

    def engine(targets, device=dev):
        return ServeEngine(None, None, EngineConfig(
            batch_size=c["batch_size"], max_seq=cfg["max_seq"],
            sched_window=c["K"], forecast=True, slo_targets=targets,
            backlog_cap=c["backlog_cap"]), seed=c["seed"], device=device,
            tree=tree, draws=None if targets is None else draws)

    ticks = 0
    window_s = None
    for name, load, control in c["runs"]:
        targets = c["targets"] if control else None
        total = sum(map(len, workload(load)))
        eng = engine(targets)
        launches0 = dict(KO.LAUNCHES)
        summary, meas = serve_run(
            eng, workload(load), c["max_steps"], check=True,
            capture_at=c["cpu_ticks"] if control else None)
        ticks += summary["steps"]
        h = eng.health()
        ran = {k: KO.LAUNCHES[k] - launches0[k]
               for k in ("twochoice_pick", "multiq_select")}
        note = (f" | MULTIQ ticks {summary['mode_trace'].count(1)}, "
                f"controller's MULTIQ votes {meas['votes']} windows, "
                f"MULTIQ kernel launches {ran}")
        if not control:
            window_s = meas["window_s"]
            if meas["peak_on_device"] < c["min_peak"]:
                raise AssertionError(f"path G2 open loop: the device queue "
                                     f"peaked at {meas['peak_on_device']}")
        else:
            if load == 2 and not (meas["votes"] and all(ran.values())):
                raise AssertionError(f"path G2 controlled 2x: no MULTIQ vote "
                                     f"ran (launches {ran})")
            cpu = engine(targets, device="cpu")
            cpu.run(workload(load), max_steps=c["cpu_ticks"])
            _same_serving(f"path G2 controlled {load}x, first "
                          f"{c['cpu_ticks']} ticks", cpu, *meas["capture"])
            note += (f" | first {c['cpu_ticks']} ticks rerun on the CPU: "
                     f"carry, health, completion steps and mode trace "
                     f"bit-identical")
        log(f"[10 path G2] overload {name} {load}x, {total} open-loop "
            f"requests over {c['ticks']} ticks, {c['batch_size']} slots, "
            f"K={c['K']}, draws "
            f"{'CUDA generator' if targets is None else 'injected'}: "
            f"peak on_device {meas['peak_on_device']}, "
            f"{h['pending']} pending at the end, shed {h['shed']}, evicted "
            f"{h['evicted']}, requeued {meas['requeued']} | "
            f"{_slo_line(eng, summary, meas)} | conservation identities held "
            f"after {meas['checks']} windows{note}")
    lo, hi = c["profile"]
    eng = engine(None)
    _, meas = serve_run(eng, workload(c["runs"][0][1]), hi,
                        profile=(lo, hi))
    ticks += hi
    unprofiled = sum(s for step0, (n, s) in window_s.items()
                     if lo <= step0 < hi)
    log(f"[10 path G2 profile] open loop, ticks {lo}-{hi}: " + share_line(
        *busy_share(meas["prof"], "G", unprofiled), per=f"{hi - lo} ticks",
        of="the same ticks unprofiled"))
    return ticks


def path_g3(tree, cfg=PATH_G, device=None):
    """G3: the guard tier on the default queue with `validate=True`: a hook
    that trips once recovers the window (one `recovered_windows`) with the
    dispatch stream and carry of that window run on the fallback queue
    directly; a hook that trips twice raises `WindowValidationError` with
    the carry and host state of the pre-window checkpoint."""
    import numpy as np
    import torch

    from repro_torch.core.errors import (InvariantViolation,
                                         WindowValidationError)
    from repro_torch.core.smartpq import (MODE_AWARE, SmartPQConfig,
                                          carry_fingerprint)
    from repro_torch.serve import Request, SmartPQScheduler

    c = cfg["guard"]
    dev = torch.device("cuda") if device is None else torch.device(device)
    K = c["K"]
    draws = serve_draws(K * (c["windows"] + 1), 23)
    trips = {"left": 0}

    def hook(state):
        if trips["left"]:
            trips["left"] -= 1
            return [InvariantViolation("I9", -1, "tripwire")]
        return []

    def sched(**kw):
        # the scheduler's default queue with the guard tier armed, as
        # `EngineConfig(validate=True)` builds it
        return SmartPQScheduler(
            batch_size=cfg["B"], device=dev, tree=tree, draws=draws,
            pq_config=SmartPQConfig(num_shards=16, capacity=8192, npods=2,
                                    decision_interval=4,
                                    initial_mode=MODE_AWARE, validate=True),
            **kw)

    guarded, direct = sched(validate_hook=hook), sched()
    rng = np.random.default_rng(c["seed"])
    uid = 0
    for w in range(c["windows"]):
        arrivals = []
        for t in range(K):
            n = int(rng.integers(0, 2 * c["per_tick"]))
            arrivals.append([(uid + i, int(rng.integers(1, 64)),
                              int(rng.integers(0, 3)), w * K + t)
                             for i in range(n)])
            uid += n
        budgets = [int(rng.integers(0, c["budget"])) for _ in range(K)]
        outs = []
        for s in (guarded, direct):
            reqs = [[Request(uid=u, prompt_len=p, max_new_tokens=4,
                             slo_class=cl, arrival_step=a)
                     for u, p, cl, a in tick] for tick in arrivals]
            if s is guarded:
                trips["left"] = int(w == c["trip_window"])
                out = s.tick_window(reqs, budgets)
            else:
                out = s._window_impl(reqs, budgets, w == c["trip_window"])
            outs.append([[r.uid for r in t] for t in out])
        if outs[0] != outs[1]:
            raise AssertionError(f"path G3 window {w}: the guarded run's "
                                 f"dispatch stream differs from the direct "
                                 f"run's")
    if (guarded.stats.recovered_windows, guarded.stats.failed_windows) != (
            1, 0):
        raise AssertionError(f"path G3: stats {guarded.stats}")
    if carry_fingerprint(guarded.carry) != carry_fingerprint(direct.carry):
        raise AssertionError("path G3: the recovered run's carry differs "
                             "from the direct fallback run's")
    fp, host = carry_fingerprint(guarded.carry), guarded.host_state()
    trips["left"] = 2
    try:
        guarded.tick_window([[] for _ in range(K)], [8] * K)
    except WindowValidationError:
        pass
    else:
        raise AssertionError("path G3: a window tripped twice did not raise")
    host["stats"]["failed_windows"] = 1
    if carry_fingerprint(guarded.carry) != fp or guarded.host_state() != host:
        raise AssertionError("path G3: the checkpoint was not restored")
    log(f"[10 path G3] guard tier, validate=True, {c['windows']} windows of "
        f"K={K} ({uid} requests): window {c['trip_window']} tripped once and "
        f"recovered on the STRICT_FLAT fallback queue, dispatch stream and "
        f"carry equal to running it there directly; a window tripped twice "
        f"raised WindowValidationError with the carry (fingerprint "
        f"{fp:#010x}) and host state of its checkpoint restored")


def path_g(tree):
    """Phase 10: G1-G3 on the card.  The path's launch counts are those of
    its engine runs alone (each `serve_run` adds its run's launches to
    WINDOW_LAUNCHES), per tick over those runs' ticks (an engine tick is a
    window of one step): G1's K-tick replays and G3's schedulers are checks
    and stay out of the counts."""
    from repro_torch.kernels import ops as KO

    counts_reset()
    ticks = path_g1(tree) + path_g2(tree)
    path_g3(tree)
    _, in_runs = counts_read("G")
    return {k: in_runs.get(k, 0) for k in KO.LAUNCHES}, in_runs, ticks


# ---------------------------------------------------------------------------
# phase 11: durable serving
# ---------------------------------------------------------------------------

# Path H: the durable engine (`EngineConfig.durable_dir`) on the serving
# scheduler's default queue (16 x 8,192 slots, B = 64, HIER at first),
# write-ahead log fsynced unless stated.  H1: benchmarks/durability.py:
# 57-106 at G1's workload (`bursty_serve_workload(steps=64, seed=1)`, 8
# slots, K = 4, the scheduler's CUDA generator): not durable, durable with
# fsync, durable without and not durable again, a snapshot every 4
# windows; then 16 deep ticks profiled.  H2: tests/test_durability.py:352-416's SIGKILL drill on
# the card (`python -m repro_torch.serve.worker --device cuda --steps 24
# --seed 3 --snapshot-interval 3`) at K = 1 and 16, and the supervised run
# at K = 4.  H3: benchmarks/durability.py:109-154, recovery time against
# snapshot cadence.  H4: recovery from each damage injector on copies of
# H1's store.  H5: G2's 2x controlled workload (64 slots, K = 4, injected
# draws; the controller votes MULTIQ after 96 ticks, so the path launches
# the MULTIQ kernels too) as a durable run paused at step 8 and resumed,
# against the same run uninterrupted on the card and on the CPU.
PATH_H = dict(
    wal=dict(steps=64, seed=1, batch_size=8, K=4, snapshot_interval=4,
             max_steps=100_000, profile=(32, 48), bar=1.10),
    drill=dict(steps=24, seed=3, snapshot_interval=3, windows=(1, 16),
               kill_at=9, supervised_K=4, timeout=600),
    mttr=dict(steps=48, seed=11, batch_size=8, K=4, intervals=(2, 8, 32)),
    damage=(("torn_wal", ""), ("torn_wal", "flip"), ("torn_wal", "garbage"),
            ("partial_snapshot", "truncate"), ("partial_snapshot", "delete"),
            ("stale_manifest", ""), ("stale_manifest", "garbage")),
    resume=dict(ticks=160, pause_at=8, load=2, seed=7, batch_size=64, K=4,
                targets=(8.0, 16.0, 32.0), snapshot_interval=4))
H_DIR = TRACE_DIR / "durable"


def _durable_engine(tree, root, device, K, batch_size, seed=0,
                    snapshot_interval=4, fsync=True, draws=None, **kw):
    from repro_torch.serve import EngineConfig, ServeEngine

    return ServeEngine(None, None, EngineConfig(
        batch_size=batch_size, max_seq=PATH_G["max_seq"], sched_window=K,
        forecast=True, durable_dir=None if root is None else str(root),
        wal_fsync=fsync, snapshot_interval=snapshot_interval, **kw),
        seed=seed, device=device, tree=tree, draws=draws)


def _served(eng):
    """What a finished serving run must reproduce: completion steps,
    outputs and the carry's fingerprint."""
    from repro_torch.core.smartpq import carry_fingerprint

    return (dict(eng.done_step), {u: list(v) for u, v in eng.outputs.items()},
            carry_fingerprint(eng.scheduler.carry))


@contextlib.contextmanager
def timed_durability(eng):
    """Record the seconds of each call the durable engine's loop makes
    beside its windows, by part: the log's window record and its sync, the
    registry read before a commit, the commit record with its sync and the
    heartbeat, and a snapshot (its read of the card, the write with its
    fsyncs, the prune; the rest of a snapshot is its fingerprint and host
    state), with each snapshot's bytes on disk.  Yields {part: [seconds,
    ...], "bytes": [...]}."""
    from repro_torch.core import persist

    rec = {}
    undo = []

    def wrap(owner, name, key, after=None):
        fn = getattr(owner, name)

        def timed(*a, **k):
            if key == "snapshot":
                _sync(eng.device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec.setdefault(key, []).append(time.perf_counter() - t0)
            if after is not None:
                after(out)
            return out

        setattr(owner, name, timed)
        undo.append((owner, name, fn))

    def size(path):
        rec.setdefault("bytes", []).append(
            sum(p.stat().st_size for p in path.iterdir()))

    store = eng.durability
    wrap(store, "log_window", "log window")
    wrap(eng, "_sync_registry", "registry read")
    wrap(store, "log_commit", "log commit")
    wrap(eng, "snapshot", "snapshot", after=size)
    wrap(persist, "host_tree", "snapshot: card read")
    wrap(persist, "save_tree", "snapshot: write")
    wrap(persist, "prune_steps", "snapshot: prune")
    try:
        yield rec
    finally:
        for owner, name, fn in reversed(undo):
            if owner is persist:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def path_h1(tree, cfg=PATH_H, device="cuda"):
    """H1: what the log and the snapshots cost.  Returns the fsync run's
    store and engine, and the ticks run."""
    import torch

    from repro_torch.workloads import traces

    c = cfg["wal"]
    dev = torch.device(device)
    ticks = 0
    runs = {}
    # the run that is not durable comes first and last: the spread of the
    # two is the host noise the ratios stand against
    for name, tag, fsync in (("not durable", None, True),
                             ("durable, fsync", "fsync", True),
                             ("durable, no fsync", "nofsync", False),
                             ("not durable, again", None, True)):
        root = None if tag is None else H_DIR / f"h1_{tag}"
        eng = _durable_engine(tree, root, dev, c["K"], c["batch_size"],
                              fsync=fsync,
                              snapshot_interval=c["snapshot_interval"])
        wl = traces.bursty_serve_workload(steps=c["steps"], seed=c["seed"])
        with (timed_durability(eng) if root is not None
              else contextlib.nullcontext({})) as parts:
            summary, meas = serve_run(eng, wl, c["max_steps"], check=True)
        ticks += summary["steps"]
        if summary["completed"] != sum(map(len, wl)):
            raise AssertionError(f"path H1 {name}: {summary['completed']} "
                                 f"of {sum(map(len, wl))} completed")
        runs[name] = (eng, summary, meas, parts, root)
    base = runs["not durable"]
    us_tick = {k: r[2]["wall_s"] * 1e6 / r[1]["steps"]
               for k, r in runs.items()}
    plain = (us_tick["not durable"] + us_tick["not durable, again"]) / 2
    for name, (eng, summary, meas, parts, _) in runs.items():
        if (_served(eng) != _served(base[0])
                or summary["steps"] != base[1]["steps"]):
            raise AssertionError(f"path H1 {name}: completion steps, outputs"
                                 f" or carry differ from the run that is "
                                 f"not durable")
        tokens = float(eng.obs.metrics.value("tokens_emitted_total"))
        advance = sum(s for _, s in meas["window_s"].values())
        line = (f"[11 path H1] {name}: {summary['completed']} completed in "
                f"{summary['steps']} ticks | {us_tick[name]:.1f} us/tick, "
                f"{meas['wall_s'] * 1e6 / tokens:.1f} us/token, "
                f"{us_tick[name] / plain:.4f}x the mean of the two runs "
                f"that are not durable (the reference's bar "
                f"{c['bar']:.2f}x, printed, not gated) | inside the windows "
                f"{advance * 1e6 / summary['steps']:.1f} us/tick, beside "
                f"them {(meas['wall_s'] - advance) * 1e6 / summary['steps']:.1f}"
                f" us/tick ({1 - advance / meas['wall_s']:.4f} of the run) | "
                f"host syncs {meas['syncs'] / summary['steps']:.2f}/tick")
        if eng.durability is not None:
            st = eng.durability.stats
            m = eng.obs.metrics
            syncs = (m.value("wal_syncs_total", kind="window")
                     + m.value("wal_syncs_total", kind="commit"))
            line += (f" | WAL {st.records_appended} records, "
                     f"{st.bytes_appended} bytes, {int(syncs)} syncs "
                     f"({'fsync' if eng.ecfg.wal_fsync else 'flush only'}) "
                     f"| {st.snapshots_written} snapshots of "
                     f"{parts['bytes'][-1]} bytes on disk, one host read "
                     f"each | ms a call, mean (min-max) [sum over the run]: "
                     + "; ".join(
                         f"{k} {1e3 * sum(v) / len(v):.3f} "
                         f"({1e3 * min(v):.3f}-{1e3 * max(v):.3f}) "
                         f"[{1e3 * sum(v):.1f}]"
                         for k, v in parts.items() if k != "bytes"))
            eng.durability.close()
        log(line + " | completion steps, outputs and carry fingerprint "
            "equal across the four runs")
    # 16 deep ticks of the fsync run, unprofiled and then profiled: each on
    # a fresh store run to the first tick, then timed to the last
    lo, hi = c["profile"]
    seg = {}
    for tag in ("plain", "profiled"):
        eng = _durable_engine(tree, H_DIR / f"h1_profile_{tag}", dev, c["K"],
                              c["batch_size"],
                              snapshot_interval=c["snapshot_interval"])
        wl = traces.bursty_serve_workload(steps=c["steps"], seed=c["seed"])
        eng.run(wl, max_steps=lo)
        prof = new_profiler() if tag == "profiled" else None
        _sync(dev)
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext():
            eng.run(wl, max_steps=hi)
            _sync(dev)
        seg[tag] = (time.perf_counter() - t0, prof)
        ticks += hi
        eng.durability.close()
    log(f"[11 path H1 profile] durable with fsync, ticks {lo}-{hi} (4 "
        f"windows, each logged and committed, and a snapshot): "
        f"{seg['plain'][0] * 1e3:.3f} ms unprofiled | " + share_line(
            *busy_share(seg["profiled"][1], "H", seg["plain"][0]),
            per=f"{hi - lo} ticks", of="the same ticks unprofiled"))
    _, _, _, _, root = runs["durable, fsync"]
    return root, runs["durable, fsync"][0], ticks


def _worker_args(store, K, c, device, kill=False):
    args = ["--dir", str(store), "--out", f"{store}.json", "--steps",
            str(c["steps"]), "--seed", str(c["seed"]), "--window", str(K),
            "--snapshot-interval", str(c["snapshot_interval"]),
            "--device", device]
    if kill:
        args += ["--sigkill-at-step", str(c["kill_at"]), "--crash-marker",
                 f"{store}.marker"]
    return args


def _wait_all(procs, deadline):
    """Wait for every (name, Popen, start) in `procs`; returns each one's
    (exit code, seconds from its start)."""
    done = {}
    while len(done) < len(procs):
        for name, p, t0 in procs:
            if name not in done and p.poll() is not None:
                done[name] = (p.returncode, time.perf_counter() - t0)
        if time.perf_counter() > deadline:
            raise AssertionError(f"path H2: workers still running: "
                                 f"{[n for n, _, _ in procs if n not in done]}")
        time.sleep(0.02)
    return done


def path_h2(cfg=PATH_H, device="cuda"):
    """H2: the SIGKILL drill.  The uninterrupted runs go through the
    worker's `main` in this process; the killed and restarted incarnations
    are worker processes, K = 1 and 16 side by side, with the supervised
    K = 4 run beside them in a thread.  Returns the ticks run in this
    process."""
    import os
    import subprocess
    import threading

    from repro_torch.serve import Supervisor, SupervisorConfig, worker

    c = cfg["drill"]
    Ks = tuple(c["windows"]) + (c["supervised_K"],)
    want, ticks = {}, 0
    for K in Ks:
        store = H_DIR / f"h2_ref_{K}"
        if worker.main(_worker_args(store, K, c, device)) != 0:
            raise AssertionError(f"path H2 K={K}: the uninterrupted run "
                                 f"broke conservation")
        want[K] = json.loads(Path(f"{store}.json").read_text())
        ticks += want[K]["summary"]["steps"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.serve.worker"]
    sup_out = {}

    def supervised():
        store = H_DIR / f"h2_{c['supervised_K']}"
        try:
            sup_out["report"] = Supervisor(
                base + _worker_args(store, c["supervised_K"], c, device,
                                    kill=True), store / "heartbeat.json",
                SupervisorConfig(heartbeat_timeout=120.0,
                                 startup_timeout=300.0, poll_interval=0.05,
                                 backoff_base=0.05), env=env).run()
        except Exception as e:  # raised again in the main thread
            sup_out["error"] = e

    procs, walls = [], {}
    thread = threading.Thread(target=supervised)
    thread.start()
    deadline = time.perf_counter() + c["timeout"]
    try:
        for phase, rc in (("killed", -9), ("restarted", 0)):
            procs = []
            for K in c["windows"]:
                store = H_DIR / f"h2_{K}"
                with open(f"{store}.{phase}.err", "w") as err:
                    procs.append((K, subprocess.Popen(
                        base + _worker_args(store, K, c, device, kill=True),
                        cwd=str(ROOT), env=env, stdout=subprocess.DEVNULL,
                        stderr=err), time.perf_counter()))
            for K, (code, s) in _wait_all(procs, deadline).items():
                walls[(K, phase)] = s
                if code != rc:
                    tail = Path(f"{H_DIR / f'h2_{K}'}.{phase}.err"
                                ).read_text()[-3000:]
                    raise AssertionError(f"path H2 K={K}: the {phase} "
                                         f"incarnation exited {code}, not "
                                         f"{rc}:\n{tail}")
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        thread.join(timeout=max(deadline - time.perf_counter(), 1.0))
    if thread.is_alive():
        raise AssertionError("path H2: the supervised run did not finish")
    if "error" in sup_out:
        raise sup_out["error"]
    rep = sup_out["report"]
    got = {K: json.loads(Path(f"{H_DIR / f'h2_{K}'}.json").read_text())
           for K in Ks}
    for K in Ks:
        for key in ("completions", "done_step", "outputs_crc", "carry_crc",
                    "conservation"):
            if got[K][key] != want[K][key]:
                raise AssertionError(f"path H2 K={K}: {key} differs from "
                                     f"the uninterrupted run's")
        if got[K]["recover"]["replayed_windows"] < 1:
            raise AssertionError(f"path H2 K={K}: recovery replayed nothing")
    if rep.outcome != "completed" or rep.exit_codes != [-9, 0]:
        raise AssertionError(f"path H2 supervised: {rep.as_dict()}")
    for K in c["windows"]:
        r = got[K]["recover"]
        log(f"[11 path H2] SIGKILL drill K={K}, worker processes on the "
            f"{device} (the scheduler's generator there): killed at step "
            f"{c['kill_at']} with rc -9 after {walls[(K, 'killed')]:.3f}s, "
            f"restarted on the same store with the same command line, rc 0 "
            f"after {walls[(K, 'restarted')]:.3f}s (each incarnation's wall,"
            f" process start included); recover() {r['seconds'] * 1e6:.1f} "
            f"us: snapshot step {r['snapshot_step']}, "
            f"{r['replayed_windows']} windows of {r['wal_records']} log "
            f"records replayed | completions ({len(got[K]['completions'])})"
            f", done steps, outputs CRC {got[K]['outputs_crc']:#010x}, "
            f"carry fingerprint {got[K]['carry_crc']:#010x} and "
            f"conservation equal to the uninterrupted run's")
    r = got[c["supervised_K"]]["recover"]
    log(f"[11 path H2] supervised K={c['supervised_K']}: exit codes "
        f"{rep.exit_codes}, {rep.restarts} restart, {rep.wall_s:.3f}s in "
        f"all; recover() {r['seconds'] * 1e6:.1f} us "
        f"({r['replayed_windows']} windows replayed); all five artifacts "
        f"equal to the uninterrupted run's")
    return ticks


def path_h3(tree, cfg=PATH_H, device="cuda"):
    """H3: recovery time against snapshot cadence (benchmarks/
    durability.py run_mttr): a durable run stopped at the end of its
    arrivals, its final snapshot removed, recovered by a fresh engine,
    which must equal the stopped one.  Returns the ticks run."""
    import shutil

    import torch

    from repro_torch.workloads import traces

    c = cfg["mttr"]
    dev = torch.device(device)
    ticks = 0
    parts = []
    for interval in c["intervals"]:
        root = H_DIR / f"h3_{interval}"

        def engine():
            return _durable_engine(tree, root, dev, c["K"], c["batch_size"],
                                   seed=c["seed"], snapshot_interval=interval)

        e1 = engine()
        e1.run(traces.bursty_serve_workload(steps=c["steps"],
                                            seed=c["seed"]),
               max_steps=c["steps"])
        ticks += e1._step
        shutil.rmtree(root / "snapshots" / f"step_{e1._step}")
        (root / "snapshots" / "LATEST").unlink(missing_ok=True)
        e1.durability.close()
        e2 = engine()
        _sync(dev)
        t0 = time.perf_counter()
        info = e2.recover()
        _sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        ticks += e2._step - (info["snapshot_step"] or 0)
        if _served(e2) != _served(e1) or e2._step != e1._step:
            raise AssertionError(f"path H3 interval {interval}: the "
                                 f"recovered engine differs")
        e2.durability.close()
        parts.append(f"interval {interval}: {us:.1f} us, snapshot step "
                     f"{info['snapshot_step']}, {info['replayed_windows']} "
                     f"windows replayed")
    log(f"[11 path H3] recovery time against snapshot cadence, "
        f"bursty_serve_workload(steps={c['steps']}, seed={c['seed']}), "
        f"K={c['K']}, stopped at step {c['steps']} without its final "
        f"snapshot: " + "; ".join(parts) + " | each recovered engine equal "
        "to the stopped one")
    return ticks


def path_h4(tree, root, want, cfg=PATH_H, device="cuda"):
    """H4: each damage injector on a copy of H1's fsync store; a fresh
    engine recovers to the finished run's completion steps, outputs and
    carry, and counts what it skipped and dropped.  Returns the ticks
    replayed."""
    import shutil

    import torch

    from repro_torch.faults import FaultSpec, inject

    c = cfg["wal"]
    dev = torch.device(device)
    ticks = 0
    parts = []
    for kind, variant in cfg["damage"]:
        copy = H_DIR / f"h4_{kind}_{variant or 'default'}"
        shutil.copytree(root, copy)
        inject(copy, FaultSpec(kind=kind, variant=variant, rate=0.5))
        eng = _durable_engine(tree, copy, dev, c["K"], c["batch_size"],
                              snapshot_interval=c["snapshot_interval"])
        info = eng.recover()
        ticks += eng._step - info["snapshot_step"]
        st = eng.durability.stats
        # a damaged newest snapshot is skipped, counted, and the older one
        # replayed forward; a torn log tail loses its last (commit) record
        skipped = int(kind == "partial_snapshot"
                      or (kind, variant) == ("stale_manifest", "garbage"))
        dropped = int(kind == "torn_wal")
        if _served(eng) != want:
            raise AssertionError(f"path H4 {kind} {variant!r}: recovery "
                                 f"landed elsewhere")
        if (st.snapshots_skipped_invalid, st.torn_records_dropped) != (
                skipped, dropped):
            raise AssertionError(f"path H4 {kind} {variant!r}: "
                                 f"{st.snapshots_skipped_invalid} snapshots "
                                 f"skipped, {st.torn_records_dropped} torn "
                                 f"records dropped")
        eng.durability.close()
        parts.append(f"{kind} {variant or 'default'}: snapshot step "
                     f"{info['snapshot_step']}, {info['replayed_windows']} "
                     f"windows replayed, {st.snapshots_skipped_invalid} "
                     f"skipped, {st.torn_records_dropped} torn records "
                     f"dropped ({st.torn_bytes_dropped} bytes)")
    log("[11 path H4] damaged copies of H1's fsync store, each recovered to "
        "the finished run's completion steps, outputs and carry "
        "fingerprint: " + "; ".join(parts))
    return ticks


def path_h5(tree, cfg=PATH_H, device="cuda"):
    """H5: G2's 2x controlled workload, durable, on injected draws, paused
    at `pause_at` and resumed by a fresh engine, against the same run
    uninterrupted on the card and on the CPU: completion steps, outputs,
    carry, health and mode trace.  The controller must vote MULTIQ.
    Returns the ticks run."""
    import torch

    from repro_torch.workloads import traces

    c = cfg["resume"]
    dev = torch.device(device)
    draws = serve_draws(c["ticks"] + c["K"], 19)

    def engine(name, device):
        return _durable_engine(
            tree, H_DIR / f"h5_{name}", device, c["K"], c["batch_size"],
            seed=c["seed"], snapshot_interval=c["snapshot_interval"],
            draws=draws, slo_targets=c["targets"], backlog_cap=4096)

    def run(eng, max_steps):
        eng.run(traces.open_loop_requests(traces.poisson_arrival_counts(
            512, c["load"] * c["batch_size"] / 8.5, seed=c["seed"]),
            seed=c["seed"]), max_steps=max_steps)
        eng.durability.close()

    def outcome(eng):
        h = eng.health()
        h.pop("durability")
        return _served(eng) + (h, list(eng.scheduler.stats.mode_trace))

    run(engine("paused", dev), c["pause_at"])
    resumed = engine("paused", dev)
    info = resumed.recover()
    run(resumed, c["ticks"])
    whole, cpu = engine("whole", dev), engine("cpu", "cpu")
    run(whole, c["ticks"])
    run(cpu, c["ticks"])
    got = outcome(resumed)
    if got != outcome(whole):
        raise AssertionError("path H5: the resumed run differs from the "
                             "uninterrupted run on the card")
    if got != outcome(cpu):
        raise AssertionError("path H5: the card differs from the CPU")
    modes, h = got[-1], got[3]
    if 1 not in modes:
        raise AssertionError("path H5: the controller never voted MULTIQ")
    log(f"[11 path H5] G2's {c['load']}x controlled workload, durable, "
        f"{c['batch_size']} slots, K={c['K']}, injected draws: paused at "
        f"step {c['pause_at']}, resumed from snapshot step "
        f"{info['snapshot_step']} ({info['replayed_windows']} windows "
        f"replayed) to step {c['ticks']} | {h['completed']} completed, shed "
        f"{h['shed']}, evicted {h['evicted']}, MULTIQ ticks "
        f"{modes.count(1)} | completion steps, outputs, carry fingerprint "
        f"{got[2]:#010x}, health and mode trace equal to the uninterrupted "
        f"run on the card and on the CPU")
    return 2 * c["ticks"]


def path_h(tree):
    """Phase 11: H1-H5 on the card.  The path's launch counts are those of
    its engine runs and recoveries in this process (H2's worker processes
    count in their own), per tick over their ticks."""
    import shutil

    from repro_torch.kernels import ops as KO

    shutil.rmtree(H_DIR, ignore_errors=True)
    H_DIR.mkdir(parents=True)
    counts_reset()
    root, eng, ticks = path_h1(tree)
    want = _served(eng)
    ticks += path_h2()
    ticks += path_h3(tree)
    ticks += path_h4(tree, root, want)
    ticks += path_h5(tree)
    WINDOW_LAUNCHES.update(KO.LAUNCHES)
    _, in_runs = counts_read("H")
    return {k: in_runs.get(k, 0) for k in KO.LAUNCHES}, in_runs, ticks


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
    path_e_counts, tree = path_e()
    path_f_counts = path_f(tree=tree)
    path_g_counts = path_g(tree)
    t0 = time.perf_counter()
    path_h_counts = path_h(tree)
    log(f"[11 path H] {time.perf_counter() - t0:.1f}s")
    log(f"[12 done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps(kernels_line(records, {
        "A": path_a_counts, "B": path_b_counts, "C": path_c_counts,
        "D": path_d_counts, "E": path_e_counts, "F": path_f_counts,
        "G": path_g_counts, "H": path_h_counts}, phase2, floor)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
