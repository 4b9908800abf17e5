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
              version and one library call computing the same function: per
              call as the host issues them (CUDA events), and on the card
              alone (CUDA events around a replayed CUDA graph of the calls);
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
  6. the total time; then the kernels JSON line, the card line, and the
     result line.

Each path sets the kernels' launch counts to 0 just before it runs and reads
them just after its timed windows; a kernel that path never launched fails
the run.  The profiler traces go to build/chip_smoke/.  The
script imports nothing of JAX and nothing of the JAX package `repro`.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Time per call as the host issues it: CUDA events around `iters`
    back-to-back calls.  Where the host issues calls more slowly than the
    card runs them, this is the host's rate, not the card's."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call: `iters` calls captured in one CUDA graph and
    replayed `replays` times between CUDA events, so the host's cost of
    issuing each call (Python, the wrapper, the launch) drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


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
]
ELIM_SHAPES = [
    ((1, 16), "validation"), ((4, 64), "validation"),
    ((6, 37), "validation"), ((8, 128), "validation"),
    ((64, 64), "main: window op log"),
]
MERGE_SHAPES = [
    ((4, 64, 16), "validation"), ((2, 256, 7), "validation"),
    ((6, 100, 60), "validation"), ((3, 8, 8), "validation"),
    ((16, 256, 64), "main: step insert"),
    ((16, 256, 4096), "main: prefill insert"),
]
MAIN_SHAPE = {"topk_smallest": (1, 1424, 64), "elim_sort": (64, 64),
              "windowed_merge": (16, 256, 64)}
REPLACES = {
    "windowed_merge": "src/repro/kernels/windowed_merge.py:52",
    "topk_smallest": "src/repro/kernels/bitonic_topk.py:128",
    "elim_sort": "src/repro/kernels/elim_match.py:42",
}


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


def check_kernels(seed: int = 0):
    """Hold each kernel against its plain version at every shape; return
    the per-kernel records of the kernels JSON line (launches filled in
    later from the main path's run)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as KO
    from repro_torch.kernels import ref as KR

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    records = {}

    def run_case(name, shape, label, args, kernel, plain, library, nbytes,
                 ops):
        got = kernel(*args)
        want = plain(*args)
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
        l_ms = cuda_ms(lambda: library(*args))
        kd_ms = graph_ms(lambda: kernel(*args))
        pd_ms = graph_ms(lambda: plain(*args))
        ld_ms = graph_ms(lambda: library(*args))
        b_ms, b_by = _bound(nbytes, ops)
        rec = {"shape": list(shape), "label": label, "match": match,
               "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
               "library_ms": l_ms, "device_ms": kd_ms,
               "plain_device_ms": pd_ms, "library_device_ms": ld_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        records.setdefault(name, []).append(rec)
        log(f"  {name} {shape} [{label}] match={match} per call: kernel="
            f"{k_ms*1e3:.2f}us plain={p_ms*1e3:.2f}us library={l_ms*1e3:.2f}us"
            f" | device (graph): kernel={kd_ms*1e3:.2f}us plain="
            f"{pd_ms*1e3:.2f}us library={ld_ms*1e3:.2f}us | bound="
            f"{b_ms*1e3:.3f}us ({b_by})")
        if not match:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")

    for (R, N, k), label in TOPK_SHAPES:
        keys = rng.integers(0, 1 << 20, (R, N)).astype(np.int32)
        if label.startswith("main"):
            keys[rng.random((R, N)) < 0.5] = INF_KEY
        vals = np.tile(np.arange(N, dtype=np.int32), (R, 1))
        args = (t(keys), t(vals), k)
        run_case(
            "topk_smallest", (R, N, k), label, args, KO.topk_smallest,
            KR.topk_smallest_ref,
            lambda a, b, kk: torch.topk(KR.lex_pack(a, b), kk, dim=1,
                                        largest=False, sorted=True),
            4 * (2 * R * N + 2 * R * min(k, N)),
            R * N * (_log2(k) + 1),
        )
    for (R, B), label in ELIM_SHAPES:
        keys = rng.integers(0, 64, (R, B)).astype(np.int32)
        keys[rng.random((R, B)) < 0.3] = INF_KEY
        tags = np.tile(np.arange(B, dtype=np.int32), (R, 1))
        lg = _log2(B)
        run_case(
            "elim_sort", (R, B), label, (t(keys), t(tags)), KO.elim_sort,
            KR.elim_sort_ref,
            lambda a, b: torch.sort(KR.lex_pack(a, b), dim=1, stable=True),
            4 * 4 * R * B, R * (B / 2) * lg * (lg + 1) / 2,
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

        def library(hk, hv, hq, rk, rv, rq, _tags=tags):
            cat = torch.cat([hk, rk], dim=1)
            return torch.sort(KR.lex_pack(cat, _tags), dim=1, stable=True)

        run_case(
            "windowed_merge", (S, H, Rw), label, args, KO.windowed_merge,
            KR.windowed_merge_ref, library,
            4 * (3 * S * W + 3 * S * W), S * (W / 2) * _log2(W),
        )
    return records


# ---------------------------------------------------------------------------
# phases 3-5: the port's main path
# ---------------------------------------------------------------------------

TWO_MODE = ("SPRAY_HERLIHY", "SPRAY_HERLIHY", "HIER")

# Path A: the fig9 ins0 latency slice (benchmarks/window_amortization.py:35-39)
PATH_A = dict(S=16, C=1 << 14, B=64, K=64, prefill=4096, key_range=8192,
              ins_frac=0.0, windows=8)
# Path B: the fig9 size_1048576 ins50 queue (benchmarks/fig9_grid.py:30-37)
PATH_B = dict(S=16, C=1 << 17, B=64, K=64, prefill=1 << 20,
              key_range=1 << 21, ins_frac=0.5, windows=4)
PREFILL_BATCH = 4096
# Kernel launches inside `run_window` calls only (prefills excluded), per
# kernel, summed over the path that is running; reset with the counts.
WINDOW_LAUNCHES: dict = {}


def make_pq(cfg, device, tree=None):
    from repro_torch.core.pqueue.schedules import Schedule
    from repro_torch.core.smartpq import SmartPQ, SmartPQConfig

    return SmartPQ(SmartPQConfig(
        num_shards=cfg["S"], capacity=cfg["C"], npods=2, decision_interval=2,
        mode_schedules=tuple(Schedule[s] for s in TWO_MODE), eliminate=True,
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
    """One window's (ops, keys, vals) from numpy and its spray draws from a
    CPU generator, so a CPU rerun can take the very same inputs."""
    import numpy as np
    import torch

    from repro_torch.core.pqueue import schedules as SCH

    K, B = cfg["K"], cfg["B"]
    ops = (rng.random((K, B)) > cfg["ins_frac"]).astype(np.int32)
    keys = rng.integers(0, cfg["key_range"], (K, B)).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (K, B)).astype(np.int32)
    H = min(256, cfg["C"])
    draws = SCH.spray_draws(cfg["S"], B, H, steps=K, generator=draw_gen,
                            device="cpu")
    return (torch.as_tensor(ops), torch.as_tensor(keys),
            torch.as_tensor(vals), draws)


def run_checked(pq, carry, window, device, expect_size,
                around=contextlib.nullcontext()):
    """Run one window inside the context `around` (a profiler, say) and
    check it: invariants, key conservation (no drops), well-formed outputs.
    Returns (carry, result, seconds, host syncs, size after); adds the
    window's own kernel launches to WINDOW_LAUNCHES."""
    import torch

    from repro_torch.core.pqueue.ops import OP_INSERT
    from repro_torch.core.pqueue.state import invariant_violations
    from repro_torch.kernels import ops as KO
    from repro_torch.utils import hostsync

    ops, keys, vals, (sc, hi) = window
    dev_args = [t.to(device) for t in (ops, keys, vals)]
    draws = (sc.to(device), hi.to(device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    syncs = hostsync.SYNCS["count"]
    launches = dict(KO.LAUNCHES)
    with around:
        t0 = time.perf_counter()
        carry, res = pq.run_window(carry, *dev_args, draws=draws,
                                   num_clients=ops.shape[1])
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


def device_share(pq, carry, window, device, expect_size, window_s, tag):
    """Run one more window under torch.profiler and sum the card's busy time
    in its trace (kernels, copies, sets); against the median unprofiled
    window time `window_s` that gives the card's busy share.  Returns
    (busy ms or None when the trace holds no device work, share or None,
    device calls in the window, the five busiest device functions as
    (name, calls, ms))."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    run_checked(pq, carry, window, device, expect_size, around=prof)
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
    return busy_ms, busy_ms / (window_s * 1e3), sum(
        c for c, _ in busy.values()), [
        (name[:80], calls, us / 1e3) for name, (calls, us) in top]


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
    from repro_torch.kernels import ops as KO

    launches = dict(KO.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"path {path}: kernels {missing} never "
                             f"launched on the main path")
    return launches, dict(WINDOW_LAUNCHES)


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
            kept.append((carry_to_numpy(carry),
                         [x.cpu().numpy() for x in res]))
    launches, in_windows = counts_read("A")
    steps = cfg["windows"] * cfg["K"]
    us_op = [t * 1e6 / (cfg["K"] * cfg["B"]) for t in times]
    share = device_share(pq, prefill(pq, cfg, seed, dev), windows[0], dev,
                         cfg["prefill"], float(np.median(times)), "A")
    log(f"[3 path A] S={cfg['S']} C={cfg['C']} B={cfg['B']} K={cfg['K']} "
        f"ins0, {cfg['windows']} windows from fresh 4096-key carries: "
        f"us/op median {float(np.median(us_op)):.3f} (all {us_op}) | modes "
        f"seen {sorted(modes)} | transitions {transitions} | host syncs "
        f"{syncs / steps:.2f}/step | launches {launches} (inside the windows "
        f"{in_windows}) | invariants ok, keys conserved")
    log(f"[3 path A profile] {share_line(*share)}")
    return (launches, in_windows, cfg["windows"]), (pq, windows[:2], kept)


def cpu_agreement(pq_gpu, windows, kept, seed: int = 0):
    """Phase 4: windows 0-1 of path A on the CPU (plain versions), same
    tree, same inputs and draws: carry and outputs bit-identical."""
    import numpy as np
    import torch

    from repro_torch.convert import carry_to_numpy

    cfg, dev = PATH_A, torch.device("cpu")
    pq = make_pq(cfg, dev, tree=pq_gpu.tree)
    for w, (window, (want_carry, want_res)) in enumerate(zip(windows, kept)):
        carry = prefill(pq, cfg, seed, dev)
        carry, res, *_ = run_checked(pq, carry, window, dev, cfg["prefill"])
        got_state, got_stats = carry_to_numpy(carry)
        for name, got, want in (
                [(f, got_state[f], want_carry[0][f]) for f in got_state]
                + [(f, got_stats[f], want_carry[1][f]) for f in got_stats]
                + [(f, x.numpy(), y) for f, x, y in
                   zip(res._fields, res, want_res)]):
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"window {w}: {name} differs between "
                                     f"the card and the CPU")
    log(f"[4 cpu] path A windows 0-{len(kept) - 1} rerun on the CPU with the "
        f"plain versions: carry and outputs bit-identical to the card")


def path_b(seed: int = 0):
    """Phase 5: the 1M-key queue, 4 windows in a row on one carry."""
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
    share = device_share(pq, carry, windows[-1], dev, size,
                         float(np.median(times)), "B")
    log(f"[5 path B] S={cfg['S']} C={cfg['C']}/shard prefill "
        f"{cfg['prefill']} keys in {prefill_s:.2f}s | ins50 B={cfg['B']} "
        f"K={cfg['K']}, {cfg['windows']} windows on one carry: us/op median "
        f"{float(np.median(us_op)):.3f} (all {us_op}) | modes seen "
        f"{sorted(modes)} | transitions {int(carry.stats.transitions)} | "
        f"host syncs {syncs / steps:.2f}/step | size {size} | max memory "
        f"allocated {max_mib:.1f} MiB | "
        f"launches {launches} (inside the windows {in_windows}) | invariants "
        f"ok, keys conserved")
    log(f"[5 path B profile] {share_line(*share)}")
    return launches, in_windows, cfg["windows"]


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def kernels_line(records, paths):
    """`paths` maps a path's name to (launches, launches inside its
    windows, windows)."""
    from repro_torch.kernels import build

    out = []
    for name in build.SOURCES:
        main = [r for r in records[name]
                if tuple(r["shape"]) == MAIN_SHAPE[name]][0]
        out.append({
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
            "shape": main["shape"],
            "shapes": records[name],
        })
    return {"kernels": out}


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
    records = check_kernels()
    path_a_counts, (pq_a, windows_a, kept_a) = path_a()
    cpu_agreement(pq_a, windows_a, kept_a)
    path_b_counts = path_b()
    log(f"[6 done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps(kernels_line(records, {"A": path_a_counts,
                                            "B": path_b_counts})))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
