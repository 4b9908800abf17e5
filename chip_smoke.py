#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the script exits
non-zero before its last line):

  1. device   the card's name and power limit, torch and CUDA versions, and
              the time to build the CUDA kernels from `src/repro_torch/kernels/csrc`;
  2. kernels  each kernel against its plain PyTorch version on the card,
              bit-exact (`decode_attend`, which replaces no Pallas kernel,
              within `kernels.ops.DECODE_TOL` of `attend_chunked`'s plain
              arm), at the kernel's validation shapes and at the shapes
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
  12. path I  the distributed PQ and Nuddle (`core/pqueue/dist.py`,
              `core/nuddle.py`, `distributed/`) on path B's queue (16 shards
              x 2^17 slots, 1,048,576 keys, 64 inserts a step, m = 64): I1
              one rank on a (1, 1) (pod, shard) mesh over NCCL, 4 steps of
              `insert_dist` and each of the five `DIST_SCHEDULE_FNS` on one
              carry, every leaf and output equal to the single-controller
              run with the same draws; I2 eight rank processes on the card
              over gloo with host-staged payloads (NCCL refuses two ranks on
              one GPU), a (2, 4) mesh with 2 shards a rank: flat == hier ==
              ffwd on every leaf and equal to the single controller's
              STRICT_FLAT, MULTIQ and spray conserving keys with no
              collective, `delegate_dist` equal to
              `delegate_single_controller`, the pod-aware collectives (tests/
              device_scripts/{dist_pq_check,multiq_8dev,collectives_check}
              .py), then which collectives gloo takes on CUDA tensors as
              they are; I3 Nuddle's `delegate_single_controller` and a K = 8
              `delegate_window` on I1's final state, card against CPU;
  13. path J  the dense model path at full width (`models/`, `ServeEngine`
              with a model): llama3.2-3b (28 layers, d 3072, 24 heads, 8 KV
              heads, d_ff 8192, vocab 128256) in bf16 from a seeded
              generator on the card: J1 the build (parameters, bytes, init
              time, peak memory); J2 4 prompts of 32 tokens, `prefill`
              against 32 teacher-forced `decode_step`s from empty caches
              (logits and caches) and `train_logits` at the last position,
              within `J2_ULPS`; J3 launch/serve.py's workload (24 requests
              in bursts of 6) on `EngineConfig(batch_size=8, max_seq=512)`
              at K = 1 and 4: every request completed, `health()`'s
              identities after every window, ms a tick, µs a token,
              tokens/s, syncs a tick, a decode step host-issued and on the
              device (a replayed CUDA graph) against its bound, its device
              µs by layer (embedding, attention decode, MLP, unembedding)
              from a profiled step, the busy share of ticks 4-20 and the
              scheduler kernels' launches; J4 reduced llama3.2-3b and
              gemma-2b from one numpy tree on the card and on the CPU, f32
              (TF32 off) then bf16, within the CPU tests' tolerances, and
              their engine runs (EOS off) with the same admissions and
              completion steps (and tokens, in f32);
  14. path K  the MoE and SSM families at full width and the hybrid reduced
              (`models/layers/moe.py`, `models/layers/ssm.py`): K1
              granite-moe-3b-a800m (32 layers, d 1536, 40 experts, top 8)
              in bf16 on the card: the build, one layer's
              `moe_block` on the card against the CPU (f32, TF32 off) at 8
              tokens (cap 2) and 128 (cap 32) with the same routing and
              kept assignments and the dropped share, and J3's engine runs
              and readings (the decode step's bound beside the 40 real
              experts' bound, its device µs by layer: attention decode, MoE
              router, dispatch, expert products and combine, unembedding,
              and the share of its assignments dropped); K2 mamba2-780m (48
              SSD layers, d 1536, state 128): the build, `prefill` of 4
              prompts of 256 tokens (one chunk) against 256 teacher-forced
              `decode_step`s from zero states (logits, `ssm_h`,
              `ssm_conv`) within `K2_ULPS`, and the engine runs (bound: the
              weights and the f32 states read and written); K3 reduced
              granite-moe-1b-a400m, mamba2-780m and jamba-1.5-large-398b
              as J4;
  15. path L  the enc-dec and VLM families at full width (`Model`'s
              encoder, cross-attention, decoder and VLM stacks): L1
              whisper-base (6 encoder and 6 decoder layers, d 512, vocab
              51865), L2 llama-3.2-vision-11b (40 layers, 8 gated
              cross-attention layers, d 4096, 32 heads over 8 K/V heads,
              vocab 128256), bf16, norms, biases and gates redrawn nonzero
              from the seed: each the build, `prefill` of 4 prompts of 32
              tokens with 1500 encoder frames or 1024 image tokens against
              32 teacher-forced `decode_step`s from the prefill's `xk`/`xv`
              and `train_logits` within `J2_ULPS`, zeros for the context
              moving the logits by more than that, and J3's engine runs
              and readings (bound: the weights a step reads, the valid K/V
              prefix and `xk`/`xv`; device µs by range: self-attention
              decode, cross-attention, MLP, unembedding); L4 the reduced
              models as J4, with a context;
  16. path M  the int8 KV cache and training: M1 llama3.2-3b decoding on
              int8 and bf16 caches, M2 llama3.2-3b trained at full width
              (f32 masters, bf16 compute, remat, int8 first moments), M3
              the reduced models' gradients, AdamW, the checkpoint drill
              and int8 decode card against CPU;
  17. path N  the sharding slice (ZeRO-3 + tensor parallel over a `Mesh`),
              every rank a process on the one card over gloo with
              host-staged payloads: N1 llama3.2-3b served at full width
              on a (data=1, model=4) mesh (`tp_only_params`) on the
              launcher's workload at 8 slots, max_seq 512, every rank's
              dispatch stream equal to the one-rank engine's, the decode
              logits within `N1_ULPS` bf16 ulps of the one-rank engine's on
              the same parameters (carried across with
              `elastic.reshard_state`) while the greedy tokens agree, the
              agreeing tokens counted; ms a tick, the decode step's ms,
              collectives a step by (kind, axes); N2 llama3.2-3b trained
              at full width on a (data=2, model=2) mesh (ZeRO-3 + TP, M2's
              task): the first loss within 1e-3 relative and the global
              gradient norm within 1e-2 of the one-rank step's, losses
              finite and falling, ms a step, peak allocated per rank,
              collective bytes a step; N3 reduced models of the six
              families on a (2, 2) mesh on the card against the same ranks
              on the CPU (`train_logits`, one train step, one decode step)
              and the (2, 2) checkpoint restored on one rank bit-equal to
              the gathered live state;
  18. path O  the four examples (`repro_torch.examples`) at their own sizes
              on the card, each logging its summary and OK line: O1
              quickstart and O2 sssp rerun on the CPU with the same draws,
              carry, distances and results bit-identical; O3 serve_demo
              as the example runs it (bf16), in f32 on the card and on the
              CPU with the same parameters and draws (mode trace,
              completion steps and tokens equal) and its bf16 logits card
              against CPU within `J4_BF16_ULPS`; O4 train_demo (`CFG_100M`,
              200 steps at batch 8, restarted from its checkpoint at step
              100, losses falling);
  19. path P  the dry run (`launch/dryrun.py`) on fake CUDA tensors over the
              abstract (16, 16) production mesh: gemma-2b decode_32k
              (serve_tp_only), llama3.2-3b train_4k and mamba2-780m
              long_500k, each record equal to the same cell's on the CPU
              but for the device fields, the fit judged against the card's
              memory, no kernel launched;
  20. the total time; then the kernels JSON line, the card line, and the
     result line.

Each path sets the kernels' launch counts to 0 just before it runs and reads
them just after its timed windows; a kernel that the path's windows must
launch (`PATH_KERNELS`) and that no `run_window` call of the path launched
fails the run (prefill launches do not count towards this).  On paths E and
F a driver's step counts as a window of one step, and a replay's steps
count alike; on paths G and H an engine tick does (path H counts its
engine runs and recoveries in this process, not its worker processes); on
path I a distributed step or a delegation round does, and its launches are
those of this process's distributed calls and delegations plus those of
I2's eight rank processes, each counted from 0 just before its steps; on
path J an engine tick does, and its launches are those of J3's engine
runs (the model's self-attention decode launches `decode_attend` once a
layer a step); on paths K and L likewise, K1's and K2's (L1's and L2's)
engine runs each counted from 0 just before it; on path N an engine tick
does, and its launches are those of N1's four rank processes' sharded
engine runs, each counted from 0 just before it (N2 and N3 launch no hand
kernel); on path O an example's step
or engine tick does, and its launches are all of its card runs' (the CPU
reruns and train_demo launch none); path P launches nothing.
`merge_sorted` has no caller
on any path; phase 2 alone launches it.  The profiler traces go to
build/chip_smoke/, path H's stores to build/chip_smoke/durable/.  The
script imports nothing of JAX and nothing of the JAX package `repro`.
Without a CUDA device, or without the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
    ((1, 64, 64), "validation; main: path I1 HIER pod select"),
    ((5, 1024, 128), "validation"),
    ((1, 1424, 64), "main: SPRAY tournament; path I1 spray"),
    ((2, 512, 64), "main: HIER pod semifinal"),
    ((1, 128, 64), "main: HIER final; path I2 local candidates, FFWD "
                   "merges, delegate_dist; path I3 combines"),
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
                    "fallback; path I1 local candidates"),
    ((1, 512, 64), "registry tuning shape"),
    ((1, 256, 64), "main: path I2 HIER pod select (4 ranks x m = 64)"),
    ((1, 24, 8), "main: path I2 rank spray (S_loc = 2, m_loc = 8)"),
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
    ((16, 256, 64), "main: step insert; path G tick insert; path I1 "
                    "insert_dist"),
    ((16, 256, 57), "main: path C Fig. 11 step insert"),
    ((16, 256, 22), "main: path C Fig. 10 c_mix step insert"),
    ((16, 256, 4096), "main: prefill insert"),
    ((16, 256, 256), "main: path E fixed relax insert"),
    ((16, 256, 144), "main: path E adaptive step insert"),
    ((16, 256, 1), "main: path E source insert"),
    ((16, 256, 128), "main: path F step insert"),
    ((16, 256, 32512), "main: path F, path I1 prefill slice"),
    ((16, 256, 8192), "main: path F, path I1 prefill last slice"),
    ((2, 256, 64), "main: path I2 rank insert_dist"),
    ((2, 256, 32512), "main: path I2 rank prefill slice"),
]
# (S, m): validation shapes (src/repro/kernels/registry.py:516-533), then
# the MULTIQ steps of the paths
TWOCHOICE_SHAPES = [
    ((4, 16), "validation"), ((16, 64), "validation; main: paths D, G, I1"),
    ((8, 5), "validation"), ((16, 57), "main: path C Fig. 11 trace"),
    ((16, 22), "main: path C Fig. 10 c_mix trace"),
    ((16, 128), "main: path F MULTIQ step"),
    ((16, 144), "main: path E adaptive MULTIQ step"),
    ((2, 8), "main: path I2 rank MULTIQ (S_loc = 2, m_loc = 8)"),
]
MULTIQ_SHAPES = [
    ((4, 16), "validation"), ((16, 64), "validation; main: paths D, G, I1"),
    ((2, 8), "validation; main: path I2 rank MULTIQ"),
    ((16, 57), "main: path C Fig. 11 trace"),
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
# (B, S, Hq, Hkv, hd), bf16: the benchmark cell g8b-decode-4k's layer call
# (granite-8b, 64 slots of 4,096 positions) with contexts drawn as its
# backlog's (geometric, mean about 56, one row of 405), whole rows and one
# position a row; then path J's llama3.2-3b layer call (8 slots of 512).
DECODE_CONTEXTS = "main: g8b-decode-4k contexts"
DECODE_SHAPES = [
    ((64, 4096, 32, 8, 128), DECODE_CONTEXTS),
    ((64, 4096, 32, 8, 128), "whole rows"),
    ((64, 4096, 32, 8, 128), "one position a row"),
    ((8, 512, 24, 8, 128), "path J's layer call, lengths drawn in [1, 512]"),
]
MAIN_SHAPE = {"topk_smallest": (1, 1424, 64), "elim_sort": (64, 64),
              "windowed_merge": (16, 256, 64), "twochoice_pick": (16, 57),
              "multiq_select": (16, 57), "merge_sorted": (8, 1024, 128),
              "decode_attend": (64, 4096, 32, 8, 128)}
REPLACES = {
    "windowed_merge": "src/repro/kernels/windowed_merge.py:52",
    "topk_smallest": "src/repro/kernels/bitonic_topk.py:128",
    "elim_sort": "src/repro/kernels/elim_match.py:42",
    "twochoice_pick": "src/repro/kernels/twochoice.py:67",
    "multiq_select": "src/repro/kernels/twochoice.py:122",
    "merge_sorted": "src/repro/kernels/sorted_merge.py:50",
    "decode_attend": "none",  # the reference's attention is plain jnp
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
        yardstick that also timed the packing.  Integer outputs must be
        bit-exact, floating ones within `KO.DECODE_TOL` of their dtype."""
        got = kernel(*args)
        want = plain(*args)
        got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
        torch.cuda.synchronize()
        err, match = 0, True
        for g, w in zip(got, want):
            if g.shape != w.shape:
                raise AssertionError(
                    f"{name} {shape}: kernel shape {tuple(g.shape)} != "
                    f"plain {tuple(w.shape)}")
            if not g.numel():
                continue
            if g.is_floating_point():
                err = max(err, float((g.float() - w.float()).abs().max()))
                match = match and torch.allclose(
                    g.float(), w.float(), **KO.DECODE_TOL[g.dtype])
            else:
                err = max(err, int((g.long() - w.long()).abs().max()))
                match = match and err == 0
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
    from repro_torch.models.layers.attention import (AttnDims, _rounded_scale,
                                                     attend_chunked)

    gen = torch.Generator(device=dev).manual_seed(seed)
    for (B, S, Hq, Hkv, hd), label in DECODE_SHAPES:
        if label == DECODE_CONTEXTS:
            lens = np.minimum(1 + rng.geometric(1 / 55, B), S)
            lens[0] = min(405, S)
        elif label == "whole rows":
            lens = np.full(B, S)
        elif label == "one position a row":
            lens = np.ones(B, np.int64)
        else:
            lens = rng.integers(1, S + 1, B)
        kv_len = t(lens.astype(np.int32))
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((B, 1, Hq, hd), (B, S, Hkv, hd),
                                          (B, S, Hkv, hd)))
        dims = AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)

        def plain(q, k, v, kv_len, scale, dims=dims, pos=pos):
            """`attend_chunked`'s plain arm: the mask as `kv_valid`."""
            return attend_chunked(q, k, v, dims, (kv_len - 1)[:, None], pos,
                                  kv_valid=pos < kv_len[:, None])

        # bytes: the valid prefix's K and V, q and the output (bf16)
        run_case(
            "decode_attend", (B, S, Hq, Hkv, hd), label,
            (q, k, v, kv_len, _rounded_scale(dims, q.dtype)),
            KO.decode_attend, plain, None,
            2 * (2 * int(lens.sum()) * Hkv * hd + 2 * B * Hq * hd) + 4 * B,
            4.0 * int(lens.sum()) * Hq * hd,
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
    "I": ("windowed_merge", "topk_smallest", "twochoice_pick",
          "multiq_select"),
    "J": ("windowed_merge", "topk_smallest", "elim_sort", "decode_attend"),
    # K1 (MoE) must launch decode_attend too, K2 (SSM) has no attention
    "K": ("windowed_merge", "topk_smallest", "elim_sort"),
    "L": ("windowed_merge", "topk_smallest", "elim_sort", "decode_attend"),
    "M": (),  # training has no hand kernel
    "N": ("topk_smallest", "elim_sort"),  # N1's ticks merge no head
    "O": ("windowed_merge", "topk_smallest", "elim_sort", "twochoice_pick",
          "multiq_select"),
    "P": (),  # the dry run's tensors are fake: it launches nothing
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


def counts_read(path: str, also=()):
    """The launch counts since `counts_reset`, in all and inside the
    windows; fails when a kernel `path`'s windows must launch
    (`PATH_KERNELS`, and `also` for this run) was never launched inside
    them."""
    from repro_torch.kernels import ops as KO

    in_windows = dict(WINDOW_LAUNCHES)
    missing = [k for k in PATH_KERNELS[path] + tuple(also)
               if in_windows.get(k, 0) == 0]
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


def _same_arrays(what, got, want, between="between the card and the CPU"):
    """Bit-equality of two arrays or tensors (on any device)."""
    import numpy as np

    got, want = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                 for x in (got, want))
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{what} differs {between}")


def _same_carry(what, got, want, between="between the card and the CPU"):
    """`got` and `want` are carries as `convert.carry_to_numpy` gives them
    (or any sequences of field-name dicts, as `state_to_numpy` gives)."""
    for g, w in zip(got, want):
        for f in g:
            _same_arrays(f"{what}: carry field {f}", g[f], w[f], between)


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
# phase 12: path I, the distributed PQ and Nuddle
# ---------------------------------------------------------------------------

# Path I: path B's queue (benchmarks/fig9_grid.py:30-37) as a distributed
# queue: 16 shards of 2^17 slots, 1,048,576 keys placed by hash, 64 inserts
# a step (8 a rank on the (2, 4) mesh), exact deletes of m = 64, spray and
# MULTIQ at m_loc = 64 on one rank and 8 a rank on eight
PATH_I = dict(S=16, C=1 << 17, prefill=1 << 20, key_range=1 << 21, steps=4,
              mesh=(2, 4), B_loc=8, m=64, active=(64, 48, 64, 17), m_loc=8,
              active_loc=(8, 8, 5, 8), capacity_factor=8.0, seed=0,
              rounds=8, nuddle_n=48, spawn_timeout=600)
SCHEDULES = ("flat", "hier", "ffwd", "spray", "multiq")


def _dist_fns():
    from repro_torch.core.pqueue import dist as D

    return dict(zip(SCHEDULES, (D.delete_flat_dist, D.delete_hier_dist,
                                D.delete_ffwd_dist, D.delete_spray_dist,
                                D.delete_multiq_dist)))


def _i_keys(cfg):
    """The prefill's keys and values, and each step's inserts (steps,
    ranks, B_loc): the same numbers in every process."""
    import numpy as np

    rng = np.random.default_rng(cfg["seed"])
    n_dev = cfg["mesh"][0] * cfg["mesh"][1]
    shape = (cfg["steps"], n_dev, cfg["B_loc"])
    return (rng.integers(0, cfg["key_range"], cfg["prefill"]).astype(np.int32),
            rng.integers(0, 1 << 20, cfg["prefill"]).astype(np.int32),
            rng.integers(0, cfg["key_range"], shape).astype(np.int32),
            rng.integers(0, 1 << 20, shape).astype(np.int32))


def _run_counted(device, fn, *args, **kw):
    """(fn's result, seconds); the kernel launches go to WINDOW_LAUNCHES."""
    from repro_torch.kernels import ops as KO

    before = dict(KO.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(device)
    dt = time.perf_counter() - t0
    for name, n in KO.LAUNCHES.items():
        WINDOW_LAUNCHES[name] = WINDOW_LAUNCHES.get(name, 0) + n - before[name]
    return out, dt


def _same_result(what, got, want, between="from the single controller's",
                 names=("keys", "vals", "n")):
    """A (state, *outputs) result of a `*_dist` call, bit-equal on every
    state leaf and output to `want`'s."""
    from repro_torch.convert import state_to_numpy

    _same_carry(what, [state_to_numpy(got[0])], [state_to_numpy(want[0])],
                between)
    for name, g, w in zip(names, got[1:], want[1:]):
        _same_arrays(f"{what}: {name}", g, w, between)


def _multiset(state):
    import numpy as np

    k = state.keys.cpu().numpy()
    return np.sort(k[k < INF_KEY])


def _twin_draws(gen, name, state, m):
    """The draws the rank's generator `gen` is about to make for the spray
    or MULTIQ schedule `name`, drawn from a copy of it."""
    import torch

    from repro_torch.core.pqueue import schedules as SCH

    twin = torch.Generator(device=state.device)
    twin.set_state(gen.get_state())
    return SCH.schedule_draws(
        SCH.Schedule.SPRAY_HERLIHY if name == "spray" else SCH.Schedule.MULTIQ,
        None, state.num_shards, m, state.head_width, generator=twin,
        device=state.device)


def path_i1(cfg=PATH_I, device="cuda"):
    """I1: one rank on a (1, 1) (pod, shard) mesh with NCCL (gloo on the
    CPU), S_loc = 16: 4 steps of `insert_dist` and each of the five
    DIST_SCHEDULE_FNS, all on one carry, every state leaf and output equal
    to the single-controller run (`ops.insert`; `delete_min(STRICT_FLAT)`
    for the exact schedules, `delete_spray_herlihy` and `delete_multiq` at
    npods=1 with the same draws).  Returns the initial and final states
    and the prefill's kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core.pqueue import ops as O
    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.core.pqueue.dist import (AxisCfg, insert_dist,
                                              rank_generator)
    from repro_torch.core.pqueue.state import make_state
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import ops as KO
    from repro_torch.workloads import traces as TR

    dev = torch.device(device)
    keys, vals, step_k, step_v = _i_keys(cfg)
    before = dict(KO.LAUNCHES)
    t0 = time.perf_counter()
    st0 = TR.prefill(make_state(cfg["S"], cfg["C"], device=dev), keys, vals)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: n - before[k] for k, n in KO.LAUNCHES.items()}
    m, fns = cfg["m"], _dist_fns()
    sc = {"flat": lambda st, a, d: O.delete_min(st, m, SCH.Schedule.STRICT_FLAT,
                                                active=a),
          "spray": lambda st, a, d: SCH.delete_spray_herlihy(st, m, a, d, 1),
          "multiq": lambda st, a, d: SCH.delete_multiq(st, m, a, d, 1)}
    sc["hier"] = sc["ffwd"] = sc["flat"]
    times = {name: [] for name in ("insert",) + SCHEDULES}
    counts, before = {}, dict(WINDOW_LAUNCHES)
    with make_mesh((1, 1), ("pod", "shard"), device=dev) as mesh:
        acfg = AxisCfg(("shard",), "pod", mesh=mesh)
        _warm_up(st0, step_k[0].reshape(-1), step_v[0].reshape(-1), cfg, acfg,
                 m, cfg["active"][0])
        gen = rank_generator(cfg["seed"], acfg)
        st_d = st_s = st0
        for t in range(cfg["steps"]):
            k = torch.as_tensor(step_k[t].reshape(-1), device=dev)
            v = torch.as_tensor(step_v[t].reshape(-1), device=dev)
            mask = torch.ones_like(k, dtype=torch.bool)
            mesh.reset_counts()
            (st_d, dropped, rejected), dt = _run_counted(
                dev, insert_dist, st_d, k, v, mask, acfg,
                cfg["capacity_factor"])
            counts["insert"] = dict(mesh.counts)
            times["insert"].append(dt)
            st_s, dropped_s = O.insert(st_s, k, v, mask=mask)
            if bool(rejected.any()):
                raise AssertionError("path I1: insert_dist rejected lanes")
            _same_result(f"path I1 step {t} insert_dist",
                         (st_d, dropped), (st_s, dropped_s),
                         names=("dropped",))
            active = torch.tensor(cfg["active"][t], dtype=torch.int32,
                                  device=dev)
            for name in SCHEDULES:
                # the single controller takes the draws the rank's
                # generator is about to make
                draws = (_twin_draws(gen, name, st_s, m)
                         if name in ("spray", "multiq") else None)
                mesh.reset_counts()
                got, dt = _run_counted(dev, fns[name], st_d, m, active, None,
                                       acfg, generator=gen)
                counts[name] = dict(mesh.counts)
                times[name].append(dt)
                res = sc[name](st_s, active, draws)
                _same_result(f"path I1 step {t} {name}", got,
                             (res.state, res.keys, res.vals, res.n_out))
                st_d, st_s = got[0], res.state
        transport = mesh.transport
    launches = {k: n - before.get(k, 0) for k, n in WINDOW_LAUNCHES.items()
                if n - before.get(k, 0)}
    med = {k: float(np.median(v)) * 1e6 for k, v in times.items()}
    log(f"[12 path I1] one rank, {transport}, mesh (1, 1) (pod, shard), "
        f"S_loc={cfg['S']} C={cfg['C']}, {cfg['prefill']} keys in "
        f"{prefill_s:.2f}s ({ {k: n for k, n in prefill_launches.items() if n} }"
        f" launches) | {cfg['steps']} steps of insert_dist (B=64) and "
        f"the five schedules (m={m}) on one carry, every state leaf and "
        f"output equal to the single-controller run | us a step, median "
        f"(all): " + "; ".join(
            f"{k} {med[k]:.1f} ({[round(x * 1e6, 1) for x in times[k]]})"
            for k in times) + " | collectives a call: " + "; ".join(
            f"{k} {_counts_text(c)}" for k, c in counts.items())
        + f" | launches in the distributed calls {launches}")
    return st0, st_d, prefill_launches


def _warm_up(state, keys, vals, cfg, acfg, m_spray, active_spray):
    """One untimed, uncounted call of insert_dist and of each schedule at
    the shapes of the calls that follow (the collectives' first set-up, the
    first launches); results dropped."""
    import torch

    from repro_torch.core.pqueue.dist import insert_dist, rank_generator

    dev = acfg.mesh.device
    k = torch.as_tensor(keys, device=dev)
    state, _, _ = insert_dist(state, k, torch.as_tensor(vals, device=dev),
                              torch.ones_like(k, dtype=torch.bool), acfg,
                              cfg["capacity_factor"])
    gen = rank_generator(cfg["seed"] + 1, acfg)
    for name, fn in _dist_fns().items():
        spray = name in ("spray", "multiq")
        fn(state, m_spray if spray else cfg["m"],
           active_spray if spray else cfg["active"][0], None, acfg,
           generator=gen)
    _sync(dev)


def _counts_text(counts):
    return ", ".join(f"{kind}{list(axes)} x{n}" for (kind, axes), n in
                     sorted(counts.items())) or "none"


def i2_rank(mesh, cfg):
    """One rank of I2 (run by `spawn`): place the prefill's keys by hash,
    then `cfg["steps"]` steps of `insert_dist` (8 keys a rank) and flat,
    HIER and FFWD from the same state (equal on every leaf; the carry goes
    on with flat's), with MULTIQ and spray on the side (no collective,
    keys conserved, MULTIQ's pops within the rank's first m_loc head slots,
    and each equal on every leaf and output to the single controller's
    call at npods=1 on a CPU copy of the rank's state with the same draws,
    the plain versions of the kernels); then Nuddle's `delegate_dist` on
    the final state and the pod-aware collectives.  A failed check raises,
    which fails the rank."""
    import numpy as np
    import torch

    from repro_torch.convert import state_from_numpy, state_to_numpy
    from repro_torch.core import nuddle as N
    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.core.pqueue.dist import (AxisCfg, insert_dist,
                                              rank_generator)
    from repro_torch.core.pqueue.state import make_state
    from repro_torch.distributed import collectives as DC
    from repro_torch.kernels import ops as KO
    from repro_torch.utils.hashing import shard_of_key
    from repro_torch.workloads import traces as TR

    dev, r = mesh.device, mesh.rank
    S_loc = cfg["S"] // mesh.size
    keys, vals, step_k, step_v = _i_keys(cfg)
    mine = (shard_of_key(torch.as_tensor(keys), cfg["S"]) // S_loc
            == r).numpy()
    # INF pads the rank's keys to whole prefill slices, which the insert
    # skips: every rank merges at one shape
    st = make_state(S_loc, cfg["C"], device=dev)
    width = KO.MAX_MERGE_WINDOW - st.head_width
    n_pad = -(-int(mine.sum()) // width) * width
    pk = np.full(n_pad, INF_KEY, np.int32)
    pv = np.zeros(n_pad, np.int32)
    pk[:mine.sum()], pv[:mine.sum()] = keys[mine], vals[mine]
    t0 = time.perf_counter()
    st = TR.prefill(st, pk, pv)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    acfg = AxisCfg(("shard",), "pod", mesh=mesh)
    gen = rank_generator(cfg["seed"], acfg)
    fns, m, m_loc = _dist_fns(), cfg["m"], cfg["m_loc"]
    sc = {"spray": SCH.delete_spray_herlihy, "multiq": SCH.delete_multiq}
    times = {name: [] for name in ("insert",) + SCHEDULES}
    counts, flat_out = {}, []
    _warm_up(st, step_k[0, r], step_v[0, r], cfg, acfg, m_loc,
             cfg["active_loc"][0])
    KO.reset_launches()
    _sync(dev)
    t_steps = time.perf_counter()
    for t in range(cfg["steps"]):
        k = torch.as_tensor(step_k[t, r], device=dev)
        v = torch.as_tensor(step_v[t, r], device=dev)
        mesh.reset_counts()
        (st, dropped, rejected), dt = _run_counted(
            dev, insert_dist, st, k, v, torch.ones_like(k, dtype=torch.bool),
            acfg, cfg["capacity_factor"])
        times["insert"].append(dt)
        counts["insert"] = dict(mesh.counts)
        if bool(rejected.any()) or int(dropped.sum()):
            raise AssertionError(f"rank {r} step {t}: rejected or dropped")
        out, want = {}, {}
        for name in SCHEDULES:
            src = out["flat"][0] if name in ("spray", "multiq") else st
            active = cfg["active_loc" if name in sc else "active"][t]
            if name in sc:
                draws = _twin_draws(gen, name, src, m_loc)
                res = sc[name](state_from_numpy(state_to_numpy(src), "cpu"),
                               m_loc, torch.tensor(active, dtype=torch.int32),
                               tuple(d.cpu() for d in draws), 1)
                want[name] = (res.state, res.keys, res.vals, res.n_out)
            mesh.reset_counts()
            out[name], dt = _run_counted(
                dev, fns[name], src, m_loc if name in sc else m, active, None,
                acfg, generator=gen)
            times[name].append(dt)
            counts[name] = dict(mesh.counts)
        for name in ("hier", "ffwd"):
            _same_result(f"rank {r} step {t} {name}", out[name], out["flat"],
                         "from flat's")
        pre = out["flat"][0]
        for name in sc:
            _same_result(f"rank {r} step {t} {name}", out[name], want[name],
                         "from the single controller's on the CPU")
            post, ok, _, n = out[name]
            got = ok.cpu().numpy()[:int(n)]
            if counts[name]:
                raise AssertionError(f"rank {r}: {name} issued "
                                     f"{counts[name]}")
            if not np.array_equal(np.sort(np.concatenate(
                    [_multiset(post), got])), _multiset(pre)):
                raise AssertionError(f"rank {r} step {t}: {name} lost keys")
        heads = pre.head_keys[:, :m_loc].cpu().numpy().ravel()
        if not np.isin(out["multiq"][1].cpu().numpy()[
                :int(out["multiq"][3])], heads).all():
            raise AssertionError(f"rank {r} step {t}: a MULTIQ pop lies "
                                 f"outside the first {m_loc} head slots")
        flat_out.append([x.cpu().numpy() for x in out["flat"][1:]])
        st = pre
    steps_s = time.perf_counter() - t_steps

    # Nuddle: this rank's rows merged into one sorted run.
    flat_keys = st.keys.reshape(-1)
    order = torch.sort(flat_keys, stable=True).indices
    local = {"keys": flat_keys[order], "vals": st.vals.reshape(-1)[order]}
    mesh.reset_counts()
    (_, verdict), nuddle_s = _run_counted(
        dev, N.delegate_dist, N.pq_tournament_ops(), local, m, ("shard",),
        "pod", ctx={"n": cfg["nuddle_n"]}, mesh=mesh)
    counts["delegate_dist"] = dict(mesh.counts)
    launches = dict(KO.LAUNCHES)

    # one all_gather of 64 int32 over the 8 ranks: staged through host
    # memory from the card (the mesh's), and of a CPU tensor (gloo alone)
    gather_us, run_k = {}, out["flat"][1]
    for where, src in (("staged", run_k), ("host", run_k.cpu())):
        call = (lambda: mesh.all_gather(src, ("pod", "shard"))) if (
            where == "staged") else (lambda: torch.distributed.all_gather(
                [torch.empty_like(src) for _ in range(mesh.size)], src))
        call()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        _sync(dev)
        gather_us[where] = (time.perf_counter() - t0) / 20 * 1e6

    # collectives_check.py on this mesh
    x = np.random.default_rng(0).normal(size=(mesh.size, 64)).astype(
        np.float32)
    xr = torch.as_tensor(x[r], device=dev)
    flat = mesh.psum(xr, ("pod", "shard"))
    hier = DC.hierarchical_psum(xr, ("shard",), "pod", mesh=mesh)
    if not torch.allclose(hier, flat, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"rank {r}: hierarchical psum != flat psum")
    err, acc = torch.zeros_like(xr), torch.zeros_like(xr)
    for _ in range(8):
        out_c, err = DC.compressed_cross_pod_psum(xr, ("shard",), "pod", err,
                                                  mesh=mesh)
        acc += out_c
    drift = float((acc - 8 * flat).abs().max() / (8 * flat).abs().max())
    if drift >= 0.02:
        raise AssertionError(f"rank {r}: error-feedback drift {drift}")
    return {"flat_out": flat_out, "remaining": _multiset(st),
            "verdict": verdict, "times": times, "counts": counts,
            "launches": launches, "prefill_s": prefill_s,
            "steps_s": steps_s, "nuddle_s": nuddle_s, "drift": drift,
            "gather_us": gather_us,
            "transport": mesh.transport, "held": int(mine.sum())}


def path_i2(st0, cfg=PATH_I, device="cuda"):
    """I2: eight ranks as processes on the one card, gloo with host-staged
    payloads (NCCL refuses two ranks on one GPU), a (2, 4) (pod, shard)
    mesh with S_loc = 2: `dist_pq_check.py`'s sequence and
    `multiq_8dev.py`'s checks at full width (in each rank), flat equal to
    the single-controller STRICT_FLAT run of the same steps from `st0` (the
    same 1,048,576 keys on 16 shards), and Nuddle's `delegate_dist` verdict
    equal to `delegate_single_controller`'s.  Returns the ranks' kernel
    launches inside their steps and delegation, summed."""
    import numpy as np
    import torch

    from repro_torch.core import nuddle as N
    from repro_torch.core.pqueue import ops as O
    from repro_torch.core.pqueue.schedules import Schedule
    from repro_torch.distributed import spawn

    dev = torch.device(device)
    _, _, step_k, step_v = _i_keys(cfg)
    st, sc_out = st0, []
    for t in range(cfg["steps"]):
        st, _ = O.insert(st, torch.as_tensor(step_k[t].reshape(-1),
                                             device=dev),
                         torch.as_tensor(step_v[t].reshape(-1), device=dev))
        res = O.delete_min(st, cfg["m"], Schedule.STRICT_FLAT,
                           active=cfg["active"][t])
        sc_out.append(res[1:])
        st = res.state
    _, verdict = N.delegate_single_controller(
        N.pq_tournament_ops(), {"keys": st.keys, "vals": st.vals}, cfg["m"],
        npods=cfg["mesh"][0], ctx={"n": cfg["nuddle_n"]})

    t0 = time.perf_counter()
    ranks = spawn(i2_rank, cfg["mesh"], ("pod", "shard"), device=device,
                  backend="gloo", args=(cfg,), timeout=cfg["spawn_timeout"])
    wall = time.perf_counter() - t0
    between = "from the single controller's"
    for r, got in enumerate(ranks):
        for t, (want, out) in enumerate(zip(sc_out, got["flat_out"])):
            for name, w, g in zip(("keys", "vals", "n"), want, out):
                _same_arrays(f"path I2 rank {r} step {t}: flat {name}", g, w,
                             between)
        _same_arrays(f"path I2 rank {r}: delegate_dist verdict",
                     got["verdict"]["k"], verdict["k"],
                     "from delegate_single_controller's")
    _same_arrays("path I2: remaining multiset", np.sort(np.concatenate(
        [g["remaining"] for g in ranks])), _multiset(st), between)
    launches = {k: sum(g["launches"].get(k, 0) for g in ranks)
                for k in ranks[0]["launches"]}
    med = {k: float(np.median([x for g in ranks for x in g["times"][k]]))
           * 1e6 for k in ranks[0]["times"]}
    log(f"[12 path I2] {len(ranks)} rank processes on "
        f"{'one card' if dev.type == 'cuda' else 'the CPU'}, "
        f"{ranks[0]['transport']}, mesh {cfg['mesh']} (pod, shard), "
        f"S_loc={cfg['S'] // len(ranks)}: keys held {[g['held'] for g in ranks]}"
        f" (placed by hash, prefill {max(g['prefill_s'] for g in ranks):.2f}s"
        f" at most) | {cfg['steps']} steps: flat == hier == ffwd on every "
        f"leaf, flat's outputs and the final multiset equal to the single "
        f"controller's STRICT_FLAT run; MULTIQ and spray conserve keys and "
        f"equal the single controller's on a CPU copy with the same draws, "
        f"MULTIQ pops within each rank's first {cfg['m_loc']} head slots, "
        f"neither issues a collective; delegate_dist verdict equal to "
        f"delegate_single_controller's; hierarchical psum == flat, "
        f"compressed error-feedback drift over 8 steps "
        f"{max(g['drift'] for g in ranks):.4f} (< 0.02) | wall {wall:.2f}s "
        f"(processes started to results read), steps "
        f"{max(g['steps_s'] for g in ranks):.3f}s at most | us a call "
        f"({ranks[0]['transport']}; median over ranks and steps): "
        + "; ".join(
            f"{k} {v:.1f}" for k, v in med.items())
        + f"; delegate_dist {np.median([g['nuddle_s'] for g in ranks]) * 1e6:.1f}"
        + " | one all_gather of 64 int32 over the 8 ranks, us, median over "
        "ranks of 20: the mesh's (staged on the card) and gloo's on a CPU "
        "tensor: " + ", ".join(
            f"{w} {np.median([g['gather_us'][w] for g in ranks]):.1f}"
            for w in ("staged", "host"))
        + " | collectives a call (rank 0): " + "; ".join(
            f"{k} {_counts_text(c)}" for k, c in ranks[0]["counts"].items()))
    for r, g in enumerate(ranks):
        log(f"[12 path I2] rank {r}: launches "
            f"{ {k: n for k, n in g['launches'].items() if n} }")
    return launches


def path_i3(state, cfg=PATH_I, device="cuda"):
    """I3: Nuddle on the card against the CPU: `delegate_single_controller`
    and a K-round `delegate_window` of `pq_tournament_ops` on I1's final
    state, the same inputs on both: verdicts and states bit-identical."""
    import torch

    from repro_torch.core import nuddle as N

    rounds = cfg["rounds"]
    ns = torch.tensor([cfg["m"], cfg["nuddle_n"], 1, 0, cfg["m"], 17, 33,
                       cfg["m"]][:rounds], dtype=torch.int32)
    out, secs, before = {}, {}, dict(WINDOW_LAUNCHES)
    for dev in (torch.device(device), torch.device("cpu")):
        ls = {"keys": state.keys.to(dev), "vals": state.vals.to(dev)}
        ops = N.pq_tournament_ops()
        one, t1 = _run_counted(dev, N.delegate_single_controller, ops, ls,
                               cfg["m"], 2, {"n": cfg["nuddle_n"]})
        win, tw = _run_counted(dev, N.delegate_window, ops, ls, cfg["m"], 2,
                               {"n": ns.to(dev)})
        out[dev.type], secs[dev.type] = (one, win), (t1, tw)
    for (a, b), what in zip(zip(out[device], out["cpu"]),
                            ("delegate_single_controller",
                             f"delegate_window K={rounds}")):
        _same_carry(f"path I3 {what}", a, b)
    t1, tw = secs[device]
    log(f"[12 path I3] Nuddle pq_tournament_ops on I1's final state (16 "
        f"shards x {state.capacity} slots, m={cfg['m']}, npods 2): "
        f"delegate_single_controller {t1 * 1e6:.1f} us, delegate_window "
        f"K={rounds} {tw * 1e6 / rounds:.1f} us a round on the {device}; "
        f"verdicts and states bit-identical to the CPU run | launches "
        f"{ {k: n - before.get(k, 0) for k, n in WINDOW_LAUNCHES.items() if n - before.get(k, 0)} }")
    return 1 + rounds


def path_i(cfg=PATH_I, device="cuda"):
    """Phase 12: I1, I2 and I3.  The path's launch counts are those of its
    own runs: I1's prefill, its distributed calls and I3's delegations in
    this process, and the eight ranks' steps and delegation in I2, each
    rank counted from 0 after its prefill and warm-up.  The
    single-controller runs they are held against, the warm-ups and the
    ranks' prefills stay out of them; per window they count the runs
    alone (a distributed step or a delegation round is a window)."""
    from repro_torch.kernels import ops as KO

    counts_reset()
    st0, st1, prefill_launches = path_i1(cfg, device)
    rank_launches = path_i2(st0, cfg, device)
    rounds = path_i3(st1, cfg, device)
    for k, n in rank_launches.items():
        WINDOW_LAUNCHES[k] = WINDOW_LAUNCHES.get(k, 0) + n
    _, in_runs = counts_read("I")
    launches = {k: in_runs.get(k, 0) + prefill_launches.get(k, 0)
                for k in KO.LAUNCHES}
    return launches, in_runs, cfg["steps"] + rounds


# ---------------------------------------------------------------------------
# phase 13: the dense model path
# ---------------------------------------------------------------------------

# Path J: the dense model path at full width: llama3.2-3b
# (src/repro_torch/configs/llama3_2_3b.py: 28 layers, d 3072, 24 heads, 8
# KV heads, d_ff 8192, vocab 128256), bf16, random weights from a seeded
# torch.Generator on the card.  J2: 4 prompts of 32 tokens, prefill against
# 32 teacher-forced decode steps from empty caches.  J3: launch/serve.py's
# workload (24 requests in bursts of 6, each followed by 4 empty ticks) on
# `EngineConfig(batch_size=8, max_seq=512)` at K = 1 and 4, each run again
# with ticks 4-20 profiled.  J4: reduced llama3.2-3b and gemma-2b on the
# card and on the CPU from one numpy tree, f32 (TF32 off) then bf16.
PATH_J = dict(arch="llama3.2-3b", reduced=False, seed=0, prompts=4,
              prompt_len=32, requests=24, burst=6, batch_size=8,
              max_seq=512, windows=(1, 4), profile=(4, 20), reps=10,
              small=("llama3.2-3b", "gemma-2b"), small_len=16,
              small_steps=8, small_slots=4, small_max_seq=64)
# J2's tolerance, decode against recompute on the card in bf16 at full
# width, in bf16 ulps of the largest prefill value (an ulp: 2^(floor(log2
# max) - 7)): one-row and S-row matmuls round apart at every layer; 6.00
# (logits) to 6.75 (V cache) measured on an H100 (PERF.md §5).
J2_ULPS = 16
# J4's tolerances, the CPU tests' (tests/test_torch_models.py): f32 logits
# within 5e-5 and caches within 1e-5 (absolute); bf16 within 2 ulps.
J4_F32 = dict(logits=5e-5, cache=1e-5)
J4_BF16_ULPS = 2


def _bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want|."""
    import math

    want, got = want.float().cpu(), got.float().cpu()
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) / ulp


def _max_abs(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max())


def path_j1(c=PATH_J, device="cuda"):
    """J1: build the model at full width on the card from a seeded
    generator, one leaf (a stacked leaf one layer) at a time.  Returns
    (config, model, parameters, weight bytes)."""
    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.params import leaves
    from repro_torch.models.registry import build_model

    dev = torch.device(device)
    cfg = (reduced_config if c["reduced"] else get_config)(c["arch"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(c["seed"]))
    _sync(dev)
    init_s = time.perf_counter() - t0
    flat = dict(leaves(params))
    n = sum(w.numel() for w in flat.values())
    nbytes = sum(w.numel() * w.element_size() for w in flat.values())
    norms = sum(w.numel() for p, w in flat.items() if "norm" in p)
    if n - norms != cfg.param_count():
        raise AssertionError(f"path J1: {n - norms} parameters besides the "
                             f"norms, the config counts {cfg.param_count()}")
    if any(w.dtype != torch.bfloat16 for w in flat.values()):
        raise AssertionError("path J1: a leaf is not bf16")
    std = float(flat["embed"][:4096].float().std())
    if abs(std * cfg.d_model ** 0.5 - 1) > 0.05:
        raise AssertionError(f"path J1: embed std {std}")
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    log(f"[13 path J1] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV), d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n:,} parameters ({cfg.param_count():,} counted by "
        f"the config, {norms:,} norm scales), {nbytes:,} bytes in bf16, "
        f"init {init_s:.3f}s on the {dev.type}, peak allocated "
        + (f"{peak:,} bytes" if peak is not None else "not measured"))
    return cfg, model, params, nbytes


def path_j2(cfg, model, params, c=PATH_J, device="cuda"):
    """J2: decode equals recompute at full width: `prefill` of P prompts
    of L tokens against L teacher-forced `decode_step`s from empty caches
    (the last step's logits and both caches), and `train_logits` at the
    last position against `prefill`, within `J2_ULPS`."""
    import torch

    from repro_torch.models.io import init_caches
    from repro_torch.models.params import padded_vocab

    dev = torch.device(device)
    P, L = c["prompts"], c["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(c["seed"] + 1)
    tok = torch.randint(0, cfg.vocab, (P, L), generator=gen, device=dev,
                        dtype=torch.int32)
    t0 = time.perf_counter()
    want, pre = model.prefill(params, {"tokens": tok})
    _sync(dev)
    pre_s = time.perf_counter() - t0
    train, _ = model.train_logits(params, {"tokens": tok})
    caches = init_caches(cfg, P, L, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(L):
        got, caches = model.decode_step(
            params, caches, tok[:, t:t + 1],
            torch.full((P,), t, dtype=torch.int32, device=dev))
    _sync(dev)
    dec_s = time.perf_counter() - t0
    errs = {"decode logits": _bf16_ulps(got, want),
            "train_logits[:, -1]": _bf16_ulps(train[:, -1], want),
            "k cache": _bf16_ulps(caches["k"], pre["k"]),
            "v cache": _bf16_ulps(caches["v"], pre["v"])}
    if tuple(got.shape) != (P, padded_vocab(cfg)) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"path J2: logits {tuple(got.shape)} not "
                             f"finite or not (P, V_pad)")
    bad = {k: v for k, v in errs.items() if v > J2_ULPS}
    if bad:
        raise AssertionError(f"path J2: {bad} bf16 ulps above {J2_ULPS}")
    log(f"[13 path J2] {P} prompts of {L} tokens: prefill "
        f"{pre_s * 1e3:.1f} ms, {L} teacher-forced decode steps "
        f"{dec_s * 1e3 / L:.2f} ms a step (host-issued); bf16 ulps of the "
        f"largest prefill value (at most {J2_ULPS}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in errs.items())
        + f"; largest |logit| {float(want.float().abs().max()):.4f}")


J_LABELS = {"_embed": "J embedding", "_attn_decode": "J attention decode",
            "_ffn": "J MLP", "_unembed": "J unembedding"}


def model_ranges(model, labels):
    """(object, attribute, label) triples of `model`'s methods named in
    `labels` (attribute -> label), for `labelled`."""
    return [(model, attr, label) for attr, label in labels.items()]


@contextlib.contextmanager
def labelled(targets):
    """Each (object, attribute, label) of `targets` (a model's method or a
    layer module's function) runs inside a `record_function` range named
    `label`, so a profiler trace attributes each device call to the
    innermost one."""
    from torch.profiler import record_function

    saved = []
    for obj, attr, label in targets:
        def wrapped(*a, _fn=getattr(obj, attr), _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)
        saved.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, own in reversed(saved):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)


def device_us_by_label(path):
    """Device µs and calls in the Chrome trace at `path`, by the innermost
    `record_function` range whose host thread launched each call (matched
    through the launch's correlation id); calls launched outside every
    range go under "other"."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and not e["name"].startswith("ProfilerStep"))
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        label = "other"
        for a, b, name in spans:
            if ts is not None and a <= ts <= b:
                label = name
        calls, us = out.get(label, (0, 0.0))
        out[label] = (calls + 1, us + float(e["dur"]))
    return out


def kv_prefix_bytes(eng):
    """The valid K/V prefix of the engine's caches, in bytes: what a decode
    step must read of them."""
    cfg = eng.model.cfg
    filled = int(eng.lengths.sum()) + eng.lengths.numel()
    return (2 * cfg.n_layers * filled * cfg.n_kv_heads
            * cfg.resolved_head_dim * 2)


# What a path's decode step reads besides the weights (for its bound),
# how the line names it, and its `record_function` ranges.
J_STEP = dict(tag="J", state_bytes=kv_prefix_bytes,
              state="the valid K/V prefix",
              ranges=lambda model: model_ranges(model, J_LABELS),
              note=None)


def decode_step_times(model, params, eng, nbytes, c=PATH_J, step=J_STEP):
    """One decode step on the engine's state after its run: ms a step as
    the host issues it (CUDA events around `reps` steps), the device's ms
    (CUDA events around a replayed CUDA graph of the step), the bound
    (the weights and `step["state_bytes"]`, each read once, over the
    memory rate), and one profiled step's device µs by
    `step["ranges"]`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels.timing import cuda_ms, graph_ms

    fn = lambda: model.decode_step(params, eng.caches, eng.tokens,  # noqa: E731
                                   eng.lengths)
    host_ms = cuda_ms(fn, iters=c["reps"])
    dev_ms = graph_ms(fn, iters=2, replays=c["reps"])
    bound_ms = (nbytes + step["state_bytes"](eng)) / HBM_BYTES_PER_S * 1e3
    # The first device calls of a profiler session can go unrecorded (the
    # embedding's, in a process that profiled before): a traced warm-up
    # step, discarded, goes first, and the active step's trace is written
    # when it ends.
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{step['tag']}_decode_K{eng.ecfg.sched_window}.json"
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
    with labelled(step["ranges"](model)), prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    by = device_us_by_label(path)
    return host_ms, dev_ms, bound_ms, nbytes / HBM_BYTES_PER_S * 1e3, by


def path_j3(tree, cfg, model, params, nbytes, c=PATH_J, device="cuda",
            step=J_STEP, tag="13 path J3"):
    """J3: the engine at full width on launch/serve.py's workload, at K = 1
    and 4: every request completed with a token at least, `health()`'s
    identities after every window, a mode trace; ms a tick, µs a token,
    tokens/s, host syncs a tick, the decode step's times against its
    bound, the busy share of 16 profiled ticks (the same run again with
    those ticks under the profiler, against the unprofiled run's), the
    scheduler kernels' launches.  Returns the engine ticks run (the
    profiled runs' too: they count as the path's)."""
    import torch

    from repro_torch.launch.serve import workload
    from repro_torch.serve import EngineConfig, ServeEngine

    dev = torch.device(device)
    ticks = 0
    for K in c["windows"]:
        def engine():
            return ServeEngine(cfg, params, EngineConfig(
                batch_size=c["batch_size"], max_seq=c["max_seq"],
                sched_window=K), device=dev, tree=tree)

        eng = engine()
        before = dict(WINDOW_LAUNCHES)
        t0 = time.perf_counter()
        summary, meas = serve_run(eng, workload(c["requests"], c["burst"]),
                                  10_000, check=True)
        took = [time.perf_counter() - t0]
        launches = {k: n - before.get(k, 0)
                    for k, n in WINDOW_LAUNCHES.items()
                    if n - before.get(k, 0)}
        steps = summary["steps"]
        ticks += steps
        if summary["completed"] != c["requests"] or len(eng.outputs) != \
                c["requests"] or min(map(len, eng.outputs.values())) < 1:
            raise AssertionError(f"{tag} K={K}: {summary['completed']} of "
                                 f"{c['requests']} completed")
        if not summary["mode_trace"]:
            raise AssertionError(f"{tag} K={K}: empty mode trace")
        tokens = sum(map(len, eng.outputs.values()))
        wall = meas["wall_s"]
        log(f"[{tag}] K={K}: {summary['completed']}/{c['requests']} "
            f"requests in {steps} ticks, {tokens} tokens, {c['batch_size']} "
            f"slots, max_seq {c['max_seq']}: {wall * 1e3 / steps:.3f} "
            f"ms/tick, {wall * 1e6 / tokens:.1f} us/token, "
            f"{tokens / wall:.1f} tokens/s, host syncs "
            f"{meas['syncs'] / steps:.2f}/tick, "
            f"{_modes_line(summary['mode_trace'])}; identities held after "
            f"{meas['checks']} windows")
        log(f"[{tag}] K={K} launches {launches} "
            f"({ {k: round(n / steps, 3) for k, n in launches.items()} } a "
            f"tick)")
        if dev.type == "cuda":
            t0 = time.perf_counter()
            host_ms, dev_ms, bound_ms, w_ms, by = decode_step_times(
                model, params, eng, nbytes, c, step)
            took.append(time.perf_counter() - t0)
            lo, hi = c["profile"]
            t0 = time.perf_counter()
            psummary, pmeas = serve_run(engine(), workload(
                c["requests"], c["burst"]), 10_000, profile=(lo, hi))
            took.append(time.perf_counter() - t0)
            ticks += psummary["steps"]
            unprofiled = sum(s for step0, (n, s) in meas["window_s"].items()
                             if lo <= step0 < hi)
            share = busy_share(pmeas["prof"], f"{step['tag']}_K{K}",
                               unprofiled)
            layers = "; ".join(f"{k} {us:.1f} us in {n} calls"
                               for k, (n, us) in sorted(by.items()))
            log(f"[{tag}] K={K} decode step: {host_ms:.3f} ms host-issued "
                f"(CUDA events), {dev_ms:.3f} ms on the device (a replayed "
                f"CUDA graph), bound {bound_ms:.3f} ms (weights {w_ms:.3f} "
                f"ms + {step['state']}, at 3.35 TB/s)"
                + (step["note"](model, params, eng) if step["note"] else ""))
            log(f"[{tag}] K={K} device by range, one step "
                f"({sum(n for n, _ in by.values())} calls): {layers}")
            log(f"[{tag}] K={K} ticks {lo}-{hi}: "
                + share_line(*share, per=f"{hi - lo} ticks",
                             of="the same ticks unprofiled"))
        log(f"[{tag}] K={K} took " + ", ".join(
            f"{t:.1f}s {what}" for t, what in zip(
                took, ("run", "decode step readings", "profiled run"))))
        del eng
    return ticks


@contextlib.contextmanager
def f32_models():
    """Engines built inside build their model and caches in f32 (the
    engine has no dtype knob; tests/test_torch_serve.py patches the same
    two functions)."""
    import functools

    import torch

    import repro_torch.models.io as MIO
    import repro_torch.models.registry as MR

    saved = MR.build_model, MIO.init_caches
    MR.build_model = functools.partial(saved[0], compute_dtype=torch.float32)
    MIO.init_caches = functools.partial(saved[1], dtype=torch.float32)
    try:
        yield
    finally:
        MR.build_model, MIO.init_caches = saved


def path_j4(tree, c=PATH_J, device="cuda", tag="13 path J4"):
    """J4 (and K3, L4): the reduced models `c["small"]` with one numpy tree
    on the card and on the CPU (`params_from_numpy`), f32 with TF32 off,
    then bf16: `train_logits`, `prefill` (logits, every cache) and
    teacher-forced decode steps within the CPU tests' tolerances (an SSD
    family's prompt two of its chunks long; an enc-dec or VLM model with
    its norms and gates redrawn, a context, and decode from the prefill's
    `xk`/`xv`; bf16 bounds from `c["small_ulps"]`, else `J4_BF16_ULPS`);
    the launcher's workload
    through `ServeEngine` with EOS off and the same draws: the same
    admissions, completion steps, health and mode trace on both, and in
    f32 the same tokens."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.serve import workload
    from repro_torch.models.io import init_caches
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("path J4: TF32 matmuls are on")
    cpu = torch.device("cpu")
    devs = (torch.device(device), cpu)
    T = c["small_steps"]
    n_req = c.get("small_requests", c["requests"])
    for arch in c["small"]:
        cfg = reduced_config(arch)
        L = 2 * cfg.ssm.chunk if cfg.ssm else c["small_len"]
        ulps = c.get("small_ulps", {}).get(arch, J4_BF16_ULPS)
        weights = init_params(cfg, torch.Generator().manual_seed(3),
                              dtype=torch.float32, device=cpu)
        key, n_ctx = context_of(cfg, c.get("small_frames", 0))
        if key:  # nonzero norms and gates, and a context (L4)
            redraw_nonzero(weights, torch.Generator().manual_seed(5))
            ctx_np = model_context(cfg, n_ctx, 2, torch.Generator(
            ).manual_seed(6), cpu).numpy()
        tree_np = params_to_numpy(weights)
        tok_np = np.random.default_rng(4).integers(
            0, cfg.vocab, (2, L)).astype(np.int32)
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            outs = []
            for d in devs:
                model = build_model(cfg, compute_dtype=dt, device=d)
                p = params_from_numpy(tree_np, cfg, device=d, dtype=dt)
                tok = torch.as_tensor(tok_np, device=d)
                batch = {"tokens": tok}
                if key:
                    batch[key] = torch.as_tensor(ctx_np, device=d)
                train, _ = model.train_logits(p, batch)
                pre, pc = model.prefill(p, batch)
                caches = init_caches(cfg, 2, L, dtype=dt, device=d)
                if key:  # decode attends to the prefill's context K/V
                    caches.update(xk=pc["xk"].clone(), xv=pc["xv"].clone())
                logits = [train, pre]
                for t in range(T):
                    lg, caches = model.decode_step(
                        p, caches, tok[:, t:t + 1],
                        torch.full((2,), t, dtype=torch.int32, device=d))
                    logits.append(lg)
                outs.append(([x.cpu() for x in logits],
                             [x.cpu() for x in [pc[k] for k in sorted(pc)]
                              + [caches[k] for k in sorted(caches)]]))
            (lg_dev, kv_dev), (lg_cpu, kv_cpu) = outs
            if name == "f32":
                err = (max(map(_max_abs, lg_dev, lg_cpu)),
                       max(map(_max_abs, kv_dev, kv_cpu)))
                ok = err[0] <= J4_F32["logits"] and err[1] <= J4_F32["cache"]
                what = (f"max |diff| logits {err[0]:.3g} (<= "
                        f"{J4_F32['logits']}), caches {err[1]:.3g} (<= "
                        f"{J4_F32['cache']})")
            else:
                err = (max(map(_bf16_ulps, lg_dev, lg_cpu)),
                       max(map(_bf16_ulps, kv_dev, kv_cpu)))
                ok = max(err) <= ulps
                what = (f"bf16 ulps logits {err[0]:.2f}, caches "
                        f"{err[1]:.2f} (<= {ulps})")
            if not ok:
                raise AssertionError(f"{tag} {arch} {name}: {what}")
            draws = serve_draws(400, 23)
            runs = []
            with (f32_models() if name == "f32"
                  else contextlib.nullcontext()):
                for d in devs:
                    eng = ServeEngine(cfg, params_from_numpy(
                        tree_np, cfg, device=d, dtype=dt), EngineConfig(
                        batch_size=c["small_slots"],
                        max_seq=c["small_max_seq"], eos_token=-1),
                        device=d, tree=tree, draws=draws)
                    eng.run(workload(n_req, c["burst"]), max_steps=10_000)
                    for k, cache in eng.caches.items():
                        if cache.dtype != (torch.float32 if "ssm" in k
                                           else dt):
                            raise AssertionError(f"{tag}: cache {k} in "
                                                 f"{cache.dtype}")
                    runs.append(eng)
            g, h = runs
            same = (g.admit_step == h.admit_step
                    and g.done_step == h.done_step
                    and g.health() == h.health()
                    and g.scheduler.stats.mode_trace
                    == h.scheduler.stats.mode_trace
                    and len(g.done_step) == n_req)
            if not same or (name == "f32" and g.outputs != h.outputs):
                raise AssertionError(f"{tag} {arch} {name}: the engine "
                                     f"runs differ between card and CPU")
            log(f"[{tag}] {cfg.name} {name}: train_logits, prefill and "
                f"{T} decode steps card against CPU: {what}; engine, "
                f"{n_req} requests, EOS off: admissions, completion "
                f"steps, health and mode trace equal"
                + (", tokens equal" if name == "f32" else ""))


def path_j(tree, c=PATH_J, device="cuda"):
    """Phase 13: J1-J4.  The path's launch counts are those of J3's
    unprofiled engine runs alone (an engine tick is a window of one step):
    the model has no kernel of its own, and the scheduler's kernels run in
    the engine's ticks.  Returns (launches, launches inside the runs,
    ticks)."""
    from repro_torch.kernels import ops as KO

    cfg, model, params, nbytes = path_j1(c, device)
    path_j2(cfg, model, params, c, device)
    counts_reset()
    ticks = path_j3(tree, cfg, model, params, nbytes, c, device)
    _, in_runs = counts_read("J")
    del model, params
    path_j4(tree, c, device)
    return {k: in_runs.get(k, 0) for k in KO.LAUNCHES}, in_runs, ticks


# ---------------------------------------------------------------------------
# path K: the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

# K1: granite-moe-3b-a800m at full width (32 layers, d 1536, 24 heads, 8
# KV heads, 40 experts, top 8, expert d_ff 512, vocab 49155)
# in bf16: the build, one layer's `moe_block` on the card against the CPU
# (f32, TF32 off) at a decode step's 8 tokens and at 128, and J3's engine
# runs.  K2: mamba2-780m at full width (48 SSD layers, d 1536, d_inner
# 3072, 48 heads of 64, state 128, chunk 256, vocab 50280): the build,
# `prefill` of 4 prompts of 256 tokens (one chunk) against 256
# teacher-forced `decode_step`s from zero states, and the engine runs.
# K3: reduced granite-moe-1b-a400m, mamba2-780m and jamba-1.5-large-398b,
# J4's checks.
PATH_K = dict(moe="granite-moe-3b-a800m", ssm="mamba2-780m", reduced=False,
              seed=0,
              # the stored trees (granite-moe: 40 experts, unpadded)
              expect={"granite-moe-3b-a800m": 3_298_985_472,
                      "mamba2-780m": 780_038_400},
              layer_T=(8, 128), prompts=4, prompt_len=256, requests=24,
              burst=6, batch_size=8, max_seq=512, windows=(1, 4),
              # 4 ticks profiled (one K = 4 window) and 5 steps timed: a
              # granite-moe tick traces about 11,600 device calls
              profile=(4, 8), reps=5,
              small=("granite-moe-1b-a400m", "mamba2-780m",
                     "jamba-1.5-large-398b"),
              small_len=16, small_steps=8, small_slots=4, small_max_seq=64,
              small_requests=12,
              # bf16 bounds card against CPU, as tests/test_torch_gpu.py's
              small_ulps={"jamba-1.5-large-398b": 8})
# K1's layer check, the CPU tests' tolerances (tests/test_torch_moe.py).
K1_LAYER = dict(out=2e-5, aux_rtol=1e-6)
# K2's bound, chunked prefill against recurrent decode in bf16 at full
# width, in bf16 ulps of the largest prefill value: the chunk's bf16
# einsums and the recurrence's f32 updates round apart at every layer;
# 0.78 (logits) to 2.74 (`ssm_h`) measured on an H100 (PERF.md §6).
K2_ULPS = 8
K1_LABELS = {"_embed": "K embedding", "_attn_decode": "K attention decode",
             "_moe_ffn": "K MoE norm and residual",
             "_unembed": "K unembedding"}
K1_MOE_LABELS = {"route": "K MoE router", "balance_loss": "K MoE router",
                 "dispatch": "K MoE dispatch", "experts": "K expert products",
                 "combine": "K MoE combine"}
K2_LABELS = {"_embed": "K embedding", "_ssm_decode": "K SSD decode",
             "_unembed": "K unembedding"}


def path_k_build(arch, c=PATH_K, device="cuda", tag="14 path K"):
    """K1/K2's build (and L1/L2's): `arch` at full width on the card from a
    seeded generator.  Returns (config, model, parameters, weight
    bytes)."""
    import torch

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models.params import leaves, param_layout
    from repro_torch.models.registry import build_model

    dev = torch.device(device)
    cfg = (reduced_config if c["reduced"] else get_config)(arch)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(c["seed"]))
    _sync(dev)
    init_s = time.perf_counter() - t0
    flat = dict(leaves(params))
    n = sum(w.numel() for w in flat.values())
    nbytes = sum(w.numel() * w.element_size() for w in flat.values())
    want = sum(math.prod(shape) for _, (shape, _) in
               leaves(param_layout(cfg)))
    expect = c["expect"].get(cfg.name, want)
    if n != want or n != expect:
        raise AssertionError(f"{cfg.name}: {n} parameters, the layout has "
                             f"{want}, expected {expect}")
    std = float(flat["embed"][:4096].float().std())
    if abs(std * cfg.d_model ** 0.5 - 1) > 0.05:
        raise AssertionError(f"{cfg.name}: embed std {std}")
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    dims = (f"{len(flat)} leaves, "
            + (f"{cfg.n_encoder_layers} encoder layers, "
               if cfg.n_encoder_layers else "")
            + (f"{cfg.n_layers // cfg.cross_attn_every} gated "
               f"cross-attention layers, " if cfg.cross_attn_every else "")
            + (f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV) of "
               f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
               if cfg.family in ("encdec", "vlm") else "")
            + (f"{model.moe_dims.n_experts_pad} experts, top "
               f"{cfg.moe.top_k}, "
               if cfg.moe else "")
            + (f"d_inner {cfg.ssm.d_inner}, {model.ssm_dims.n_heads} heads "
               f"of {cfg.ssm.head_dim}, state {cfg.ssm.d_state}, "
               if cfg.ssm else ""))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{dims}vocab {cfg.vocab}: {n:,} parameters, {nbytes:,} bytes, "
        f"init {init_s:.3f}s on the {dev.type}, peak allocated "
        + (f"{peak:,} bytes" if peak is not None else "not measured"))
    return cfg, model, params, nbytes


def path_k1_layer(cfg, model, c=PATH_K, device="cuda"):
    """K1's layer check: one `moe_block` of `cfg` at full width, f32 with
    TF32 off, from one numpy draw at the init scales, on the card and on
    the CPU at each of `c["layer_T"]` tokens: the same routing, kept
    assignments and dropped count, the output and aux within `K1_LAYER`;
    the dropped share, and beside it the share on the reference's 16-wide
    model axis (40 experts padded to 48: cap 1 at 8 tokens, the same
    routing, since the pads never win)."""
    import numpy as np
    import torch

    from repro_torch.models.layers import moe as M

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("path K1: TF32 matmuls are on")
    dims = model.moe_dims
    D, E, F = cfg.d_model, dims.n_experts_pad, cfg.d_ff
    rng = np.random.default_rng(c["seed"] + 7)
    w_np = [(0.02 * rng.standard_normal(s)).astype(np.float32)
            for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]
    for T in c["layer_T"]:
        x_np = rng.standard_normal((1, T, D)).astype(np.float32)
        runs = []
        for d in (torch.device(device), torch.device("cpu")):
            x, rw, wg, wu, wd = (torch.as_tensor(a, device=d)
                                 for a in [x_np] + w_np)
            out, aux = M.moe_block(x, rw, wg, wu, wd, dims)
            _, _, sel = M.route(x.reshape(T, D), rw, dims)
            cap = M.capacity(T, dims)
            keep = torch.stack([k for _, _, k in M.dispatch(sel, dims, cap)])
            runs.append((out.cpu(), float(aux), sel.cpu(), keep.cpu(), cap))
        (og, ag, sg, kg, cap), (oc, ac, sc, kc, _) = runs
        err, aerr = _max_abs(og, oc), abs(ag - ac) / abs(ac)
        if not (torch.equal(sg, sc) and torch.equal(kg, kc)):
            raise AssertionError(f"path K1 T={T}: routing or kept "
                                 f"assignments differ between card and CPU")
        if err > K1_LAYER["out"] or aerr > K1_LAYER["aux_rtol"]:
            raise AssertionError(f"path K1 T={T}: max |diff| {err:.3g}, aux "
                                 f"rel {aerr:.3g} over {K1_LAYER}")
        n_drop = int((~kc).sum())
        wide = dataclasses.replace(dims, n_experts_pad=-(-E // 16) * 16)
        cap16 = M.capacity(T, wide)
        drop16 = sum(int((~k).sum())
                     for _, _, k in M.dispatch(sc, wide, cap16))
        log(f"[14 path K1] moe_block T={T}, f32, card against CPU: cap "
            f"{cap}, the same routing and kept assignments, {n_drop} of "
            f"{kc.numel()} assignments dropped (share {n_drop / kc.numel():.4f}"
            f"; {wide.n_experts_pad} experts on a 16-wide axis: cap {cap16}, "
            f"share {drop16 / kc.numel():.4f}); max |diff| {err:.3g} (<= "
            f"{K1_LAYER['out']}), aux {ac:.6f} rel diff {aerr:.3g} (<= "
            f"{K1_LAYER['aux_rtol']})")


def _moe_drop_note(model, params, eng):
    """The share of one decode step's assignments dropped for capacity, all
    layers, on the engine's state (read after the step)."""
    from repro_torch.models.layers import moe as M

    keeps = []
    dispatch = M.dispatch

    def recording(sel, dims, cap):
        slots = dispatch(sel, dims, cap)
        keeps.extend(k for _, _, k in slots)
        return slots

    M.dispatch = recording
    try:
        model.decode_step(params, eng.caches, eng.tokens, eng.lengths)
    finally:
        M.dispatch = dispatch
    total = sum(k.numel() for k in keeps)
    dropped = sum(int((~k).sum()) for k in keeps)
    return (f"; a decode step drops {dropped} of {total} assignments "
            f"(share {dropped / total:.4f}, cap "
            f"{M.capacity(eng.tokens.numel(), model.moe_dims)})")


def ssm_state_bytes(eng):
    """The SSD states a decode step reads and writes (f32), in bytes."""
    return sum(2 * t.numel() * t.element_size() for t in eng.caches.values())


def _k1_ranges(model):
    """K1's ranges: the model's methods and the MoE layer's stages."""
    from repro_torch.models.layers import moe

    return model_ranges(model, K1_LABELS) + [
        (moe, f, label) for f, label in K1_MOE_LABELS.items()]


K1_STEP = dict(tag="K1", state_bytes=kv_prefix_bytes,
               state="the valid K/V prefix", ranges=_k1_ranges,
               note=_moe_drop_note)
K2_STEP = dict(tag="K2", state_bytes=ssm_state_bytes,
               state="the f32 SSD states read and written",
               ranges=lambda model: model_ranges(model, K2_LABELS),
               note=None)


def path_k2_identity(cfg, model, params, c=PATH_K, device="cuda"):
    """K2: the chunked prefill equals the recurrence at full width:
    `prefill` of P prompts of L tokens against L teacher-forced
    `decode_step`s from zero states (the last logits, `ssm_h` and
    `ssm_conv`), within `K2_ULPS`."""
    import torch

    from repro_torch.models.io import init_caches
    from repro_torch.models.params import padded_vocab

    dev = torch.device(device)
    P, L = c["prompts"], c["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(c["seed"] + 1)
    tok = torch.randint(0, cfg.vocab, (P, L), generator=gen, device=dev,
                        dtype=torch.int32)
    _sync(dev)
    t0 = time.perf_counter()
    want, pre = model.prefill(params, {"tokens": tok})
    _sync(dev)
    pre_s = time.perf_counter() - t0
    caches = init_caches(cfg, P, L, device=dev)
    t0 = time.perf_counter()
    for t in range(L):
        got, caches = model.decode_step(
            params, caches, tok[:, t:t + 1],
            torch.full((P,), t, dtype=torch.int32, device=dev))
    _sync(dev)
    dec_s = time.perf_counter() - t0
    errs = {"decode logits": _bf16_ulps(got, want),
            "ssm_h": _bf16_ulps(caches["ssm_h"], pre["ssm_h"]),
            "ssm_conv": _bf16_ulps(caches["ssm_conv"], pre["ssm_conv"])}
    if tuple(got.shape) != (P, padded_vocab(cfg)) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"path K2: logits {tuple(got.shape)} not "
                             f"finite or not (P, V_pad)")
    bad = {k: v for k, v in errs.items() if v > K2_ULPS}
    log(f"[14 path K2] {P} prompts of {L} tokens ({L // cfg.ssm.chunk} "
        f"chunk): prefill {pre_s * 1e3:.1f} ms, {L} teacher-forced decode "
        f"steps {dec_s * 1e3 / L:.2f} ms a step (host-issued); bf16 ulps of "
        f"the largest prefill value (at most {K2_ULPS}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in errs.items())
        + f"; largest |logit| {float(want.float().abs().max()):.4f}")
    if bad:
        raise AssertionError(f"path K2: {bad} bf16 ulps above {K2_ULPS}")


def path_k(tree, c=PATH_K, device="cuda"):
    """Phase 14: K1-K3.  The path's launch counts are those of K1's and
    K2's unprofiled engine runs, each counted from 0 just before it (the
    MoE model's attention decode launches `decode_attend`, the SSM model
    no hand kernel; the scheduler's kernels run in the engine's ticks).
    Returns (launches, launches inside the runs, ticks)."""
    import torch

    from repro_torch.kernels import ops as KO

    in_runs, ticks, took = {}, 0, []
    for arch, step, tag in ((c["moe"], K1_STEP, "14 path K1"),
                            (c["ssm"], K2_STEP, "14 path K2")):
        t0 = time.perf_counter()
        cfg, model, params, nbytes = path_k_build(arch, c, device)
        if cfg.moe:
            path_k1_layer(cfg, model, c, device)
        else:
            path_k2_identity(cfg, model, params, c, device)
        counts_reset()
        ticks += path_j3(tree, cfg, model, params, nbytes, c, device,
                         step=step, tag=tag)
        also = ("decode_attend",) if cfg.moe else ()
        for k, n in counts_read("K", also)[1].items():
            in_runs[k] = in_runs.get(k, 0) + n
        del model, params
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        took.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    path_j4(tree, c, device, tag="14 path K3")
    log(f"[14 path K] K1 {took[0]:.1f}s, K2 {took[1]:.1f}s, K3 "
        f"{time.perf_counter() - t0:.1f}s")
    return {k: in_runs.get(k, 0) for k in KO.LAUNCHES}, in_runs, ticks


# ---------------------------------------------------------------------------
# path L: the enc-dec and VLM families
# ---------------------------------------------------------------------------

# L1: whisper-base at full width (6 encoder and 6 decoder layers, d 512, 8
# heads of 64, d_ff 2048, vocab 51865 padded to 51968, tied head); L2:
# llama-3.2-vision-11b (40 layers, a gated cross-attention after every 5th,
# d 4096, 32 query heads over 8 K/V heads of 128, d_ff 14336, vocab
# 128256, untied head); bf16, from a seeded generator on the card, their
# norm scales, biases and gates redrawn nonzero (`redraw_nonzero`).  Each:
# the build; `prefill` of 4 prompts of 32 tokens with a context (whisper's
# 1500 encoder frames, `n_audio_ctx` of arXiv:2212.04356's released
# dimensions, its conv stem a stub as in the reference; the VLM's 1024
# image tokens) against 32 teacher-forced `decode_step`s from empty
# self-attention caches and the prefill's `xk`/`xv`, and `train_logits` at
# the last position, within `J2_ULPS`, zeros in place of the context
# moving the logits by more than that; J3's engine runs and readings.  L4:
# the reduced models as J4, with a context.
PATH_L = dict(encdec="whisper-base", vlm="llama-3.2-vision-11b",
              reduced=False, seed=0,
              expect={"whisper-base": 70_737_920,
                      "llama-3.2-vision-11b": 10_110_734_344},
              enc_frames=1500, prompts=4, prompt_len=32, requests=24,
              burst=6, batch_size=8, max_seq=512, windows=(1, 4),
              profile=(4, 8), reps=5,
              small=("whisper-base", "llama-3.2-vision-11b"), small_len=16,
              small_frames=24, small_steps=8, small_slots=4,
              small_max_seq=64, small_requests=12,
              # the VLM's bf16 bound, tests/test_torch_encdec_vlm.py's
              small_ulps={"llama-3.2-vision-11b": 3})
L_LABELS = {"_embed": "L embedding", "_attn_decode": "L self-attention decode",
            "_cross_attn": "L cross-attention", "_ffn": "L MLP",
            "_unembed": "L unembedding"}


def redraw_nonzero(params, gen):
    """Norm scales and biases (N(0, 0.1^2)) and the VLM's gates (N(0, 1))
    redrawn from `gen` in place, as the CPU tests redraw theirs
    (tests/test_torch_models.py `_redrawn_tree`): zero at init, they zero
    whisper's logits (each layer norm outputs its zero bias) and cut the
    VLM's image off (tanh(0)).  Returns `params`."""
    import torch

    from repro_torch.models.params import leaves

    for path, w in leaves(params):
        name = path.split("/")[-1]
        if name.startswith(("b", "norm", "final_norm")) or name == "gate":
            z = torch.randn(w.shape, generator=gen, device=gen.device)
            w.copy_(z * (1.0 if name == "gate" else 0.1))
    return params


def context_of(cfg, enc_frames: int):
    """(batch key, frames or image tokens) of a model's context, or (None,
    0) for a family without one."""
    if cfg.family == "encdec":
        return "enc_embeds", enc_frames
    if cfg.family == "vlm":
        return "image_embeds", cfg.n_image_tokens
    return None, 0


def model_context(cfg, n, P, gen, device):
    """P contexts of n frames (or image tokens), f32: one draw shared by a
    prompt's frames plus one a frame, as audio frames and image patches
    share what they show; frames drawn independently would average out
    under random-weight attention, and the cross path would barely move
    the logits."""
    import torch

    D = cfg.d_model
    return (torch.randn((P, 1, D), generator=gen, device=device)
            + torch.randn((P, n, D), generator=gen, device=device))


def decode_weight_bytes(cfg, params, batch: int) -> int:
    """The weights one decode step of `batch` tokens reads, in bytes: all
    but the encoder's and the cross-attention's K/V projections (the
    context's K/V are cached), and of an untied embedding its `batch`
    rows."""
    from repro_torch.models.params import leaves

    total = 0
    for path, w in leaves(params):
        top, name = path.split("/")[0], path.split("/")[-1]
        if top.startswith("enc_") or (top in ("dec_cross", "cross")
                                      and name in ("wk", "wv", "bk", "bv")):
            continue
        if path == "embed" and not cfg.tie_embeddings:
            total += batch * w.shape[1] * w.element_size()
            continue
        total += w.numel() * w.element_size()
    return total


def cross_bytes(eng):
    """The cross-attention K/V a decode step reads (every frame), bytes."""
    return sum(eng.caches[k].numel() * eng.caches[k].element_size()
               for k in ("xk", "xv"))


def _logit_note(model, params, eng):
    """The largest |logit| of one decode step on the engine's state."""
    logits, _ = model.decode_step(params, eng.caches, eng.tokens,
                                  eng.lengths)
    return (f"; largest |logit| of a step "
            f"{float(logits.float().abs().max()):.4f}")


L_STEP = dict(state_bytes=lambda eng: kv_prefix_bytes(eng) + cross_bytes(eng),
              state="the valid K/V prefix and xk/xv",
              ranges=lambda model: model_ranges(model, L_LABELS),
              note=_logit_note)


def path_l_identity(cfg, model, params, c=PATH_L, device="cuda",
                    tag="15 path L"):
    """L1/L2's check: `prefill` of P prompts of L tokens with the context
    against L teacher-forced `decode_step`s from empty self-attention
    caches and the prefill's `xk`/`xv` (the last logits, both K/V caches),
    and `train_logits` at the last position, within `J2_ULPS`; the
    context replaced by zeros moves the prefill's logits by more than
    `J2_ULPS`."""
    import torch

    from repro_torch.models.io import init_caches
    from repro_torch.models.params import padded_vocab

    dev = torch.device(device)
    P, L = c["prompts"], c["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(c["seed"] + 1)
    tok = torch.randint(0, cfg.vocab, (P, L), generator=gen, device=dev,
                        dtype=torch.int32)
    key, n = context_of(cfg, c["enc_frames"])
    ctx = model_context(cfg, n, P, gen, dev)
    _sync(dev)
    t0 = time.perf_counter()
    want, pre = model.prefill(params, {"tokens": tok, key: ctx})
    _sync(dev)
    pre_s = time.perf_counter() - t0
    train, _ = model.train_logits(params, {"tokens": tok, key: ctx})
    zero, _ = model.prefill(params, {"tokens": tok,
                                     key: torch.zeros_like(ctx)})
    caches = init_caches(cfg, P, L, device=dev)
    caches.update(xk=pre["xk"], xv=pre["xv"])
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(L):
        got, caches = model.decode_step(
            params, caches, tok[:, t:t + 1],
            torch.full((P,), t, dtype=torch.int32, device=dev))
    _sync(dev)
    dec_s = time.perf_counter() - t0
    errs = {"decode logits": _bf16_ulps(got, want),
            "train_logits[:, -1]": _bf16_ulps(train[:, -1], want),
            "k cache": _bf16_ulps(caches["k"], pre["k"]),
            "v cache": _bf16_ulps(caches["v"], pre["v"])}
    live = _bf16_ulps(zero, want)
    if tuple(got.shape) != (P, padded_vocab(cfg)) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: logits {tuple(got.shape)} not finite "
                             f"or not (P, V_pad)")
    log(f"[{tag}] {P} prompts of {L} tokens, {key} {tuple(ctx.shape)}: "
        f"prefill {pre_s * 1e3:.1f} ms, {L} teacher-forced decode steps "
        f"{dec_s * 1e3 / L:.2f} ms a step (host-issued); bf16 ulps of the "
        f"largest prefill value (at most {J2_ULPS}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in errs.items())
        + f"; zeros for {key} move it {live:.2f} ulps (above {J2_ULPS}); "
        f"largest |logit| {float(want.float().abs().max()):.4f}")
    bad = {k: v for k, v in errs.items() if v > J2_ULPS}
    if bad:
        raise AssertionError(f"{tag}: {bad} bf16 ulps above {J2_ULPS}")
    if not live > J2_ULPS:
        raise AssertionError(f"{tag}: the context moves the logits "
                             f"{live:.2f} ulps, not above {J2_ULPS}")


def path_l(tree, c=PATH_L, device="cuda"):
    """Phase 15: L1-L4.  The path's launch counts are those of L1's and
    L2's unprofiled engine runs, each counted from 0 just before it (the
    models' self-attention decode launches `decode_attend`; the
    scheduler's kernels run in the engine's ticks).  Returns (launches,
    launches inside the runs, ticks)."""
    import torch

    from repro_torch.kernels import ops as KO

    dev = torch.device(device)
    in_runs, ticks, took = {}, 0, []
    for arch, tag in ((c["encdec"], "L1"), (c["vlm"], "L2")):
        t0 = time.perf_counter()
        cfg, model, params, nbytes = path_k_build(arch, c, device,
                                                  tag=f"15 path {tag}")
        redraw_nonzero(params, torch.Generator(device=dev).manual_seed(
            c["seed"] + 2))
        path_l_identity(cfg, model, params, c, device, tag=f"15 path {tag}")
        counts_reset()
        ticks += path_j3(tree, cfg, model, params,
                         decode_weight_bytes(cfg, params, c["batch_size"]),
                         c, device, step=dict(L_STEP, tag=tag),
                         tag=f"15 path {tag}")
        for k, n in counts_read("L")[1].items():
            in_runs[k] = in_runs.get(k, 0) + n
        del model, params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        took.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    path_j4(tree, c, device, tag="15 path L4")
    log(f"[15 path L] L1 {took[0]:.1f}s, L2 {took[1]:.1f}s, L4 "
        f"{time.perf_counter() - t0:.1f}s")
    return {k: in_runs.get(k, 0) for k in KO.LAUNCHES}, in_runs, ticks


# ---------------------------------------------------------------------------
# path M: the int8 KV cache and training
# ---------------------------------------------------------------------------

# M1: llama3.2-3b at full width in bf16 (seeded, on the card): 4 prompts of
# 32 tokens teacher-forced through `decode_step` from empty int8 caches
# (`kv_int8=True`, max_seq 512) and from bf16 ones, the same greedy token at
# every step and the softmaxes within 0.05 (the bar of the reference's
# tests/test_kernel_integration.py:45-75); the cache bytes of
# `EngineConfig(batch_size=8, max_seq=512)` in int8 and in bf16; a decode
# step of 8 slots on each, host-issued and on the device (a replayed CUDA
# graph); 8 steps of `make_serve_step(kv_int8=True)` against the bf16 serve
# step.  M2: llama3.2-3b trained at full width: f32 masters from the seeded
# generator, bf16 compute, remat, `AdamWConfig(lr=1e-3,
# state_dtype="int8")` (the launcher's lr), `SyntheticLMDataset(vocab,
# seq_len=1024, fixed_map=True)` at batch 2: 8 steps, 2 warm-up and 6
# timed with CUDA events, one more profiled by range; every loss finite and
# the last below the first.  M3: reduced llama3.2-3b, granite-moe-1b-a400m
# and mamba2-780m card against CPU from one numpy tree in f32 (TF32 off):
# the loss and every gradient leaf; one `adamw_update` a state dtype; the
# checkpoint drill of tests/test_train.py:70-81 on reduced gemma-2b on the
# card (a failure injected at step 12, `latest_step` 10, the restored state
# bit-equal to what was saved, the run resumed to 20, its losses against
# an uninterrupted run's, the card's checkpoint read back on the CPU); and
# reduced llama3.2-3b's int8 decode card against CPU, f32 and bf16.
PATH_M = dict(arch="llama3.2-3b", reduced=False, seed=0, prompts=4,
              prompt_len=32, max_seq=512, slots=8, serve_steps=8, reps=10,
              batch=2, seq_len=1024, lr=1e-3, state_dtype="int8",
              warmup=2, timed=6,
              small=("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-780m"),
              small_len=16, drill="gemma-2b", drill_steps=20, drill_every=5,
              drill_fail=12, int8_steps=8)
# M1's bars: the reference test's max |softmax(int8) - softmax(bf16)|; and
# the int8 decode's logits within M1_LOGIT_REL of the step's largest
# |logit| from the bf16 decode's (measured 7.6 % at full width on an H100,
# 0.5 % for the reduced model on the CPU): random-weight layers amplify
# the cache's quantization noise (about 0.7 % of a row's values) through
# 28 layers, as they amplify bf16's own rounding (the bf16 decode's
# distance from recompute, `train_logits` of the prompts, is printed
# beside it: 4.3 %).  With random weights the 28-layer residual stream
# carries the logits far from the tied embedding's token: they are near
# Gaussian over 128,256 columns and the top two sit about 0.2 apart, so
# rounding alone moves the greedy token at some steps (bf16 decode
# against recompute does), and the reference's greedy bar, which its
# reduced model meets (tests/test_torch_kv_int8.py), is read here as
# counts.
M1_SOFTMAX = 0.05
M1_LOGIT_REL = 0.15
# M3's tolerances, the CPU tests' (tests/test_torch_grad.py,
# test_torch_train.py, test_torch_kv_int8.py): the loss within 1e-6
# relative, each gradient leaf within 1e-5 of its largest |g|; AdamW's f32
# leaves within 2 f32 ulps of the leaf's largest value, int8 payloads
# within 2 quanta, scales within 2 bf16 ulps.  The int8 decode's logits
# within J4's bf16 bound (2 ulps) in f32 too: a K/V value that card and CPU
# round an f32 ulp apart can land on either side of a quantum's half, so
# a few payload entries differ by a quantum even in f32 (one such moved a
# reduced model's f32 logits by 1.5e-3, 30x J4's f32 bound).  The drill's resumed losses against the uninterrupted run's
# on the card: within 1e-3 relative (the embedding's and the loss's
# backward add with atomics, so two runs on the card differ by ulps).
M3_GRAD = dict(loss=1e-6, leaf=1e-5)
M3_DRILL_LOSS = 1e-3
H100_BF16_FLOPS = 989e12  # H100 SXM dense bf16 peak
M_LABELS = {"forward": "M forward", "loss": "M loss",
            "backward": "M backward", "optimizer": "M optimizer"}


def _softmax_gap(a, b) -> float:
    return float((a.float().softmax(-1) - b.float().softmax(-1)).abs().max())


def _bytes(tree) -> int:
    from repro_torch.train.optimizer import tree_leaves

    out = 0
    for e in tree_leaves(tree):
        for t in (e if isinstance(e, tuple) else (e,)):
            out += t.numel() * t.element_size()
    return out


def path_m1(c=PATH_M, device="cuda"):
    """M1: the int8 KV cache at full width against bf16 caches (decode,
    bytes, device time) and `make_serve_step(kv_int8=True)`."""
    import torch

    from repro_torch.kernels.timing import cuda_ms, graph_ms
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_serve_step

    dev = torch.device(device)
    cfg, model, params, _ = path_k_build(c["arch"], dict(c, expect={}),
                                         device, tag="16 path M1")
    m8 = build_model(cfg, kv_int8=True, device=dev)
    P, L, S = c["prompts"], c["prompt_len"], c["max_seq"]
    gen = torch.Generator(device=dev).manual_seed(c["seed"] + 1)
    tok = torch.randint(0, cfg.vocab, (P, L), generator=gen, device=dev,
                        dtype=torch.int32)
    caches = {name: init_caches(cfg, P, S, kv_int8=name == "int8",
                                device=dev) for name in ("int8", "bf16")}
    with torch.no_grad():
        recompute = model.train_logits(params, {"tokens": tok})[0].float()
    gap = rel = noise = 0.0
    agree, agree_bf16, flips = 0, 0, []  # flips: bf16's top-2 gap there
    for t in range(L):
        lengths = torch.full((P,), t, dtype=torch.int32, device=dev)
        l8, _ = m8.decode_step(params, caches["int8"], tok[:, t:t + 1],
                               lengths)
        lb, _ = model.decode_step(params, caches["bf16"], tok[:, t:t + 1],
                                  lengths)
        if not bool(torch.isfinite(l8).all()):
            raise AssertionError(f"path M1: logits not finite at step {t}")
        gap = max(gap, _softmax_gap(l8, lb))
        lbf, l8f, ref = lb.float(), l8.float(), recompute[:, t]
        rel = max(rel, float((l8f - lbf).abs().max() / lbf.abs().max()))
        noise = max(noise, float((lbf - ref).abs().max() / ref.abs().max()))
        same = l8.argmax(-1) == lb.argmax(-1)
        agree += int(same.sum())
        agree_bf16 += int((lb.argmax(-1) == ref.argmax(-1)).sum())
        picked = lbf.gather(1, l8.argmax(-1)[:, None])[:, 0]
        flips += (lbf.amax(-1) - picked)[~same].tolist()
    if gap >= M1_SOFTMAX or rel > M1_LOGIT_REL:
        raise AssertionError(f"path M1: softmax gap {gap} (bound "
                             f"{M1_SOFTMAX}), int8 logits {rel} from bf16's "
                             f"(bound {M1_LOGIT_REL})")
    # `make_serve_step(kv_int8=True)`: 8 greedy steps from the prompts'
    # caches, each token the argmax of `decode_step` on a copy of the
    # caches given the same inputs; the bf16 serve step's tokens beside
    served = {}
    for name, kv_int8 in (("int8", True), ("bf16", False)):
        serve, _ = make_serve_step(cfg, kv_int8=kv_int8, device=dev)
        batch = {"tokens": tok[:, -1:],
                 "lengths": torch.full((P,), L - 1, dtype=torch.int32,
                                       device=dev),
                 "caches": {k: v.clone() for k, v in caches[name].items()}}
        out = []
        for _ in range(c["serve_steps"]):
            batch = serve(params, batch)
            out.append(batch["tokens"])
        if int(batch["lengths"].min()) != L - 1 + c["serve_steps"]:
            raise AssertionError("path M1: serve step lengths")
        served[name] = torch.cat(out, dim=1)
    replay, fed = caches["int8"], tok[:, -1:]
    for i in range(c["serve_steps"]):
        lengths = torch.full((P,), L - 1 + i, dtype=torch.int32, device=dev)
        lg, _ = m8.decode_step(params, replay, fed, lengths)
        fed = lg.argmax(-1).to(torch.int32)[:, None]
        if not torch.equal(fed[:, 0], served["int8"][:, i]):
            raise AssertionError(f"path M1: serve step {i}'s tokens are not "
                                 f"decode_step's argmax")
    n = P * L
    log(f"[16 path M1] {P} prompts of {L} tokens teacher-forced from empty "
        f"caches (max_seq {S}), int8 against bf16: max |softmax diff| "
        f"{gap:.3g} (< {M1_SOFTMAX}); logits within {rel:.4g} of the "
        f"largest (<= {M1_LOGIT_REL}), the bf16 decode's own within "
        f"{noise:.4g} of recompute; the same greedy token "
        f"as bf16 at {agree} of {n} steps (bf16 decode as recompute at "
        f"{agree_bf16}), the {n - agree} others where the bf16 top logit "
        f"is above the int8 choice's by "
        + (f"{min(flips):.4f}-{max(flips):.4f}" if flips else "-")
        + f"); {c['serve_steps']} `make_serve_step(kv_int8=True)` steps, "
        f"each token `decode_step`'s argmax; {int((served['int8'] == served['bf16']).sum())} "
        f"of {served['int8'].numel()} equal to the bf16 serve step's")
    del caches
    # the engine's cache and a decode step of its 8 slots, each cache kind
    B = c["slots"]
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    w_bytes = decode_weight_bytes(cfg, params, B)
    parts = []
    for name, m in (("int8", m8), ("bf16", model)):
        cache = init_caches(cfg, B, S, kv_int8=name == "int8", device=dev)
        nbytes = {k: v.numel() * v.element_size() for k, v in cache.items()}
        # one position of one layer: K and V rows (and their scales)
        row = sum(v[0, 0, 0].numel() * v.element_size()
                  for v in cache.values())
        valid = (L + 1) * B * row * cfg.n_layers

        def fn(m=m, cache=cache):
            return m.decode_step(params, cache, tokens, lengths)

        bound = (w_bytes + valid) / HBM_BYTES_PER_S * 1e3
        if dev.type == "cuda":
            times = (f"{cuda_ms(fn, iters=c['reps']):.3f} ms host-issued, "
                     f"{graph_ms(fn, iters=2, replays=c['reps']):.3f} ms on "
                     f"the device (a replayed CUDA graph)")
        else:
            fn()
            times = "times not measured (no card)"
        parts.append(
            f"{name}: cache {sum(nbytes.values()):,} bytes ("
            + ", ".join(f"{k} {v:,}" for k, v in nbytes.items())
            + f"), a step {times}, bound {bound:.3f} ms (weights and the "
            f"valid K/V prefix at 3.35 TB/s)")
        del cache
    log(f"[16 path M1] {B} slots, max_seq {S}, lengths {L}: "
        + "; ".join(parts))
    return cfg


def _timed_steps(step, params, opt, batch, n, dev):
    """`n` train steps, each between CUDA events (host clocks on the CPU):
    (params, opt, ms list, losses)."""
    import torch

    ms, losses = [], []
    for _ in range(n):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            params, opt, metrics = step(params, opt, batch)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return params, opt, ms, losses


def profile_train_step(step, model, params, opt, batch, name):
    """One train step after one warm-up step under torch.profiler, its
    device calls attributed to M_LABELS' ranges (forward, loss, backward,
    optimizer; `device_us_by_label`).  Returns (params, opt, {range:
    (calls, µs)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    import repro_torch.train.steps as TS

    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{name}.json"
    prof = profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
        schedule=schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
    targets = [(model, "train_logits", M_LABELS["forward"]),
               (TS, "cross_entropy_loss", M_LABELS["loss"]),
               (torch.autograd, "grad", M_LABELS["backward"]),
               (TS, "grad_norm", M_LABELS["optimizer"]),
               (TS, "adamw_update", M_LABELS["optimizer"])]
    with labelled(targets), prof:
        for _ in range(2):
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            prof.step()
    return params, opt, device_us_by_label(path)


def by_range_line(by) -> str:
    total = sum(us for _, us in by.values())
    return (f"({sum(n for n, _ in by.values())} calls, {total / 1e3:.3f} "
            "ms): " + "; ".join(f"{k} {us / 1e3:.3f} ms in {n} calls"
                                for k, (n, us) in sorted(by.items())))


def path_m2(c=PATH_M, device="cuda"):
    """M2: llama3.2-3b trained at full width (f32 masters, bf16 compute,
    remat, int8 first moments).  Returns the steps run (the main path's
    windows)."""
    import statistics

    import torch

    import repro_torch.train.steps as TS
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.data.loader import to_device
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.params import init_params, leaves
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    dev = torch.device(device)
    cfg = (reduced_config if c["reduced"] else get_config)(c["arch"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(lr=c["lr"], state_dtype=c["state_dtype"])
    step, model = TS.make_train_step(cfg, None, opt_cfg, remat=True,
                                     device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        c["seed"]), dtype=torch.float32, device=dev)
    opt = adamw_init(params, opt_cfg)
    data = SyntheticLMDataset(cfg.vocab, seq_len=c["seq_len"],
                              fixed_map=True, seed=c["seed"])
    batch = to_device(data.batch(0, c["batch"]), dev)
    N = sum(w.numel() for _, w in leaves(params))
    tokens = c["batch"] * c["seq_len"]
    t0 = time.perf_counter()
    params, opt, warm_ms, losses = _timed_steps(step, params, opt, batch,
                                                c["warmup"], dev)
    params, opt, ms, more = _timed_steps(step, params, opt, batch,
                                         c["timed"], dev)
    losses += more
    took = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"path M2: losses {losses} not finite or not "
                             f"falling")
    pairs = [e for _, e in leaves(opt.m) if isinstance(e, tuple)]
    scales = sum(s.numel() * s.element_size() for _, s in pairs)
    parts = {"masters": _bytes(params), "gradients (f32)": 4 * N,
             "m": _bytes(opt.m) - scales, "m scales": scales,
             "v": _bytes(opt.v)}
    med = statistics.median(ms)
    opt_bytes = 2 * parts["masters"] + parts["gradients (f32)"] + 2 * (
        parts["m"] + parts["m scales"] + parts["v"])
    flops_ms = 6 * N * tokens / H100_BF16_FLOPS * 1e3
    bytes_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[16 path M2] {cfg.name} training: {N:,} parameters, batch "
        f"{c['batch']} x {c['seq_len']} tokens, f32 masters, bf16 compute, "
        f"remat, AdamW lr {c['lr']} with {c['state_dtype']} first moments; "
        "bytes " + ", ".join(f"{k} {v:,}" for k, v in parts.items())
        + ", peak allocated "
        + (f"{peak:,}" if peak is not None else "not measured"))
    log(f"[16 path M2] losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"warm-up steps {', '.join(f'{x:.1f}' for x in warm_ms)} ms; "
        f"{c['timed']} timed steps {med:.3f} ms median ({min(ms):.3f}-"
        f"{max(ms):.3f}), {tokens / med * 1e3:,.1f} tokens/s; bound "
        f"{flops_ms + bytes_ms:.3f} ms (6 N tokens {6 * N * tokens:.4g} "
        f"FLOP at 989 TFLOP/s {flops_ms:.3f} ms + the optimizer's "
        f"{opt_bytes:,} bytes at 3.35 TB/s {bytes_ms:.3f} ms), model-FLOPs "
        f"share {flops_ms / med:.4f}; {took:.1f}s")
    if dev.type == "cuda":
        params, opt, by = profile_train_step(step, model, params, opt, batch,
                                             "M2_train_step")
        log(f"[16 path M2] one profiled step on the device by range "
            f"{by_range_line(by)}")
    del params, opt
    return c["warmup"] + c["timed"]


def _grads_on(cfg, tree_np, batch_np, device):
    """(loss, {path: gradient on the CPU}) of `cfg`'s training loss in f32
    on `device` from numpy weights and batch."""
    import torch

    from repro_torch.convert import params_from_numpy
    from repro_torch.models.model import cross_entropy_loss
    from repro_torch.models.params import leaves
    from repro_torch.models.registry import build_model

    model = build_model(cfg, compute_dtype=torch.float32, device=device)
    params = params_from_numpy(tree_np, cfg, device=device,
                               dtype=torch.float32)
    flat = [w.requires_grad_(True) for _, w in leaves(params)]
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in batch_np.items()}
    logits, aux = model.train_logits(params, batch)
    total = cross_entropy_loss(logits, batch["labels"], cfg.vocab) + 0.01 * aux
    grads = torch.autograd.grad(total, flat)
    return float(total.detach()), {p: g.cpu() for (p, _), g in
                                   zip(leaves(params), grads)}


def _adamw_on(device, state_dtype, p_np, grads_np):
    """Parameters and moments after one `adamw_update` on `device`: name ->
    (f32 numpy array, stored dtype)."""
    import torch

    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update)

    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    p = {k: torch.as_tensor(v, device=device) for k, v in p_np.items()}
    st = adamw_init(p, cfg)
    p, st = adamw_update(p, {k: torch.as_tensor(v, device=device)
                             for k, v in grads_np.items()}, st, cfg)
    out = {f"p/{k}": v for k, v in p.items()}
    for moment in ("m", "v"):
        for k, e in getattr(st, moment).items():
            for i, t in enumerate(e if isinstance(e, tuple) else (e,)):
                out[f"{moment}/{k}/{i}"] = t
    return {k: (t.cpu().float().numpy(), t.dtype) for k, t in out.items()}


def path_m3(c=PATH_M, device="cuda"):
    """M3: reduced models' gradients, AdamW, the checkpoint drill and the
    int8 decode, card against CPU."""
    import shutil

    import numpy as np
    import torch

    import repro_torch.train.loop as TL
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.io import init_caches
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.optimizer import tree_leaves

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("path M3: TF32 matmuls are on")
    dev, cpu = torch.device(device), torch.device("cpu")
    notes = []
    for arch in c["small"]:
        cfg = reduced_config(arch)
        tree_np = params_to_numpy(redraw_nonzero(init_params(
            cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
            device=cpu), torch.Generator().manual_seed(5)))
        S = 2 * cfg.ssm.chunk if cfg.ssm else c["small_len"]
        tok = np.random.default_rng(4).integers(0, cfg.vocab, (2, S + 1))
        batch = {"tokens": tok[:, :-1].astype(np.int32),
                 "labels": tok[:, 1:].astype(np.int32)}
        (lg, gg), (lc, gc) = (_grads_on(cfg, tree_np, batch, d)
                              for d in (dev, cpu))
        rel = abs(lg - lc) / abs(lc)
        worst = max(float((gg[k] - gc[k]).abs().max())
                    / max(float(gc[k].abs().max()), 1e-30) for k in gc)
        if rel > M3_GRAD["loss"] or worst > M3_GRAD["leaf"]:
            raise AssertionError(f"path M3 {arch}: loss {rel:.3g}, "
                                 f"gradients {worst:.3g} (relative)")
        notes.append(f"{cfg.name} loss {rel:.2g}, gradients {worst:.2g}")
    rng = np.random.default_rng(1)
    p_np = {"stack": rng.standard_normal((2, 4, 512)).astype(np.float32),
            "norm": rng.standard_normal((256,)).astype(np.float32),
            "tiny": rng.standard_normal((3,)).astype(np.float32)}
    g_np = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in p_np.items()}
    for sd in ("fp32", "bf16", "int8"):
        a, b = (_adamw_on(d, sd, p_np, g_np) for d in (dev, cpu))
        for k, (want, dtype) in b.items():
            top = float(np.abs(want).max())
            diff = float(np.abs(a[k][0] - want).max())
            if a[k][1] != dtype:
                raise AssertionError(f"path M3: adamw_update {sd} {k}: "
                                     f"{a[k][1]} on the card, {dtype} on "
                                     f"the CPU")
            if dtype == torch.int8:
                ok = diff <= 2  # quanta
            elif dtype == torch.bfloat16:
                ok = diff <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
            else:
                ok = diff <= 2 * float(np.spacing(np.float32(top)))
            if not ok:
                raise AssertionError(f"path M3: adamw_update {sd} {k}: "
                                     f"{diff} apart")
    notes.append("adamw_update fp32, bf16, int8 within the CPU tests' bounds")
    log("[16 path M3] card against CPU, f32 (TF32 off), relative to the "
        "CPU's: " + "; ".join(notes))
    # the checkpoint drill on the card
    cfg = reduced_config(c["drill"])
    root = TRACE_DIR / "M3_ckpt"
    if root.exists():
        shutil.rmtree(root)
    loop = TL.LoopConfig(steps=c["drill_steps"], batch_size=2,
                         ckpt_every=c["drill_every"], ckpt_dir=str(root))
    saved, save = {}, ckpt.save

    def keep(d, step, tree, **kw):
        saved[step] = ckpt._host_copy(tree)
        return save(d, step, tree, **kw)

    ckpt.save = keep
    try:
        try:
            TL.run(cfg, loop, injector=FailureInjector(
                fail_at=(c["drill_fail"],)), device=dev)
            raise AssertionError("path M3: the injected failure never fired")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
    finally:
        ckpt.save = save
    last = ckpt.latest_step(root)
    if last != 10:
        raise AssertionError(f"path M3: latest_step {last}, not 10")
    like = {"params": init_params(cfg, dtype=torch.float32, device=dev)}
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    like["opt"] = adamw_init(like["params"], AdamWConfig(lr=1e-3))
    restored = ckpt.restore(root, like)

    def flat(tree):
        return [t for e in tree_leaves({"p": tree["params"],
                                        "m": tree["opt"].m,
                                        "v": tree["opt"].v})
                for t in (e if isinstance(e, tuple) else (e,))] + [
            tree["opt"].step]

    same = all(a.device.type == dev.type and a.dtype == b.dtype
               and torch.equal(a.cpu(), b) for a, b in
               zip(flat(restored), flat(saved[10])))
    if not same:
        raise AssertionError("path M3: the restored state is not what was "
                             "saved at step 10")
    res = TL.run(cfg, loop, device=dev)
    whole = TL.run(cfg, TL.LoopConfig(steps=c["drill_steps"], batch_size=2),
                   device=dev)
    if res["resumed_from"] != 10 or res["steps_done"] != c["drill_steps"]:
        raise AssertionError(f"path M3: resumed from {res['resumed_from']}, "
                             f"{res['steps_done']} steps")
    drift = max(abs(a - b) / abs(b) for a, b in
                zip(res["losses"], whole["losses"][10:]))
    if drift > M3_DRILL_LOSS:
        raise AssertionError(f"path M3: resumed losses {drift:.3g} from the "
                             f"uninterrupted run's")
    like_cpu = {"params": init_params(cfg, dtype=torch.float32, device=cpu)}
    like_cpu["opt"] = adamw_init(like_cpu["params"], AdamWConfig(lr=1e-3))
    on_cpu = ckpt.restore(root, like_cpu)
    final = {"params": res["params"], "opt": res["opt_state"]}
    if not all(torch.equal(a, b.cpu()) for a, b in
               zip(flat(on_cpu), flat(final))):
        raise AssertionError("path M3: the card's checkpoint read on the CPU "
                             "differs from the card's state")
    shutil.rmtree(root)
    log(f"[16 path M3] checkpoint drill, reduced {c['drill']} on the card: "
        f"failure at step {c['drill_fail']}, latest_step {last}, the "
        f"restored state bit-equal to the one saved, resumed to "
        f"{res['steps_done']}; its losses within {drift:.3g} (relative, <= "
        f"{M3_DRILL_LOSS}) of an uninterrupted run's; the final checkpoint "
        f"read on the CPU bit-equal to the card's state")
    # reduced llama3.2-3b's int8 decode, card against CPU
    cfg = reduced_config(c["small"][0])
    tree_np = params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(7), dtype=torch.float32,
        device=cpu))
    tok = np.random.default_rng(8).integers(
        0, cfg.vocab, (2, c["int8_steps"])).astype(np.int32)
    notes = []
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        outs = []
        for d in (dev, cpu):
            m = build_model(cfg, compute_dtype=dt, kv_int8=True, device=d)
            p = params_from_numpy(tree_np, cfg, device=d, dtype=dt)
            caches = init_caches(cfg, 2, 16, dtype=dt, kv_int8=True,
                                 device=d)
            logits = []
            for t in range(c["int8_steps"]):
                lg, _ = m.decode_step(
                    p, caches, torch.as_tensor(tok[:, t:t + 1], device=d),
                    torch.full((2,), t, dtype=torch.int32, device=d))
                logits.append(lg.cpu())
            outs.append((logits, {k: v.cpu() for k, v in caches.items()}))
        (lg_d, c_d), (lg_c, c_c) = outs
        err = max(map(_bf16_ulps, lg_d, lg_c))
        ok = err <= J4_BF16_ULPS
        quanta = max(int((c_d[k].int() - c_c[k].int()).abs().max())
                     for k in ("k", "v"))
        if not ok or quanta > 2:
            raise AssertionError(f"path M3: int8 decode {name} logits {err}, "
                                 f"payload {quanta} quanta apart")
        share = sum(int((c_d[k] != c_c[k]).sum()) for k in ("k", "v")) / sum(
            c_c[k][:, :, :c["int8_steps"]].numel() for k in ("k", "v"))
        notes.append(f"{name} logits {err:.3g} bf16 ulps, payloads within "
                     f"{quanta} quanta ({share:.4f} of the written entries "
                     f"differ)")
    log(f"[16 path M3] {cfg.name} int8 decode, {c['int8_steps']} "
        f"steps card against CPU: " + "; ".join(notes))


def path_m(c=PATH_M, device="cuda"):
    """Phase 16: M1-M3.  The path's launch counts are those of M2's
    training steps, counted from 0 just before them (the training path has
    no hand kernel).  Returns (launches, launches inside the steps,
    steps)."""
    import torch

    from repro_torch.kernels import ops as KO

    took = []
    t0 = time.perf_counter()
    path_m1(c, device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    took.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    counts_reset()
    steps = path_m2(c, device)
    launches, in_steps = counts_read("M")
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    took.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    path_m3(c, device)
    took.append(time.perf_counter() - t0)
    log(f"[16 path M] M1 {took[0]:.1f}s, M2 {took[1]:.1f}s, M3 "
        f"{took[2]:.1f}s")
    return {k: launches.get(k, 0) for k in KO.LAUNCHES}, in_steps, steps


# ---------------------------------------------------------------------------
# path N: the sharding slice (ZeRO-3 + tensor parallel over a Mesh)
# ---------------------------------------------------------------------------

PATH_N = dict(arch="llama3.2-3b", seed=0, serve_mesh=(1, 4), batch_size=8,
              max_seq=512, requests=24, burst=6, ticks=24, logit_ticks=6,
              train_mesh=(2, 2), batch=2, seq_len=1024, lr=1e-3,
              state_dtype="int8", steps=2,
              small=("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-780m",
                     "jamba-1.5-large-398b", "whisper-base",
                     "llama-3.2-vision-11b"),
              spawn_timeout=900)
# N1's bound: the sharded decode's logits against the one-rank engine's in
# bf16 ulps of the largest (J2's bound): the ranks add the row-parallel
# partial sums and the spread softmax in another order.
N1_ULPS = 16
# N2's bounds against the one-rank step on the same parameters and batch.
N2_LOSS_REL, N2_GNORM_REL = 1e-3, 1e-2
# N3's bounds, the CPU tests' (tests/test_torch_sharded_model.py): f32, the
# loss within 1e-6 relative and the gradient norm within 1e-5, each leaf's
# change in one AdamW step within 1e-2 of the CPU's change in norm (the
# first step moves every element by about lr whatever its gradient, so the
# parameters after it would hide a skipped or misscaled update); the
# logits, card against CPU, within J4's f32 bound
# (tests/test_torch_models.py's, 5e-5 absolute): cuBLAS and the CPU's BLAS
# round apart at every layer (the VLM's decode logits came 1.07e-5 of the
# largest apart on an H100).
N3_LOSS_REL, N3_DELTA_REL = 1e-6, 1e-2
N3_GNORM_REL = 1e-5


def _mesh_counts(mesh, what="counts"):
    return {f"{k}[{','.join(a)}]": n
            for (k, a), n in sorted(getattr(mesh, what).items())}


def n1_rank(mesh, c, dtree):
    """One rank of N1: the one-rank tree drawn from the seed (rank 0 runs
    the one-rank engine on it first), carried onto the mesh with
    `elastic.reshard_state`, and the sharded engine's run on the
    launcher's workload; the first `logit_ticks` decode steps' logits
    gathered whole."""
    import torch

    from repro_torch.distributed.sharding import (P, ShardingRules,
                                                  gather_full, tp_only_params)
    from repro_torch.kernels import ops as KO
    from repro_torch.launch.serve import workload
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.train.elastic import reshard_state, shardings_for

    dev = mesh.device
    cfg = _n_config(c)
    ecfg = EngineConfig(batch_size=c["batch_size"], max_seq=c["max_seq"])
    full = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(c["seed"]))
    out = {"transport": mesh.transport}

    def logged(eng, gather):
        stream, caps, step_s = [], [], []
        tick, dec = eng.scheduler.tick, eng._decode

        def t(arrivals, n_dispatch):
            d = tick(arrivals, n_dispatch=n_dispatch)
            stream.append([r.uid for r in d])
            return d

        def d(p, caches, tokens, lengths):
            _sync(dev)
            t0 = time.perf_counter()
            lg, caches = dec(p, caches, tokens, lengths)
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
            if len(caps) < c["logit_ticks"]:
                caps.append(gather(lg).float().cpu())
                if len(caps) == c["logit_ticks"]:
                    mesh.reset_counts()  # the steps after the captures
            return lg, caches

        eng.scheduler.tick, eng._decode = t, d
        return stream, caps, step_s

    if mesh.rank == 0:
        one = ServeEngine(cfg, full, ecfg, device=dev, seed=0, tree=dtree)
        stream, caps, step_s = logged(one, lambda lg: lg)
        t0 = time.perf_counter()
        res = one.run(workload(c["requests"], c["burst"]),
                      max_steps=c["ticks"])
        out["one"] = {"stream": stream, "logits": caps, "outputs":
                      one.outputs, "completed": res["completed"],
                      "wall_s": time.perf_counter() - t0,
                      "ticks": len(step_s), "step_s": step_s}
        del one
    eng = ServeEngine(cfg, None, ecfg, mesh=mesh,
                      rules=tp_only_params(ShardingRules()), seed=0,
                      tree=dtree)
    eng.params = reshard_state(full, shardings_for(mesh, eng.model.specs))
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stream, caps, step_s = logged(
        eng, lambda lg: gather_full(lg, mesh, P(None, "model")))
    KO.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(workload(c["requests"], c["burst"]), max_steps=c["ticks"])
    _sync(dev)
    out |= {"stream": stream, "logits": caps, "outputs": eng.outputs,
            "completed": res["completed"], "ticks": len(step_s),
            "wall_s": time.perf_counter() - t0, "step_s": step_s,
            "counts": _mesh_counts(mesh), "bytes": _mesh_counts(mesh, "bytes"),
            "counted_steps": len(step_s) - c["logit_ticks"],
            "launches": dict(KO.LAUNCHES),
            "peak": _peak(dev)}
    return out


def path_n1(tree, c=PATH_N, device="cuda"):
    """N1: sharded serving at full width.  Returns the ranks' launches
    (summed) and the ticks run."""
    import numpy as np
    import torch

    from repro_torch.distributed import spawn

    t0 = time.perf_counter()
    ranks = spawn(n1_rank, c["serve_mesh"], ("data", "model"), device=device,
                  backend="gloo", args=(c, tree), timeout=c["spawn_timeout"])
    wall = time.perf_counter() - t0
    one = ranks[0]["one"]
    for r, g in enumerate(ranks):
        if g["stream"] != one["stream"]:
            raise AssertionError(f"path N1: rank {r}'s dispatch stream is not "
                                 f"the one-rank engine's")
        if g["completed"] < 1 or g["outputs"] != ranks[0]["outputs"]:
            raise AssertionError(f"path N1: rank {r}'s outputs differ from "
                                 f"rank 0's")
    got, want = ranks[0]["logits"], one["logits"]
    compared, worst = 0, 0.0
    for t, (a, b) in enumerate(zip(got, want)):
        if not np.isfinite(a).all():
            raise AssertionError(f"path N1: logits not finite at tick {t}")
        worst = max(worst, _bf16_ulps(torch.as_tensor(a), torch.as_tensor(b)))
        compared += 1
        if not np.array_equal(a.argmax(-1), b.argmax(-1)):
            break  # the engines' inputs part here
    if worst > N1_ULPS:
        raise AssertionError(f"path N1: decode logits {worst:.2f} bf16 ulps "
                             f"from the one-rank engine's (bound {N1_ULPS})")
    agree = total = 0
    for uid, toks in one["outputs"].items():
        mine = ranks[0]["outputs"].get(uid, [])
        total += len(toks)
        agree += sum(a == b for a, b in zip(toks, mine))
    steps = ranks[0]["counted_steps"]
    per = {k: n / steps for k, n in ranks[0]["counts"].items()}
    per_b = {k: n / steps for k, n in ranks[0]["bytes"].items()}
    med = float(np.median(ranks[0]["step_s"][c["logit_ticks"]:])) * 1e3
    med1 = float(np.median(one["step_s"])) * 1e3
    where = "one card" if torch.device(device).type == "cuda" else "the CPU"
    log(f"[17 path N1] {c['arch']} bf16 on a {c['serve_mesh']} (data, "
        f"model) mesh of {len(ranks)} rank processes on {where}, "
        f"{ranks[0]['transport']}, tp_only_params: {one['completed']} and "
        f"{ranks[0]['completed']} requests completed in {one['ticks']} and "
        f"{ranks[0]['ticks']} ticks (at most {c['ticks']}) by the one-rank "
        f"and the sharded engine, every rank's dispatch "
        f"stream equal to the one-rank engine's "
        f"({sum(map(len, one['stream']))} dispatches); decode logits of "
        f"the first {compared} ticks within {worst:.2f} bf16 ulps of the "
        f"largest (bound {N1_ULPS}); greedy tokens agreeing {agree} of "
        f"{total} | sharded: {ranks[0]['wall_s'] * 1e3 / ranks[0]['ticks']:.1f}"
        f" ms a tick, decode step {med:.1f} ms median (one-rank: "
        f"{one['wall_s'] * 1e3 / one['ticks']:.1f} ms a tick, decode step "
        f"{med1:.2f} ms); peak allocated a rank "
        f"{max(g['peak'] for g in ranks):,} bytes; wall {wall:.1f}s")
    log("[17 path N1] collectives a decode step (rank 0, over "
        f"{steps} steps): " + "; ".join(
            f"{k} x{n:.1f} ({per_b[k]:,.0f} bytes)" for k, n in per.items()))
    launches = {k: sum(g["launches"].get(k, 0) for g in ranks)
                for k in ranks[0]["launches"]}
    return launches, ranks[0]["ticks"]


def n2_rank(mesh, c):
    """One rank of N2: llama3.2-3b's training state drawn from the seed,
    this rank's blocks kept (ZeRO-3 + TP), M2's batch's rows, `steps`
    train steps timed."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.loader import place
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.params import init_params
    from repro_torch.train.elastic import shardings_for
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import batch_spec_tree, make_train_step

    dev = mesh.device
    cfg = _n_config(c)
    opt_cfg = AdamWConfig(lr=c["lr"], state_dtype=c["state_dtype"])
    step, model = make_train_step(cfg, mesh, opt_cfg, remat=True, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        c["seed"]), dtype=torch.float32, device=dev,
        model_axis=model.model_axis_size, mesh=mesh, specs=model.specs)
    opt = adamw_init(params, opt_cfg, mesh, model.specs)
    data = SyntheticLMDataset(cfg.vocab, seq_len=c["seq_len"],
                              fixed_map=True, seed=c["seed"])
    batch = place(data.batch(0, c["batch"]), shardings_for(
        mesh, batch_spec_tree(cfg, ShapeConfig(
            "n2", c["seq_len"], c["batch"], "train"), model.rules, mesh)))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "gnorms": [], "ms": [], "counts": [], "bytes": []}
    for _ in range(c["steps"]):
        mesh.reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        _sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["grad_norm"]))
        out["counts"].append(_mesh_counts(mesh))
        out["bytes"].append(_mesh_counts(mesh, "bytes"))
    out["peak"] = _peak(dev)
    out["local_bytes"] = sum(t.numel() * t.element_size()
                             for t in _tensors((params, opt)))
    return out


def _free(dev):
    """Drop what the parent no longer holds from the card's cache, so the
    rank processes find the memory."""
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _n_config(c):
    from repro_torch.configs.registry import get_config, reduced_config

    return (reduced_config if c.get("reduced") else get_config)(c["arch"])


def _peak(dev):
    import torch

    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def path_n2(c=PATH_N, device="cuda"):
    """N2: sharded training at full width against the one-rank step."""
    import torch

    import repro_torch.train.steps as TS
    from repro_torch.data.loader import to_device
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed import spawn
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    dev = torch.device(device)
    cfg = _n_config(c)
    t0 = time.perf_counter()
    ranks = spawn(n2_rank, c["train_mesh"], ("data", "model"), device=device,
                  backend="gloo", args=(c,), timeout=c["spawn_timeout"])
    wall = time.perf_counter() - t0
    # the one-rank step after the ranks have gone: the card holds one or
    # the other (about 40 GB here, 43 GB for the four ranks)
    opt_cfg = AdamWConfig(lr=c["lr"], state_dtype=c["state_dtype"])
    step, _ = TS.make_train_step(cfg, None, opt_cfg, remat=True, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        c["seed"]), dtype=torch.float32, device=dev)
    opt = adamw_init(params, opt_cfg)
    data = SyntheticLMDataset(cfg.vocab, seq_len=c["seq_len"],
                              fixed_map=True, seed=c["seed"])
    params, opt, m = step(params, opt,
                          to_device(data.batch(0, c["batch"]), dev))
    ref_loss, ref_gnorm = float(m["loss"]), float(m["grad_norm"])
    del step, params, opt, m
    _free(dev)
    losses, gnorms = ranks[0]["losses"], ranks[0]["gnorms"]
    for r, g in enumerate(ranks):
        if g["losses"] != losses:
            raise AssertionError(f"path N2: rank {r}'s losses {g['losses']} "
                                 f"are not rank 0's {losses}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"path N2: losses {losses} not finite or not "
                             f"falling")
    if abs(losses[0] - ref_loss) > N2_LOSS_REL * abs(ref_loss):
        raise AssertionError(f"path N2: first loss {losses[0]} against the "
                             f"one-rank step's {ref_loss}")
    if abs(gnorms[0] - ref_gnorm) > N2_GNORM_REL * abs(ref_gnorm):
        raise AssertionError(f"path N2: gradient norm {gnorms[0]} against "
                             f"the one-rank step's {ref_gnorm}")
    last = ranks[0]["bytes"][-1]
    where = "one card" if dev.type == "cuda" else "the CPU"
    log(f"[17 path N2] {c['arch']} trained on a {c['train_mesh']} (data, "
        f"model) mesh of {len(ranks)} rank processes on {where} over gloo, "
        f"ZeRO-3 + TP, batch {c['batch']} x {c['seq_len']}, f32 masters, "
        f"bf16 compute, remat, AdamW lr {c['lr']} with {c['state_dtype']} "
        f"first moments: losses {', '.join(f'{x:.6f}' for x in losses)} "
        f"(one-rank first step {ref_loss:.6f}, relative "
        f"{abs(losses[0] - ref_loss) / ref_loss:.2e}); global gradient norm "
        f"{gnorms[0]:.6f} (one-rank {ref_gnorm:.6f}, relative "
        f"{abs(gnorms[0] - ref_gnorm) / ref_gnorm:.2e}) | ms a step "
        f"{', '.join(f'{x:.1f}' for x in ranks[0]['ms'])}; peak allocated "
        f"a rank {', '.join(f'{g['peak']:,}' for g in ranks)} bytes "
        f"(training state a rank {ranks[0]['local_bytes']:,} bytes); "
        f"collective payload bytes a step (rank 0) "
        f"{sum(last.values()):,}; wall {wall:.1f}s")
    log("[17 path N2] collectives of the last step (rank 0): " + "; ".join(
        f"{k} x{n} ({last[k]:,} bytes)"
        for k, n in ranks[0]["counts"][-1].items()))
    return c["steps"]


def _n3_tree(arch, seed=1):
    """The reduced f32 init tree of `arch` (the port's, from a seeded CPU
    generator) with norms, biases and gates redrawn nonzero, as numpy."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.params import init_params, leaves

    params = init_params(reduced_config(arch), torch.Generator().manual_seed(
        seed), torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    tree = {}
    for path, a in leaves(params):
        name = path.split("/")[-1]
        a = a.numpy()
        if name.startswith(("b", "norm", "final_norm")) or name in (
                "conv_b", "dt_bias", "gate"):
            a = ((1.0 if name == "gate" else 0.1)
                 * rng.standard_normal(a.shape)).astype(np.float32)
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def _n3_batch(arch, B=2, seed=1):
    import numpy as np

    from repro_torch.configs.registry import reduced_config

    cfg = reduced_config(arch)
    rng = np.random.default_rng(seed)
    S = 2 * cfg.ssm.chunk if cfg.ssm else 16
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def n3_rank(mesh, c, ckpt_dir):
    """One rank of N3 (on the card or the CPU): for each reduced family in
    f32 on the (2, 2) mesh, `train_logits` (logits and loss gathered), one
    decode step (logits gathered) and one train step (its loss, gradient
    norm and each leaf's change, gathered); then the first
    family's state after the step saved from the mesh and restored on
    rank 0 alone (a one-rank `sub_mesh`), bit-equal to the gathered live
    state."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.mesh import sub_mesh
    from repro_torch.distributed.sharding import (P, gather_full, gather_tree,
                                                  is_sharding, local_shard,
                                                  spec_map)
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import (reshard_state, resume_on_new_mesh,
                                           shardings_for)
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import (batch_spec_tree, make_train_step,
                                         training_state_shardings)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    opt_cfg = AdamWConfig(lr=1e-3, state_dtype="int8")
    out = {}
    for i, arch in enumerate(c["small"]):
        cfg = reduced_config(arch)
        step, model = make_train_step(cfg, mesh, opt_cfg, device=dev,
                                      compute_dtype=torch.float32)
        bx = model._bx
        full = params_from_numpy(_n3_tree(arch), cfg, device=dev,
                                 dtype=torch.float32)
        params = reshard_state(full, shardings_for(mesh, model.specs))
        batch = {k: local_shard(torch.as_tensor(v, device=dev), mesh,
                                P(bx)).clone()
                 for k, v in _n3_batch(arch).items()}
        with torch.no_grad():
            logits, aux = model.train_logits(params, batch)
            loss = model.loss(logits, batch["labels"])
        res = {"logits": gather_full(logits, mesh, P(bx, None,
                                                      model.vocab_axes)),
               "loss": float(loss)}
        sm = build_model(cfg, mesh, compute_dtype=torch.float32, device=dev)
        B, S = 4, 16
        specs = batch_spec_tree(cfg, ShapeConfig("n3", S, B, "decode"),
                                sm.rules, mesh)
        caches = init_caches(cfg, B, S, dtype=torch.float32, mesh=mesh,
                             specs=specs["caches"])
        rows = local_shard(torch.arange(B), mesh, specs["lengths"])
        tok = (torch.arange(B, device=dev) * 7 + 3).to(torch.int32)[:, None]
        lengths = (torch.arange(B, device=dev) % 3).to(torch.int32)
        with torch.no_grad():
            lg, _ = sm.decode_step(params, caches, tok[rows], lengths[rows])
        res["decode"] = gather_full(lg, mesh, P(bx, sm.vocab_axes))
        # the train step after the decode: both read the same parameters
        # on the card and on the CPU
        opt = adamw_init(params, opt_cfg, mesh, model.specs)
        params, opt, m = step(params, opt, batch)
        res |= {"step_loss": float(m["loss"]),
                "gnorm": float(m["grad_norm"]),
                "delta": spec_map(lambda a, b: a - b, gather_tree(
                    params, mesh, model.specs), full,
                    is_leaf=lambda x: isinstance(x, torch.Tensor))}
        if i == 0:  # the checkpoint drill
            p_sh, o_sh = training_state_shardings(cfg, mesh, opt_cfg, params,
                                                  model.specs)
            sh = {"params": p_sh, "opt": o_sh}
            spec = spec_map(lambda x: x.spec, sh, is_leaf=is_sharding)
            ckpt.save(ckpt_dir, 1, {"params": params, "opt": opt},
                      shardings=sh)
            live = gather_tree({"params": params, "opt": opt}, mesh, spec)
            one = sub_mesh((1, 1), ("data", "model"), device=dev)
            if one is not None:
                back = resume_on_new_mesh(ckpt_dir, {"params": params,
                                                     "opt": opt}, one, spec)
                same = spec_map(lambda s, a, b: (a.dtype == b.dtype
                                                 and torch.equal(a, b)),
                                spec, back, live)
                flat = []
                spec_map(lambda s, x: flat.append(x), spec, same)
                res["ckpt"] = (sum(flat), len(flat))
        out[arch] = res
    return out if mesh.rank == 0 else None


def path_n3(c=PATH_N, device="cuda"):
    """N3: the reduced families on a (2, 2) mesh of ranks on the card
    against the same ranks on the CPU."""
    import shutil

    import numpy as np

    from repro_torch.distributed import spawn

    got = {}
    t0 = time.perf_counter()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    for where in (device, "cpu"):
        d = TRACE_DIR / f"N3_ckpt_{torch_device_type(where)}"
        shutil.rmtree(d, ignore_errors=True)
        got[where] = spawn(n3_rank, c["train_mesh"], ("data", "model"),
                           device=where, backend="gloo", args=(c, str(d)),
                           timeout=c["spawn_timeout"])[0]
        shutil.rmtree(d, ignore_errors=True)
    card, cpu = got[device], got["cpu"]
    worst = {}
    for arch in c["small"]:
        a, b = card[arch], cpu[arch]
        for k in ("loss", "step_loss", "gnorm"):
            if abs(a[k] - b[k]) > abs(b[k]) * (
                    N3_GNORM_REL if k == "gnorm" else N3_LOSS_REL):
                raise AssertionError(f"path N3 {arch}: {k} {a[k]} on the "
                                     f"card, {b[k]} on the CPU")
        for k in ("logits", "decode"):
            e = float(np.abs(a[k] - b[k]).max())
            if e > J4_F32["logits"]:
                raise AssertionError(f"path N3 {arch}: {k} {e:.2e} apart "
                                     f"(bound {J4_F32['logits']})")
            worst[k] = max(worst.get(k, (0.0, 0.0)),
                           (e, e / float(np.abs(b[k]).max())))
        for path, dw in _flat_leaves(b["delta"]):
            dg = _flat_leaves(a["delta"], path)
            if path.endswith("cross/bk"):
                # a key bias shifts each query's scores alike: its gradient
                # is rounding noise, and AdamW steps it by at most
                # lr (1 + weight decay x |w|) either way
                if max(np.abs(dg).max(), np.abs(dw).max()) > 2 * c["lr"]:
                    raise AssertionError(f"path N3 {arch}: {path} moved "
                                         f"more than 2 x lr")
                continue
            e = float(np.linalg.norm(dg - dw) / np.linalg.norm(dw))
            if not e <= N3_DELTA_REL:
                raise AssertionError(f"path N3 {arch}: {path}'s change in "
                                     f"the step {e:.2e} of the CPU's apart "
                                     f"(bound {N3_DELTA_REL})")
            worst["delta"] = max(worst.get("delta", (0.0, "")), (e, path))
    for where, res in got.items():
        n_same, n = res[c["small"][0]]["ckpt"]
        if n_same != n:
            raise AssertionError(f"path N3 ({where}): {n - n_same} of {n} "
                                 f"checkpoint leaves restored unequal")
    log(f"[17 path N3] {len(c['small'])} reduced families on a "
        f"{c['train_mesh']} (data, model) mesh, ranks on the card against "
        f"ranks on the CPU (f32, TF32 off): loss within {N3_LOSS_REL} "
        f"relative, logits {worst['logits'][0]:.2e} ({worst['logits'][1]:.2e}"
        f" of the largest) and decode logits {worst['decode'][0]:.2e} "
        f"({worst['decode'][1]:.2e}) apart (bound {J4_F32['logits']}), "
        f"each leaf's change in one int8-moment AdamW step within "
        f"{worst['delta'][0]:.2e} of the CPU's in norm ({worst['delta'][1]};"
        f" bound {N3_DELTA_REL}); {c['small'][0]}'s (2, 2) checkpoint restored on one rank "
        f"bit-equal to the gathered live state on both "
        f"({card[c['small'][0]]['ckpt'][1]} leaves); "
        f"{time.perf_counter() - t0:.1f}s")


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def _flat_leaves(tree, want=None, prefix=""):
    """(path, array) leaves of a nested dict, or the leaf at `want`."""
    out = []
    for k in sorted(tree):
        v, p = tree[k], f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out += _flat_leaves(v, None, p)
        else:
            out.append((p, v))
    return dict(out)[want] if want is not None else out


def path_n(tree, c=PATH_N, device="cuda"):
    """Phase 17: N1-N3.  The path's launch counts are those of N1's rank
    processes' sharded engine runs, each counted from 0 just before it.
    Returns (launches, launches inside the engine runs, ticks)."""
    import torch

    from repro_torch.kernels import ops as KO

    took = []
    dev = torch.device(device)
    _free(dev)
    if dev.type == "cuda":
        log(f"[17 path N] this process holds "
            f"{torch.cuda.memory_allocated():,} bytes allocated, "
            f"{torch.cuda.memory_reserved():,} reserved on the card")
    t0 = time.perf_counter()
    launches, ticks = path_n1(tree, c, device)
    missing = [k for k in PATH_KERNELS["N"] if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"path N: kernels {missing} never launched in "
                             f"the sharded engine runs")
    took.append(time.perf_counter() - t0)
    _free(dev)
    t0 = time.perf_counter()
    path_n2(c, device)
    took.append(time.perf_counter() - t0)
    _free(dev)
    t0 = time.perf_counter()
    path_n3(c, device)
    took.append(time.perf_counter() - t0)
    log(f"[17 path N] N1 {took[0]:.1f}s, N2 {took[1]:.1f}s, N3 "
        f"{took[2]:.1f}s")
    counts = {k: launches.get(k, 0) for k in KO.LAUNCHES}
    return counts, counts, ticks


# ---------------------------------------------------------------------------
# path O: the four examples at their own sizes
# ---------------------------------------------------------------------------

# The examples (`repro_torch.examples`) at the sizes examples/*.py run:
# quickstart (16 shards x 4096, 2 x 12 steps of 64 lanes), sssp
# (`random_graph(n=512)`, three fixed schedules at m = 32 and the adaptive
# engine at m = 16), serve_demo (reduced llama3.2-3b, 4 slots, max_seq 64,
# 24 requests) and train_demo (`CFG_100M`, 12 layers x 768, batch 8 x 256,
# bf16 moments, a checkpoint every 25 steps, restarted at the halfway
# step).  The draws of the CPU reruns are made on the host first, so both
# runs take the same ones.
PATH_O = dict(draw_steps=512, draw_seed=31, serve_seed=37, train_steps=200,
              train_batch=8, logit_steps=4, o4_timed=5)


def _o_log(tag):
    return lambda msg: log(f"[18 path {tag}] {msg}")


def path_o1(tree, c=PATH_O, device="cuda"):
    """O1: quickstart on the card and on the CPU with the same draws: the
    carry (`carry_fingerprint`), the drained keys and the transitions
    bit-identical.  The card run's launches go to WINDOW_LAUNCHES.
    Returns its steps."""
    import torch

    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.core.smartpq import SmartPQConfig, carry_fingerprint
    from repro_torch.examples import quickstart

    steps = 2 * quickstart.STEPS
    draws = SCH.step_draws(SmartPQConfig().mode_schedules, 16,
                           quickstart.B, 256, steps=steps,
                           generator=torch.Generator().manual_seed(
                               c["draw_seed"]))
    card, _ = _run_counted(torch.device(device), lambda: quickstart.quickstart(
        device=device, draws=draws, tree=tree, log=_o_log("O1 quickstart")))
    cpu = quickstart.quickstart(device="cpu", draws=draws, tree=tree,
                                log=lambda msg: None)
    got = (carry_fingerprint(card["carry"]), card["drained"],
           card["transitions"], card["inserted"])
    if got != (carry_fingerprint(cpu["carry"]), cpu["drained"],
               cpu["transitions"], cpu["inserted"]):
        raise AssertionError("path O1: quickstart differs between the card "
                             "and the CPU")
    log(f"[18 path O1] quickstart rerun on the CPU with the same draws: "
        f"carry {got[0]:#010x}, {len(card['drained'])} drained keys and "
        f"{card['transitions']} transitions bit-identical")
    return steps


def path_o2(c=PATH_O, device="cuda"):
    """O2: sssp on the card and on the CPU with the same draws: every
    run's `SSSPResult` (distances, steps, pops, wasted pops, modes,
    transitions) bit-identical.  The card runs' launches go to
    WINDOW_LAUNCHES.  Returns their steps."""
    import torch

    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.core.smartpq import SmartPQConfig
    from repro_torch.examples import sssp

    # each fixed relaxed schedule's draws (m = 32) and the adaptive
    # engine's (B = 16 * 8 + 16), from a CPU generator
    gen = torch.Generator().manual_seed(c["draw_seed"])
    draws = {name: SCH.step_draws((sched,), 8, 32, 256,
                                  steps=c["draw_steps"], generator=gen)
             for name, sched in sssp.FIXED}
    draws[sssp.ADAPTIVE] = SCH.step_draws(
        SmartPQConfig().mode_schedules, 8, 16 * 8 + 16, 256,
        steps=c["draw_steps"], generator=gen)
    card, _ = _run_counted(torch.device(device), lambda: sssp.sssp_demo(
        device=device, draws=draws, log=_o_log("O2 sssp")))
    cpu = sssp.sssp_demo(device="cpu", draws=draws, log=lambda msg: None)
    for name, r in card["runs"].items():
        for f, a in r._asdict().items():
            b = getattr(cpu["runs"][name], f)
            if hasattr(a, "dtype"):
                _same_arrays(f"path O2 {name} {f}", a, b)
            elif a != b:
                raise AssertionError(f"path O2 {name}: {f} {a} on the card, "
                                     f"{b} on the CPU")
    log(f"[18 path O2] sssp rerun on the CPU with the same draws: "
        f"{len(card['runs'])} runs' results bit-identical")
    return sum(r.steps for r in card["runs"].values())


def path_o3(tree, c=PATH_O, device="cuda"):
    """O3: serve_demo as the example runs it (bf16, parameters from a CPU
    generator seeded 0) on the card; in f32 (TF32 off) on the card and on
    the CPU with the same parameters and scheduler draws: the mode trace,
    the completion steps and the tokens equal; and the bf16 model's
    prefill and teacher-forced decode logits card against CPU within
    `J4_BF16_ULPS`, as path J4 holds them.  The bf16 run's launches go to
    WINDOW_LAUNCHES (the f32 card run is a check, not counted).  Returns
    its engine steps."""
    import torch

    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.examples import serve_demo
    from repro_torch.models.io import init_caches
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import build_model

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("path O3: TF32 matmuls are on")
    cfg = reduced_config(serve_demo.ARCH)
    tree_np = params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.float32,
        device="cpu"))
    draws = serve_draws(401, c["serve_seed"])
    params = params_from_numpy(tree_np, cfg, device=device)
    run, _ = _run_counted(torch.device(device), lambda: serve_demo.serve_demo(
        device=device, tree=tree, draws=draws, log=_o_log("O3 serve_demo"),
        params=params))
    runs = []
    with f32_models():
        for d, say in ((device, _o_log("O3 serve_demo f32")),
                       ("cpu", lambda msg: None)):
            runs.append(serve_demo.serve_demo(
                device=d, tree=tree, draws=draws, log=say,
                params=params_from_numpy(tree_np, cfg, device=d,
                                         dtype=torch.float32)))
    (g, gs), (h, hs) = ((r["engine"], r["summary"]) for r in runs)
    if (gs["mode_trace"] != hs["mode_trace"] or g.done_step != h.done_step
            or g.outputs != h.outputs):
        raise AssertionError("path O3: serve_demo in f32 differs between "
                             "the card and the CPU")
    tok = torch.as_tensor(list(range(3, 3 + 8)), dtype=torch.int32)[None]
    logits = []
    for d in (device, "cpu"):
        model = build_model(cfg, remat=False, device=d)
        p = params_from_numpy(tree_np, cfg, device=d)
        t = tok.to(d)
        out = [model.prefill(p, {"tokens": t})[0]]
        caches = init_caches(cfg, 1, 16, device=d)
        for i in range(c["logit_steps"]):
            lg, caches = model.decode_step(
                p, caches, t[:, i:i + 1],
                torch.full((1,), i, dtype=torch.int32, device=d))
            out.append(lg)
        logits.append([x.cpu() for x in out])
    ulps = max(map(_bf16_ulps, *logits))
    if ulps > J4_BF16_ULPS:
        raise AssertionError(f"path O3: bf16 logits {ulps:.2f} ulps apart "
                             f"(<= {J4_BF16_ULPS})")
    log(f"[18 path O3] serve_demo in f32 rerun on the CPU: mode trace, "
        f"{len(g.done_step)} completion steps and tokens equal; bf16 "
        f"prefill and {c['logit_steps']} decode steps card against CPU "
        f"{ulps:.2f} ulps (<= {J4_BF16_ULPS})")
    return run["summary"]["steps"]


def path_o4(c=PATH_O, device="cuda"):
    """O4: train_demo on the card: `c["train_steps"]` steps at batch
    `c["train_batch"]`, the restart resuming at the last checkpoint of the
    first half, the losses falling.  Its wall time is split by the loop's
    own clocks (steps, checkpoint saves, the restore; the rest is set-up);
    then `c["o4_timed"]` more steps of the trained state are timed between
    CUDA events and one is profiled by range (`profile_train_step`)."""
    import statistics

    import torch

    import repro_torch.train.steps as TS
    from repro_torch.data.loader import to_device
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.examples import train_demo
    from repro_torch.models.params import leaves

    steps, dev = c["train_steps"], torch.device(device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_demo.train_demo(steps=steps, batch=c["train_batch"],
                                device=device, log=_o_log("O4 train_demo"))
    wall = time.perf_counter() - t0
    want = steps // 2 // train_demo.CKPT_EVERY * train_demo.CKPT_EVERY
    one, two = res["phase1"], res["phase2"]
    if two["resumed_from"] != want:
        raise AssertionError(f"path O4: resumed from {two['resumed_from']}, "
                             f"not {want}")
    step_s, ckpt_s = one["step_s"] + two["step_s"], one["ckpt_s"] + two[
        "ckpt_s"]
    params, opt = two["params"], two["opt_state"]
    state_bytes = _bytes(params) + _bytes(opt.m) + _bytes(opt.v)
    log(f"[18 path O4] {steps} steps in {wall:.1f}s with the restart, "
        f"resumed from step {want}, mean loss {res['first']:.4f} -> "
        f"{res['last']:.4f}, peak allocated "
        f"{torch.cuda.max_memory_allocated():,} bytes")
    log(f"[18 path O4] by the loop's clocks: {len(step_s)} steps "
        f"{sum(step_s):.2f}s (median {statistics.median(step_s) * 1e3:.3f} "
        f"ms, each phase's first {one['step_s'][0] * 1e3:.1f} and "
        f"{two['step_s'][0] * 1e3:.1f} ms, max {max(step_s) * 1e3:.1f}); "
        f"{len(ckpt_s)} checkpoint saves of {state_bytes:,} bytes "
        f"{sum(ckpt_s):.2f}s ({min(ckpt_s):.3f}-{max(ckpt_s):.3f}s each); "
        f"the restore {two['restore_s']:.2f}s; set-up and the rest "
        f"{wall - sum(step_s) - sum(ckpt_s) - two['restore_s']:.2f}s")
    cfg = train_demo.CFG_100M
    step, model = TS.make_train_step(cfg, None, train_demo.OPT, remat=True,
                                     device=dev)
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=train_demo.SEQ_LEN,
                              seed=0, fixed_map=True)
    batch = to_device(data.batch(steps, c["train_batch"]), dev)
    params, opt, ms, _ = _timed_steps(step, params, opt, batch,
                                      c["o4_timed"], dev)
    params, opt, by = profile_train_step(step, model, params, opt, batch,
                                         "O4_train_step")
    N = sum(w.numel() for _, w in leaves(params))
    tokens = c["train_batch"] * train_demo.SEQ_LEN
    log(f"[18 path O4] {c['o4_timed']} more steps between CUDA events "
        f"{statistics.median(ms):.3f} ms median ({min(ms):.3f}-"
        f"{max(ms):.3f}); 6 N tokens {6 * N * tokens:.4g} FLOP at 989 "
        f"TFLOP/s {6 * N * tokens / H100_BF16_FLOPS * 1e3:.3f} ms; one "
        f"profiled step on the device by range {by_range_line(by)}")
    return steps


def path_o(tree, c=PATH_O, device="cuda"):
    """Phase 18: O1-O4.  The path's launch counts are those of the
    examples' own card runs (O1, O2 and O3's bf16 run, each counted just
    around it; an example's step or engine tick is a window of one step),
    not those of O3's f32 check or the CPU reruns; train_demo (O4) has no
    hand kernel, and its steps are not windows.  Returns (launches,
    launches inside the examples' runs, steps)."""
    from repro_torch.kernels import ops as KO

    took, steps = [], 0
    counts_reset()
    for part in (lambda: path_o1(tree, c, device), lambda: path_o2(c, device),
                 lambda: path_o3(tree, c, device)):
        t0 = time.perf_counter()
        steps += part()
        took.append(time.perf_counter() - t0)
    _, in_runs = counts_read("O")
    t0 = time.perf_counter()
    path_o4(c, device)
    took.append(time.perf_counter() - t0)
    launches = {k: in_runs.get(k, 0) for k in KO.LAUNCHES}
    log(f"[18 path O] O1 {took[0]:.1f}s, O2 {took[1]:.1f}s, O3 "
        f"{took[2]:.1f}s, O4 {took[3]:.1f}s")
    return launches, in_runs, steps


# ---------------------------------------------------------------------------
# path P: the dry run on the card
# ---------------------------------------------------------------------------

# Three cells of `launch/dryrun.py` traced on fake CUDA tensors over the
# abstract (16, 16) production mesh: a serving cell the reference's own
# check compiles (tests/device_scripts/dryrun_cell_check.py), the
# llama3.2-3b training cell whose attention runs replicated over 'model',
# and the SSM's long-context decode.
PATH_P = (dict(arch="gemma-2b", shape_name="decode_32k",
               serve_tp_only=True),
          dict(arch="llama3.2-3b", shape_name="train_4k"),
          dict(arch="mamba2-780m", shape_name="long_500k"))
P_DEVICE_FIELDS = ("device", "device_name", "device_memory_bytes",
                   "fits_device_memory", "trace_s")


def path_p(cells=PATH_P, device="cuda"):
    """Phase 19: each cell traced on the card (fake CUDA tensors) and on
    the CPU: the records equal but for the device fields, the fit judged
    against the card's `total_memory`, no kernel launched.  Returns
    (launches, launches inside the traces, cells)."""
    import torch

    from repro_torch.kernels import ops as KO
    from repro_torch.launch import dryrun

    counts_reset()
    total = torch.cuda.get_device_properties(torch.device(device)
                                             ).total_memory
    for cell in cells:
        card = dryrun.lower_cell(multi_pod=False, device=device, **cell)
        cpu = dryrun.lower_cell(multi_pod=False, device="cpu", **cell)
        same = {k: v for k, v in card.items() if k not in P_DEVICE_FIELDS}
        if same != {k: v for k, v in cpu.items()
                    if k not in P_DEVICE_FIELDS}:
            raise AssertionError(f"path P {cell}: the card's record differs "
                                 f"from the CPU's")
        peak = card["memory_per_device"]["peak_estimate_bytes"]
        if (card["status"] != "ok" or card["device_memory_bytes"] != total
                or card["fits_device_memory"] != (peak <= total)):
            raise AssertionError(f"path P {cell}: {card}")
        log(f"[19 path P] {cell['arch']} {cell['shape_name']}"
            f"{' serve_tp_only' if cell.get('serve_tp_only') else ''}: "
            f"trace {card['trace_s']}s on the card ({cpu['trace_s']}s on "
            f"the CPU), peak {peak / 2**30:.2f} GiB a device against "
            f"{card['device_name']}'s {total / 2**30:.2f} GiB ({total:,} "
            f"bytes) "
            f"({'fits' if card['fits_device_memory'] else 'over'}), "
            f"{card['flops_per_device']:.4e} dot FLOPs, collectives "
            f"{card['collective_bytes_by_op']}; the record equals the "
            f"CPU's but for {', '.join(P_DEVICE_FIELDS)}")
    launches = dict(KO.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"path P launched kernels: {launches}")
    return launches, {}, len(cells)


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
    t0 = time.perf_counter()
    path_i_counts = path_i()
    log(f"[12 path I] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_i_counts[0]} (inside its distributed calls and delegations "
        f"{path_i_counts[1]})")
    t0 = time.perf_counter()
    path_j_counts = path_j(tree)
    log(f"[13 path J] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_j_counts[0]} (inside its engine runs {path_j_counts[1]}, "
        f"{path_j_counts[2]} ticks)")
    t0 = time.perf_counter()
    path_k_counts = path_k(tree)
    log(f"[14 path K] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_k_counts[0]} (inside its engine runs {path_k_counts[1]}, "
        f"{path_k_counts[2]} ticks)")
    t0 = time.perf_counter()
    path_l_counts = path_l(tree)
    log(f"[15 path L] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_l_counts[0]} (inside its engine runs {path_l_counts[1]}, "
        f"{path_l_counts[2]} ticks)")
    t0 = time.perf_counter()
    path_m_counts = path_m()
    log(f"[16 path M] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_m_counts[0]} (inside its training steps "
        f"{path_m_counts[1]}, {path_m_counts[2]} steps)")
    t0 = time.perf_counter()
    path_n_counts = path_n(tree)
    log(f"[17 path N] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_n_counts[0]} (inside its sharded engine runs, "
        f"{path_n_counts[2]} ticks)")
    t0 = time.perf_counter()
    path_o_counts = path_o(tree)
    log(f"[18 path O] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_o_counts[0]} ({path_o_counts[2]} example steps)")
    t0 = time.perf_counter()
    path_p_counts = path_p()
    log(f"[19 path P] {time.perf_counter() - t0:.1f}s | launches "
        f"{path_p_counts[0]}")
    log(f"[20 done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps(kernels_line(records, {
        "A": path_a_counts, "B": path_b_counts, "C": path_c_counts,
        "D": path_d_counts, "E": path_e_counts, "F": path_f_counts,
        "G": path_g_counts, "H": path_h_counts, "I": path_i_counts,
        "J": path_j_counts, "K": path_k_counts, "L": path_l_counts,
        "M": path_m_counts, "N": path_n_counts, "O": path_o_counts,
        "P": path_p_counts},
        phase2, floor)))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
