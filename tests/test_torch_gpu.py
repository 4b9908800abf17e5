"""The port on the card: each CUDA kernel against its plain version, the
fused window on the card against the same window on the CPU, the model
path (reduced models of every family card against CPU, full-width llama3.2-3b
and whisper-base decodes, one full-width MoE layer), and the int8 KV cache
and training (reduced models' gradients, AdamW, the checkpoint drill and
the int8 decode card against CPU, a reduced training run, a full-width
int8 decode against bf16).

Every test here is marked `gpu` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import carry_to_numpy
from repro_torch.core.pqueue.schedules import (Schedule, spray_draws,
                                               step_draws)
from repro_torch.core.smartpq import SmartPQ, SmartPQConfig
from repro_torch.kernels import ops as KO
from repro_torch.kernels import ref as KR
from repro_torch.serve import (EngineConfig, OverloadConfig, Request,
                               ServeEngine, SmartPQScheduler)
from repro_torch.workloads import des, graphs, sssp, traces

INF_KEY = 2**31 - 1

# The JAX registry's validation shapes (src/repro/kernels/registry.py:481-557)
# and the shapes the fused window gives each kernel.
MERGE = [(4, 64, 16), (2, 256, 7), (6, 100, 60), (3, 8, 8), (16, 256, 64),
         # path C's step inserts (R = B = 57 and 22), then the prefill
         (16, 256, 57), (16, 256, 22), (16, 256, 4096),
         # the SSSP and DES steps (R = 256 fixed-schedule relax, 144
         # adaptive SSSP, 128 hold model), `traces.prefill`'s widest slice
         # and the last slice of a 1,048,576-event backlog
         (16, 256, 256), (16, 256, 144), (16, 256, 128), (16, 256, 32512),
         (16, 256, 8192),
         # a rank of the (2, 4) distributed queue (2 shards): its insert_dist
         # and its prefill slice
         (2, 256, 64), (2, 256, 32512)]
TOPK = [(8, 256, 16), (3, 100, 7), (1, 64, 64), (5, 1024, 128),
        (1, 1424, 64), (2, 512, 64), (1, 128, 64),
        # path C's lane widths B = 57 and 22 (SPRAY, HIER semifinal, final)
        (1, 1312, 57), (2, 456, 57), (1, 114, 57),
        (1, 752, 22), (2, 176, 22), (1, 44, 22),
        # the registry's tuning shapes; the widest run in registers (k' =
        # 256) and one too wide for them
        (16, 4096, 64), (1, 1024, 64), (1, 512, 64), (3, 1000, 200),
        (2, 2048, 300),
        # SSSP: fixed HIER at m = 32, the adaptive step at B = 144 (SPRAY,
        # HIER semifinal, final); the DES step at B = 128 (the same three,
        # and STRICT_FLAT)
        (2, 256, 32), (1, 64, 32), (1, 2704, 144), (2, 1152, 144),
        (1, 288, 144), (1, 2448, 128), (2, 1024, 128), (1, 256, 128),
        (1, 2048, 128),
        # a rank of the (2, 4) distributed queue: HIER's pod select over 4
        # ranks at m = 64, and the spray at 2 shards and m_loc = 8
        (1, 256, 64), (1, 24, 8)]
SORT = [(1, 16), (4, 64), (6, 37), (8, 128), (64, 64),
        # path C's op logs (Fig. 11 Table 3, Fig. 10 c_mix); rows of 32 and
        # 256 words, the narrowest and widest register runs, and of 33, the
        # first with two words a lane; a row count that leaves a block's
        # last warps idle; rows too wide for registers (the block body)
        (84, 57), (30, 22), (5, 32), (3, 256), (7, 33), (2, 1000),
        # the adaptive SSSP and DES steps' op logs, and the bursty DES
        # trace's window
        (1, 144), (1, 128), (54, 128),
        # the serving scheduler's tick and its K = 16 window (B = 64 lanes)
        (1, 64), (16, 64)]
TWOCHOICE = [(4, 16), (16, 64), (8, 5), (16, 57), (16, 22),
             # the warp with four rounds of deleter lanes, then more shards
             # than a warp has lanes: the block body
             (16, 128), (40, 100),
             # the adaptive SSSP step (B = 144)
             (16, 144),
             # a rank of the (2, 4) distributed queue (2 shards, m_loc = 8)
             (2, 8)]
MULTIQ = [(4, 16), (16, 64), (2, 8), (16, 57), (16, 22),
          # runs of 128 and 256 words in registers
          (4, 100), (3, 200),
          # the DES and adaptive SSSP steps
          (16, 128), (16, 144)]
MERGE_SORTED = [(4, 64, 16), (2, 256, 7), (1, 64, 1), (8, 1024, 128),
                # R = C; a buffer of 16384 words (128 KB of shared memory
                # in a run block); no run at all
                (2, 4096, 4096), (1, 16384, 4), (3, 512, 0)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _sorted_rows(rng, S, W):
    out = np.full((S, W), INF_KEY, np.int32)
    for s in range(S):
        n = rng.integers(0, W + 1)
        out[s, :n] = np.sort(rng.integers(0, 200, n))
    return out


def _check(name, args, plain, wrapper=None, **kw):
    before = KO.LAUNCHES[name]
    got = getattr(KO, wrapper or name)(*args, **kw)
    torch.cuda.synchronize()
    assert KO.LAUNCHES[name] == before + 1
    for g, w in zip(got, plain(*args, **kw)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("S,H,R", MERGE)
def test_windowed_merge_kernel_matches_plain(S, H, R):
    dev = _card()
    rng = np.random.default_rng(S * H + R)
    head_k, run_k = _sorted_rows(rng, S, H), _sorted_rows(rng, S, R)
    head_v = rng.integers(0, 1 << 20, (S, H)).astype(np.int32)
    run_v = rng.integers(0, 1 << 20, (S, R)).astype(np.int32)
    head_q = np.tile(np.arange(H, dtype=np.int32), (S, 1))
    run_q = 1000 + np.tile(np.arange(R, dtype=np.int32), (S, 1))
    args = [torch.as_tensor(a, device=dev) for a in
            (head_k, head_v, head_q, run_k, run_v, run_q)]
    _check("windowed_merge", args, KR.windowed_merge_ref)


def _merge_edge_rows(case, rng):
    """(head_k, run_k) of the rows at the edges of the rank merge."""
    if case == "head_all_inf":
        return np.full((4, 256), INF_KEY, np.int32), _sorted_rows(rng, 4, 64)
    if case == "run_all_inf":
        return _sorted_rows(rng, 4, 256), np.full((4, 64), INF_KEY, np.int32)
    if case == "both_all_inf":
        return (np.full((2, 100), INF_KEY, np.int32),
                np.full((2, 30), INF_KEY, np.int32))
    if case == "head_empty":
        return np.zeros((3, 0), np.int32), _sorted_rows(rng, 3, 300)
    if case == "run_empty":
        return _sorted_rows(rng, 3, 300), np.zeros((3, 0), np.int32)
    if case == "equal_keys":
        # few distinct keys, most of them in both rows: head before run
        head = np.sort(rng.integers(0, 4, (5, 256)), axis=1).astype(np.int32)
        run = np.sort(rng.integers(0, 4, (5, 64)), axis=1).astype(np.int32)
        head[:, 200:] = INF_KEY
        run[:, 50:] = INF_KEY
        return head, run
    if case == "rows_unaligned":
        # H and R not multiples of 4: rows off 16-byte alignment
        return _sorted_rows(rng, 5, 33), _sorted_rows(rng, 5, 131)
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["head_all_inf", "run_all_inf",
                                  "both_all_inf", "head_empty", "run_empty",
                                  "equal_keys", "rows_unaligned"])
def test_windowed_merge_edge_rows_match_plain(case):
    dev = _card()
    rng = np.random.default_rng(13)
    head_k, run_k = _merge_edge_rows(case, rng)
    (S, H), R = head_k.shape, run_k.shape[1]
    head_v = rng.integers(0, 1 << 20, (S, H)).astype(np.int32)
    run_v = rng.integers(0, 1 << 20, (S, R)).astype(np.int32)
    head_q = np.tile(np.arange(H, dtype=np.int32), (S, 1))
    run_q = 1000 + np.tile(np.arange(R, dtype=np.int32), (S, 1))
    args = [torch.as_tensor(a, device=dev) for a in
            (head_k, head_v, head_q, run_k, run_v, run_q)]
    _check("windowed_merge", args, KR.windowed_merge_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,k", TOPK)
@pytest.mark.parametrize("inf_share", [0.0, 0.9])
def test_topk_smallest_kernel_matches_plain(R, N, k, inf_share):
    dev = _card()
    rng = np.random.default_rng(R * N + k)
    keys = rng.integers(0, 1 << 20, (R, N)).astype(np.int32)
    keys[rng.random((R, N)) < inf_share] = INF_KEY
    tags = np.tile(np.arange(N, dtype=np.int32), (R, 1))
    args = [torch.as_tensor(a, device=dev) for a in (keys, tags)]
    _check("topk_smallest", args, KR.topk_smallest_ref, k=k)


def _topk_edge_rows(case, rng):
    """(keys, k) of the rows the deleteMin tournaments give the kernel, and
    of the edges of its chunking."""
    if case == "spray_inf_holes":
        # 16 ascending shard windows of 89 keys, most lanes masked to INF
        # (the SPRAY core's removed-lane window)
        keys = np.sort(rng.integers(0, 500, (16, 89)), axis=1)
        keys[rng.random((16, 89)) < 0.8] = INF_KEY
        return keys.reshape(1, -1).astype(np.int32), 64
    if case == "hier_runs":
        # two pods of 8 ascending 64-key runs, INF-padded (the semifinal)
        return _sorted_rows(rng, 16, 64).reshape(2, 512), 64
    if case == "all_inf":
        return np.full((3, 300), INF_KEY, np.int32), 64
    if case == "n_below_warp":
        return rng.integers(0, 9, (3, 17)).astype(np.int32), 5
    if case == "n_ragged":
        return rng.integers(0, 50, (2, 1000)).astype(np.int32), 57
    if case == "k_above_n":
        return rng.integers(0, 50, (2, 40)).astype(np.int32), 100
    if case == "k_widest":
        # k' = 4096: runs in shared memory, three warps, three chunks
        return rng.integers(0, 1 << 12, (1, 9000)).astype(np.int32), 3000
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["spray_inf_holes", "hier_runs", "all_inf",
                                  "n_below_warp", "n_ragged", "k_above_n",
                                  "k_widest"])
def test_topk_smallest_edge_rows_match_plain(case):
    dev = _card()
    keys, k = _topk_edge_rows(case, np.random.default_rng(7))
    R, N = keys.shape
    tags = np.tile(np.arange(N, dtype=np.int32), (R, 1))
    args = [torch.as_tensor(a, device=dev) for a in (keys, tags)]
    _check("topk_smallest", args, KR.topk_smallest_ref, k=k)


@pytest.mark.gpu
@pytest.mark.parametrize("R,B", SORT)
def test_elim_sort_kernel_matches_plain(R, B):
    dev = _card()
    rng = np.random.default_rng(R * B)
    keys = rng.integers(0, 64, (R, B)).astype(np.int32)
    keys[rng.random((R, B)) < 0.3] = INF_KEY
    tags = np.tile(np.arange(B, dtype=np.int32), (R, 1))
    args = [torch.as_tensor(a, device=dev) for a in (keys, tags)]
    _check("elim_sort", args, KR.elim_sort_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [22, 57, 64, 300])
def test_elim_sort_all_inf_rows_match_plain(B):
    """Path A's log at ins0: every key INF, so the tags alone order it."""
    dev = _card()
    keys = torch.full((64, B), INF_KEY, dtype=torch.int32, device=dev)
    tags = torch.arange(B, dtype=torch.int32, device=dev).flip(0)
    _check("elim_sort", [keys, tags.expand(64, B).contiguous()],
           KR.elim_sort_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("S,m", TWOCHOICE)
@pytest.mark.parametrize("tied", [False, True])
def test_twochoice_kernel_matches_plain(S, m, tied):
    """`mins` is a strided column of a head tier, as on the main path;
    `tied` draws the minima from 3 values (INF among them), so most lanes
    break ties by shard id."""
    dev = _card()
    rng = np.random.default_rng(S * m + tied)
    head = rng.integers(0, 1 << 20, (S, 40)).astype(np.int32)
    if tied:
        head[:, 0] = rng.choice(np.array([5, 9, INF_KEY], np.int32), S)
    mins = torch.as_tensor(head, device=dev)[:, 0]
    a, b = (torch.as_tensor(rng.integers(0, S, m).astype(np.int32),
                            device=dev) for _ in range(2))
    act = torch.as_tensor(rng.random(m) < 0.8, device=dev)
    before = KO.LAUNCHES["twochoice_pick"]
    got = KO.twochoice_counts(mins, a, b, act)
    torch.cuda.synchronize()
    assert KO.LAUNCHES["twochoice_pick"] == before + 1
    want = KR.twochoice_counts_ref(mins, a, b, act.to(torch.int32))
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(got.sum()) == int(act.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("S,m", MULTIQ)
def test_multiq_select_kernel_matches_plain(S, m):
    """The windows are row-strided views of a (S, 256) head tier."""
    dev = _card()
    rng = np.random.default_rng(S * m)
    head_k = _sorted_rows(rng, S, 256)
    head_v = rng.integers(0, 1 << 20, (S, 256)).astype(np.int32)
    take = rng.integers(0, m + 1, S).astype(np.int32)
    args = (torch.as_tensor(head_k, device=dev)[:, :m],
            torch.as_tensor(head_v, device=dev)[:, :m],
            torch.as_tensor(take, device=dev))
    _check("multiq_select", args, KR.multiq_select_ref,
           wrapper="multiq_select_topm")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["shards_12", "takes_0", "takes_m",
                                  "popped_inf", "m_1", "shards_40",
                                  "m_300"])
def test_multiq_select_edge_cases_match_plain(case):
    """S not a power of two, nothing popped, every window popped whole,
    INF keys inside the take-prefixes, one lane, more shards than a block
    has warps, windows too wide for registers."""
    dev = _card()
    rng = np.random.default_rng(11)
    S, m = {"shards_12": (12, 57), "m_1": (16, 1), "shards_40": (40, 57),
            "m_300": (4, 300)}.get(case, (16, 57))
    H = max(256, m)
    head_k = _sorted_rows(rng, S, H)
    head_v = rng.integers(0, 1 << 20, (S, H)).astype(np.int32)
    take = rng.integers(0, m + 1, S).astype(np.int32)
    if case == "takes_0":
        take[:] = 0
    elif case in ("takes_m", "popped_inf"):
        take[:] = m
    if case == "popped_inf":
        head_k[:, m // 3:] = INF_KEY
    args = (torch.as_tensor(head_k, device=dev)[:, :m],
            torch.as_tensor(head_v, device=dev)[:, :m],
            torch.as_tensor(take, device=dev))
    _check("multiq_select", args, KR.multiq_select_ref,
           wrapper="multiq_select_topm")


@pytest.mark.gpu
@pytest.mark.parametrize("S,C,R", MERGE_SORTED)
def test_merge_sorted_kernel_matches_plain(S, C, R):
    dev = _card()
    rng = np.random.default_rng(S * C + R)
    buf_k, run_k = _sorted_rows(rng, S, C), _sorted_rows(rng, S, R)
    buf_v = np.tile(np.arange(C, dtype=np.int32), (S, 1))
    run_v = (1 << 20) + np.tile(np.arange(R, dtype=np.int32), (S, 1))
    args = [torch.as_tensor(a, device=dev) for a in
            (buf_k, buf_v, run_k, run_v)]
    _check("merge_sorted", args, KR.merge_sorted_runs_ref,
           wrapper="merge_sorted_runs")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["duplicates", "inf_small_vals"])
def test_merge_sorted_ties_match_plain(case):
    """`duplicates`: all vals 0 and keys in [0, 8), so equal (key, val)
    words stand in buffer and run.  `inf_small_vals`: INF-keyed run words
    with vals below those of the buffer's INF-keyed words, which rank
    before them."""
    dev = _card()
    rng = np.random.default_rng(7)
    S, C, R = 4, 256, 64
    buf_k, run_k = _sorted_rows(rng, S, C), _sorted_rows(rng, S, R)
    if case == "duplicates":
        buf_k, run_k = (np.sort(np.where(a == INF_KEY, a, a % 8), axis=1)
                        for a in (buf_k, run_k))
        buf_v, run_v = np.zeros((S, C), np.int32), np.zeros((S, R), np.int32)
    else:
        buf_v = np.where(buf_k == INF_KEY, 1000, 0).astype(np.int32)
        run_v = np.where(run_k == INF_KEY, 5, 0).astype(np.int32)
    args = [torch.as_tensor(a, device=dev) for a in
            (buf_k, buf_v, run_k, run_v)]
    _check("merge_sorted", args, KR.merge_sorted_runs_ref,
           wrapper="merge_sorted_runs")


@pytest.mark.gpu
def test_merge_sorted_refuses_rows_above_shared_memory():
    dev = _card()
    buf = torch.zeros((1, 1 << 15), dtype=torch.int32, device=dev)
    run = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="merge_sorted kernel launch"):
        KO.merge_sorted_runs(buf, buf, run, run)


@pytest.mark.gpu
def test_three_mode_window_on_the_card_equals_the_cpu():
    """The default three-mode SmartPQ, with the MULTIQ mode forced on some
    windows and chosen by the tree on others, on the card and on the CPU:
    bit-identical carries and outputs, and all three modes ran."""
    dev = _card()
    cfg = SmartPQConfig(num_shards=8, capacity=1024, npods=2,
                        decision_interval=2)
    gpu = SmartPQ(cfg, device=dev)
    cpu = SmartPQ(cfg, tree=gpu.tree, device="cpu")
    cg, cc = gpu.init(), cpu.init()
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(1)
    K, B = 6, 32
    modes = set()
    for w, (ins, nc, ov) in enumerate([(0.95, 512, -1), (0.6, 16, -1),
                                       (0.6, 16, 1), (0.3, 64, -1),
                                       (0.5, 64, 0)]):
        ops = torch.as_tensor((rng.random((K, B)) > ins).astype(np.int32))
        keys = torch.as_tensor(rng.integers(0, 16384, (K, B))
                               .astype(np.int32))
        vals = torch.as_tensor(rng.integers(0, 99, (K, B)).astype(np.int32))
        draws = step_draws(cfg.mode_schedules, 8, B, 256, steps=K,
                           generator=gen)
        cg, rg = gpu.run_window(cg, ops.to(dev), keys.to(dev), vals.to(dev),
                                draws=tuple(d.to(dev) for d in draws),
                                num_clients=nc, mode_override=ov)
        cc, rc = cpu.run_window(cc, ops, keys, vals, draws=draws,
                                num_clients=nc, mode_override=ov)
        for a, b in zip(rg, rc):
            assert torch.equal(a.cpu(), b)
        modes |= set(rc.mode.tolist())
        for x, y in zip(carry_to_numpy(cg), carry_to_numpy(cc)):
            for f in x:
                np.testing.assert_array_equal(x[f], y[f], err_msg=f)
    assert modes == {0, 1, 2}


@pytest.mark.gpu
def test_window_on_the_card_equals_the_cpu():
    """The two-mode SmartPQ on the card (kernels) and on the CPU (plain
    versions), same tree, inputs and draws: bit-identical carries."""
    dev = _card()
    cfg = SmartPQConfig(num_shards=8, capacity=512, head_width=64, npods=2,
                        decision_interval=2,
                        mode_schedules=(Schedule.SPRAY_HERLIHY,) * 2
                        + (Schedule.HIER,))
    gpu = SmartPQ(cfg, device=dev)
    cpu = SmartPQ(cfg, tree=gpu.tree, device="cpu")
    cg, cc = gpu.init(), cpu.init()
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    K, B = 5, 32
    for w in range(8):
        ops = torch.as_tensor((rng.random((K, B)) > (0.8 if w < 4 else 0.3))
                              .astype(np.int32))
        keys = torch.as_tensor(rng.integers(0, 4096, (K, B)).astype(np.int32))
        vals = torch.as_tensor(rng.integers(0, 99, (K, B)).astype(np.int32))
        nc = 64 if w % 2 else 8
        draws = spray_draws(8, B, 64, steps=K, generator=gen)
        cg, rg = gpu.run_window(cg, ops.to(dev), keys.to(dev), vals.to(dev),
                                draws=tuple(d.to(dev) for d in draws),
                                num_clients=nc)
        cc, rc = cpu.run_window(cc, ops, keys, vals, draws=draws,
                                num_clients=nc)
        for a, b in zip(rg, rc):
            assert torch.equal(a.cpu(), b)
        for x, y in zip(carry_to_numpy(cg), carry_to_numpy(cc)):
            for f in x:
                np.testing.assert_array_equal(x[f], y[f], err_msg=f)


# ---------------------------------------------------------------------------
# the application workloads on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n,E", [(65536, 4096), (4096, 256), (64, 5000)])
def test_segment_min_into_on_the_card_equals_the_cpu(n, E):
    """int32 amin in `scatter_reduce_` on the card, with drop sentinels,
    INF lanes and duplicate targets, equals the CPU's."""
    dev = _card()
    rng = np.random.default_rng(n + E)
    dist = rng.integers(0, 1 << 20, n).astype(np.int32)
    dist[rng.random(n) < 0.3] = INF_KEY
    tgt = rng.integers(0, min(n, 64), E).astype(np.int32)
    tgt[rng.random(E) < 0.2] = n
    vals = rng.integers(0, 1 << 20, E).astype(np.int32)
    vals[rng.random(E) < 0.2] = INF_KEY
    args = [torch.as_tensor(a) for a in (dist, tgt, vals)]
    want = KO.segment_min_into(*args)
    got = KO.segment_min_into(*(a.to(dev) for a in args))
    assert got.device.type == dev.type and torch.equal(got.cpu(), want)


def _equal_results(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        elif f != "trace":
            assert x == y, (f, x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", ["HIER", "MULTIQ"])
def test_fixed_schedule_sssp_on_the_card_equals_the_cpu(schedule):
    dev = _card()
    g_gpu = graphs.random_graph(n=512, seed=0, device=dev)
    g_cpu = graphs.random_graph(n=512, seed=0, device="cpu")
    draws = step_draws((Schedule[schedule],), 16, 32, 256, steps=512,
                       generator=torch.Generator().manual_seed(3))
    kw = dict(m=32, num_shards=16, capacity=1024, seed=3, max_steps=512)
    got = sssp.run_sssp(g_gpu, Schedule[schedule], draws=draws, **kw)
    want = sssp.run_sssp(g_cpu, Schedule[schedule], draws=draws, **kw)
    _equal_results(got, want)
    assert got.converged
    np.testing.assert_array_equal(got.dist, graphs.bellman_ford(g_cpu))


@pytest.mark.gpu
def test_adaptive_sssp_on_the_card_equals_the_cpu():
    """Result, modes and recorded trace, spray and HIER steps both."""
    dev = _card()
    cfg = SmartPQConfig(num_shards=16, capacity=1024, npods=2,
                        decision_interval=2)
    gpu = SmartPQ(cfg, device=dev)
    cpu = SmartPQ(cfg, tree=gpu.tree, device="cpu")
    draws = step_draws(cfg.mode_schedules, 16, 144, 256, steps=512,
                       generator=torch.Generator().manual_seed(2))
    (rg, tg), (rc, tc) = (
        sssp.run_sssp_smartpq(graphs.random_graph(n=512, seed=1,
                                                  device=pq.device),
                              pq, m=16, seed=2, record=True,
                              num_clients=512, draws=draws)
        for pq in (gpu, cpu))
    _equal_results(rg, rc)
    for x, y in zip(tg, tc):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert rg.converged and 0 in rg.modes.tolist()


@pytest.mark.gpu
def test_hold_model_and_bursty_replay_on_the_card_equal_the_cpu():
    dev = _card()
    cfg = SmartPQConfig(num_shards=16, capacity=1 << 12, npods=2,
                        decision_interval=2)
    gpu = SmartPQ(cfg, device=dev)
    cpu = SmartPQ(cfg, tree=gpu.tree, device="cpu")
    gen = torch.Generator().manual_seed(7)
    draws = step_draws(cfg.mode_schedules, 16, 128, 256, steps=32,
                       generator=gen)
    kw = dict(B=64, K=32, seed=7, n_init=20000, mean_hold=1 << 12,
              num_clients=512, record=True, draws=draws)
    got, want = des.run_hold_model(gpu, **kw), des.run_hold_model(cpu, **kw)
    _equal_results(got, want)
    for x, y in zip(got.trace, want.trace):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    trace = traces.bursty_des_trace(phases=traces.BURSTY_PHASES, seed=5)
    draws = step_draws(cfg.mode_schedules, 16, trace.width, 256,
                       steps=trace.num_steps, generator=gen)
    (cg, rg), (cc, rc) = (traces.replay(pq, trace, draws=draws)
                          for pq in (gpu, cpu))
    for a, b in zip(rg, rc):
        assert torch.equal(a.cpu(), b)
    for x, y in zip(carry_to_numpy(cg), carry_to_numpy(cc)):
        for f in x:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f)
    assert len(set(rc.mode.tolist())) >= 2


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------


def _serve_draws(T, S=16, B=64):
    return step_draws((Schedule.SPRAY_HERLIHY, Schedule.MULTIQ,
                       Schedule.HIER), S, B, 256, steps=T,
                      generator=torch.Generator().manual_seed(T))


@pytest.mark.gpu
def test_scheduler_windows_on_the_card_equal_the_cpu():
    """The scheduler's default queue with an overload controller voting
    MULTIQ (class 0 light, classes 1 and 2 over their targets), windows of
    K = 4 and 16 and single ticks, on the card and on the CPU with the same
    draws: the same dispatch streams, stats and carry."""
    dev = _card()
    draws = _serve_draws(200)
    ov = dict(targets=(8.0, 16.0, 32.0), backlog_cap=256, min_samples=4)
    gpu = SmartPQScheduler(batch_size=64, seed=1, device=dev, draws=draws,
                           overload=OverloadConfig(**ov))
    cpu = SmartPQScheduler(batch_size=64, seed=1, device="cpu",
                           tree=gpu.pq.tree, draws=draws,
                           overload=OverloadConfig(**ov))
    rng = np.random.default_rng(2)
    uid = tick = 0
    for K in [4, 16, 1, 4, 16, 1, 16, 4, 16, 4]:
        arrivals = []
        for t in range(K):
            n = int(rng.integers(0, 40))
            arrivals.append([(uid + i, int(rng.integers(1, 64)),
                              int(rng.choice(3, p=[0.1, 0.45, 0.45])),
                              tick + t) for i in range(n)])
            uid += n
        budgets = [int(rng.integers(8, 24)) for _ in range(K)]
        tick += K
        outs = []
        for s in (gpu, cpu):
            reqs = [[Request(uid=u, prompt_len=p, max_new_tokens=4,
                             slo_class=c, arrival_step=a) for u, p, c, a in ts]
                    for ts in arrivals]
            out = (s.tick_window(reqs, budgets) if K > 1
                   else [s.tick(reqs[0], budgets[0])])
            outs.append([[r.uid for r in t] for t in out])
        assert outs[0] == outs[1]
        assert gpu.stats == cpu.stats
    assert 1 in gpu.stats.mode_trace and gpu.stats.shed > 0
    for x, y in zip(carry_to_numpy(gpu.carry), carry_to_numpy(cpu.carry)):
        for f in x:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [4, 16])
def test_generator_window_on_the_card_equals_k_ticks(K):
    """The default draw source on the card (the scheduler's CUDA generator,
    no `draws=`), default queue: a window dispatches exactly what K `tick`
    calls with the same seed and budgets dispatch, with the same stats and
    carry (but `ring_deferred`, the window's own counter), and leaves the
    same generator stream behind (one more tick agrees)."""
    dev = _card()
    win = SmartPQScheduler(batch_size=64, seed=5, device=dev)
    seq = SmartPQScheduler(batch_size=64, seed=5, device=dev,
                           tree=win.pq.tree)
    rng = np.random.default_rng(K)
    uid = 0
    for w in range(64 // K):
        arrivals = []
        for t in range(K):
            n = int(rng.integers(0, 48))
            arrivals.append([(uid + i, int(rng.integers(1, 64)),
                              int(rng.integers(0, 3)), w * K + t)
                             for i in range(n)])
            uid += n
        budgets = [int(rng.integers(0, 24)) for _ in range(K)]
        reqs = [[[Request(uid=u, prompt_len=p, max_new_tokens=4, slo_class=c,
                          arrival_step=a) for u, p, c, a in ts]
                 for ts in arrivals] for _ in range(2)]
        got = win.tick_window(reqs[0], budgets)
        want = [seq.tick(a, b) for a, b in zip(reqs[1], budgets)]
        assert [[r.uid for r in t] for t in got] == \
            [[r.uid for r in t] for t in want]
    assert win.stats == seq.stats and win.pending == seq.pending
    assert win.stats.dispatched > 0
    assert [r.uid for r in win.tick([], 8)] == [r.uid for r in seq.tick([], 8)]
    got, want = carry_to_numpy(win.carry), carry_to_numpy(seq.carry)
    got[1].pop("ring_deferred"), want[1].pop("ring_deferred")
    for x, y in zip(got, want):
        for f in y:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 4])
def test_engine_run_on_the_card_equals_the_cpu(K):
    """The synthetic-decode engine on the bursty serving workload, on the
    card and on the CPU with the same draws: the same summary, health,
    latency records, outputs and carry."""
    dev = _card()
    draws = _serve_draws(600)
    ecfg = EngineConfig(batch_size=8, max_seq=512, sched_window=K)
    gpu = ServeEngine(None, None, ecfg, device=dev, draws=draws)
    cpu = ServeEngine(None, None, ecfg, device="cpu",
                      tree=gpu.scheduler.pq.tree, draws=draws)
    sg, sc = (e.run(traces.bursty_serve_workload(steps=48, seed=1),
                    max_steps=100_000) for e in (gpu, cpu))
    sg.pop("wall_s"), sc.pop("wall_s")
    assert sg == sc and sg["completed"] > 0
    assert gpu.health() == cpu.health()
    assert gpu.outputs == cpu.outputs
    lg, lc = gpu.latency_records(), cpu.latency_records()
    for k in lc:
        np.testing.assert_array_equal(lg[k], lc[k], err_msg=k)
    for x, y in zip(carry_to_numpy(gpu.scheduler.carry),
                    carry_to_numpy(cpu.scheduler.carry)):
        for f in x:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f)


# ---------------------------------------------------------------------------
# durable serving
# ---------------------------------------------------------------------------


def _durable(root, device, draws=None, tree=None, K=4, seed=3):
    return ServeEngine(None, None, EngineConfig(
        batch_size=8, sched_window=K, durable_dir=str(root),
        snapshot_interval=3), seed=seed, device=device, tree=tree,
        draws=draws)


def _durable_prints(eng):
    from repro_torch.core.smartpq import carry_fingerprint

    return (dict(eng.done_step), dict(eng.outputs),
            carry_fingerprint(eng.scheduler.carry),
            {k: v for k, v in eng.health().items() if k != "durability"})


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 4])
def test_durable_pause_resume_on_the_card_equals_the_cpu(tmp_path, K):
    """A durable run on the card with injected draws, paused at step 8 and
    resumed by a fresh engine from its snapshot, ends equal to the same
    run uninterrupted on the CPU: done steps, outputs, fingerprint, health."""
    dev = _card()
    draws = _serve_draws(400)
    wl = lambda: traces.bursty_serve_workload(steps=24, seed=3)  # noqa: E731
    first = _durable(tmp_path / "g", dev, draws, K=K)
    tree = first.scheduler.pq.tree
    first.run(wl(), max_steps=8)
    assert first._step == 8
    first.durability.close()
    resumed = _durable(tmp_path / "g", dev, draws, tree, K=K)
    resumed.run(wl(), max_steps=100_000)
    cpu = _durable(tmp_path / "c", "cpu", draws, tree, K=K)
    cpu.run(wl(), max_steps=100_000)
    assert _durable_prints(resumed) == _durable_prints(cpu)
    assert resumed.health()["completed"] > 0
    for e in (resumed, cpu):
        e.durability.close()


@pytest.mark.gpu
def test_durable_generator_run_resumes_on_the_card(tmp_path):
    """The scheduler's own CUDA generator (no draws): a durable run paused
    at step 8 and resumed by a fresh engine draws exactly what the same
    run draws uninterrupted on the card."""
    dev = _card()
    wl = lambda: traces.bursty_serve_workload(steps=24, seed=3)  # noqa: E731
    whole = _durable(tmp_path / "w", dev)
    tree = whole.scheduler.pq.tree
    whole.run(wl(), max_steps=100_000)
    first = _durable(tmp_path / "p", dev, tree=tree)
    first.run(wl(), max_steps=8)
    first.durability.close()
    resumed = _durable(tmp_path / "p", dev, tree=tree)
    resumed.run(wl(), max_steps=100_000)
    assert _durable_prints(resumed) == _durable_prints(whole)
    for e in (whole, resumed):
        e.durability.close()


@pytest.mark.gpu
def test_snapshot_reads_the_card_once_and_loads_back_onto_it(tmp_path):
    """`persist.host_tree` reads a card carry in one host read;
    `load_tree` puts the carry leaves back on the card and the CUDA
    generator's state on the CPU, as `Generator.set_state` takes it."""
    from repro_torch.core import persist
    from repro_torch.core.smartpq import carry_fingerprint
    from repro_torch.utils import hostsync

    dev = _card()
    eng = ServeEngine(None, None, EngineConfig(batch_size=4), device=dev)
    eng.run(traces.bursty_serve_workload(steps=8, seed=1), max_steps=40)
    like = eng._snapshot_arrays()
    syncs = hostsync.SYNCS["count"]
    host = persist.host_tree(like)
    assert hostsync.SYNCS["count"] == syncs + 1
    persist.save_tree(tmp_path, 1, host)
    got, _ = persist.load_tree(tmp_path, like)
    assert got["sched"]["carry"].state.head_keys.device.type == "cuda"
    assert got["tokens"].device.type == "cuda"
    assert got["sched"]["generator"].device.type == "cpu"
    assert got["sched"]["generator"].dtype == torch.uint8
    assert carry_fingerprint(got["sched"]["carry"]) == carry_fingerprint(
        host["sched"]["carry"]) == carry_fingerprint(eng.scheduler.carry)
    gen = torch.Generator(device=dev)
    gen.set_state(got["sched"]["generator"])
    assert torch.equal(torch.randint(0, 1 << 30, (8,), device=dev,
                                     generator=gen),
                       torch.randint(0, 1 << 30, (8,), device=dev,
                                     generator=eng.scheduler._gen))


# ---------------------------------------------------------------------------
# the distributed PQ and Nuddle (chip_smoke.py path I at a small size)
# ---------------------------------------------------------------------------


def _dist_queue(dev, S=16, C=1 << 10, n=4096, seed=0):
    from repro_torch.core.pqueue import ops as O
    from repro_torch.core.pqueue.state import make_state

    rng = np.random.default_rng(seed)
    st, dropped = O.insert(
        make_state(S, C, device=dev),
        torch.as_tensor(rng.integers(0, 8192, n).astype(np.int32), device=dev),
        torch.as_tensor(rng.integers(0, 99, n).astype(np.int32), device=dev))
    assert int(dropped.sum()) == 0
    return st


def _equal_leaves(a, b, where):
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), (where,
                                                                     f.name)


@pytest.mark.gpu
def test_dist_schedules_on_the_card_equal_the_single_controller():
    """Path I1 at a small size: one rank on a (1, 1) mesh over NCCL, steps
    of `insert_dist` and each of the five distributed schedules on one
    carry, every leaf and output equal to the single-controller run with
    the same draws."""
    from repro_torch.core.pqueue import dist as D
    from repro_torch.core.pqueue import ops as O
    from repro_torch.core.pqueue import schedules as SCH
    from repro_torch.distributed import make_mesh

    dev = _card()
    st_d = st_s = _dist_queue(dev)
    rng = np.random.default_rng(1)
    m = 32
    sc = {Schedule.STRICT_FLAT: lambda st, a, d: O.delete_min(
              st, m, Schedule.STRICT_FLAT, active=a),
          Schedule.SPRAY_HERLIHY: lambda st, a, d: SCH.delete_spray_herlihy(
              st, m, a, d, 1),
          Schedule.MULTIQ: lambda st, a, d: SCH.delete_multiq(st, m, a, d, 1)}
    sc[Schedule.HIER] = sc[Schedule.FFWD] = sc[Schedule.STRICT_FLAT]
    with make_mesh((1, 1), ("pod", "shard")) as mesh:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        cfg = D.AxisCfg(("shard",), "pod", mesh=mesh)
        gen = D.rank_generator(3, cfg)
        for t, active in enumerate((32, 20, 7)):
            k = torch.as_tensor(rng.integers(0, 8192, 64).astype(np.int32),
                                device=dev)
            v = torch.as_tensor(rng.integers(0, 99, 64).astype(np.int32),
                                device=dev)
            st_d, dropped, rejected = D.insert_dist(
                st_d, k, v, torch.ones_like(k, dtype=torch.bool), cfg)
            st_s, _ = O.insert(st_s, k, v)
            assert not bool(rejected.any())
            _equal_leaves(st_d, st_s, f"insert {t}")
            a = torch.tensor(active, dtype=torch.int32, device=dev)
            for schedule, fn in D.DIST_SCHEDULE_FNS.items():
                twin = torch.Generator(device=dev)
                twin.set_state(gen.get_state())
                draws = SCH.schedule_draws(schedule, None, 16, m,
                                           st_s.head_width, generator=twin,
                                           device=dev)
                got = fn(st_d, m, a, None, cfg, generator=gen)
                want = sc[schedule](st_s, a, draws)
                _equal_leaves(got[0], want.state, f"{schedule.name} {t}")
                for g, w in zip(got[1:], want[1:]):
                    assert torch.equal(g, w), (schedule.name, t)
                st_d, st_s = got[0], want.state


@pytest.mark.gpu
def test_staged_gloo_mesh_on_the_card_has_jax_layout():
    """Eight rank processes on the card over gloo, payloads staged through
    host memory: the collectives give the same layouts and sums as on the
    CPU (tests/test_torch_collectives.py's rank function)."""
    from repro_torch.distributed import spawn
    from torch_dist_ranks import collectives

    _card()
    x = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    args = dict(shape=(2, 4), axes=("pod", "data"), args=(x, 8), timeout=300)
    card = spawn(collectives, device="cuda", backend="gloo", **args)
    cpu = spawn(collectives, device="cpu", **args)
    for g, c in zip(card, cpu):
        for key in g:
            if key.startswith(("rank", "all_", "psum_scatter", "ppermute")):
                np.testing.assert_array_equal(g[key], c[key], err_msg=key)
        np.testing.assert_allclose(g["hier"], x.sum(0), 1e-5, 1e-5)
        assert g["counts"] == c["counts"]


@pytest.mark.gpu
def test_gloo_takes_cuda_tensors_for_collectives_but_not_sends():
    """What the installed torch's gloo does with CUDA tensors given as they
    are, the reason a gloo mesh on the card stages every payload through
    host memory: its collectives take them and give the right results, a
    point-to-point send fails the rank (two ranks)."""
    from repro_torch.distributed import spawn
    from torch_dist_ranks import gloo_probe

    _card()
    args = dict(shape=(2,), axes=("dev",), device="cuda", backend="gloo",
                timeout=180)
    ar = np.arange(2, dtype=np.int32)
    for r, got in enumerate(spawn(gloo_probe, args=(False,), **args)):
        want = {"all_reduce": 2 * ar + 10, "broadcast": ar,
                "all_gather": ar[None, :] + 10 * ar[:, None],
                "reduce_scatter": np.array([2 * r + 10], np.int32),
                "all_to_all_single": r + 10 * ar}
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, err_msg=name)
    with pytest.raises(RuntimeError):
        spawn(gloo_probe, args=(True,), **args)


@pytest.mark.gpu
def test_nuddle_on_the_card_equals_the_cpu():
    """Path I3 at a small size: `delegate_single_controller` and a K = 8
    `delegate_window` of `pq_tournament_ops`, card against CPU."""
    from repro_torch.core import nuddle as N

    dev = _card()
    st = _dist_queue(dev)
    ns = torch.tensor([32, 20, 1, 0, 32, 17, 9, 32], dtype=torch.int32)
    outs = []
    for d in (dev, torch.device("cpu")):
        ls = {"keys": st.keys.to(d), "vals": st.vals.to(d)}
        before = KO.LAUNCHES["topk_smallest"]
        one = N.delegate_single_controller(N.pq_tournament_ops(), ls, 32, 2,
                                           {"n": 20})
        win = N.delegate_window(N.pq_tournament_ops(), ls, 32, 2,
                                {"n": ns.to(d)})
        assert (KO.LAUNCHES["topk_smallest"] > before) == (d.type == "cuda")
        outs.append((one, win))
    for a, b in zip(outs[0], outs[1]):
        for x, y in zip(a, b):
            for k in x:
                assert torch.equal(x[k].cpu(), y[k]), k


def _same_trees(a, b, where=""):
    """Integer leaves equal; float leaves to the collectives' tolerance."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_trees(x, y, f"{where}/{i}")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, 1e-5, 1e-5, err_msg=where)
    else:
        assert np.array_equal(a, b), where


@pytest.mark.gpu
def test_nccl_mesh_across_four_cards_equals_the_cpu_mesh():
    """NCCL across four cards (a (2, 2) mesh, one card a rank) against the
    same ranks over gloo on the CPU, whose results tests/test_torch_dist.py
    and tests/test_torch_collectives.py hold to the JAX package: every
    schedule's state and outputs, `delegate_dist`, the collectives and
    their counts."""
    from repro_torch.distributed import spawn
    from torch_dist_ranks import collectives, dist_pq, port_cases

    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    cases = port_cases(4)
    for fn, axes, args in ((dist_pq, ("pod", "shard"), (cases,)),
                           (collectives, ("pod", "data"), (x, 8))):
        runs = [spawn(fn, (2, 2), axes, device=d, args=args, timeout=300)
                for d in ("cuda", "cpu")]
        _same_trees(runs[0], runs[1], fn.__name__)


@pytest.mark.gpu
def test_sharded_training_across_four_cards():
    """granite-8b trained at full width on a (data=2, model=2) mesh over
    NCCL, one card a rank (ZeRO-3 + TP, f32 masters, int8 first moments,
    batch 2 x 1024): its training state (about 89 GB) fits no one card.
    Peak allocated on each card under 80 GB, the two losses finite and
    falling, and the first within 1e-3 relative of `make_eval_step`'s on
    one card with the same parameters in bf16 (16.5 GB) and batch (the
    sharded step computes in bf16 from the same f32 draws; the ranks add
    partial sums in another order)."""
    import math

    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import to_device
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed import spawn
    from repro_torch.models.params import init_params
    from repro_torch.train.steps import make_eval_step
    from torch_dist_ranks import full_width_training

    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    arch, B, S = "granite-8b", 2, 1024
    ranks = spawn(full_width_training, (2, 2), ("data", "model"),
                  device="cuda", args=(arch, B, S, 2), timeout=1200)
    for r in ranks:
        assert r["peak"] < 80e9, r
        assert all(math.isfinite(x) for x in r["losses"]), r
        assert r["losses"][1] < r["losses"][0], r
        assert r["losses"] == ranks[0]["losses"]
    assert len({r["card"] for r in ranks}) == 4
    cfg = get_config(arch)
    dev = torch.device("cuda", 0)
    step, _ = make_eval_step(cfg, None, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16, device=dev)
    data = SyntheticLMDataset(cfg.vocab, seq_len=S, fixed_map=True, seed=0)
    want = float(step(params, to_device(data.batch(0, B), dev)))
    got = ranks[0]["losses"][0]
    print(f"granite-8b (2, 2) over NCCL: losses {ranks[0]['losses']}, "
          f"one-card eval {want}, peak a card "
          f"{[r['peak'] for r in ranks]}")
    assert abs(got - want) <= 1e-3 * abs(want)


# ---------------------------------------------------------------------------
# the dense model path
# ---------------------------------------------------------------------------

# The CPU tests' tolerances (tests/test_torch_models.py): f32 logits within
# 5e-5 and caches within 1e-5; bf16 within 2 ulps of the largest value.
MODEL_F32 = dict(logits=5e-5, cache=1e-5)
# Decode against recompute at full width in bf16 on the card, in ulps of the
# largest prefill value: chip_smoke.py's J2_ULPS (one-row and S-row matmuls
# round apart at every layer).
FULL_WIDTH_ULPS = 16


def _bf16_ulps(got, want):
    want, got = want.float().cpu(), got.float().cpu()
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    return float((got - want).abs().max()) / ulp


def _model_run(cfg, tree_np, tok_np, dtype, device, steps, ctx_np=None):
    """train_logits, prefill and teacher-forced decode steps from empty
    caches, on `device`; logits and caches on the CPU.  `ctx_np`: the
    enc-dec or VLM family's context, whose cross K/V (`xk`, `xv`) the
    decode caches take from the prefill."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model

    model = build_model(cfg, compute_dtype=dtype, device=device)
    p = params_from_numpy(tree_np, cfg, device=device, dtype=dtype)
    tok = torch.as_tensor(tok_np, device=device)
    batch = {"tokens": tok}
    if ctx_np is not None:
        key = "enc_embeds" if cfg.family == "encdec" else "image_embeds"
        batch[key] = torch.as_tensor(ctx_np, device=device)
    train, _ = model.train_logits(p, batch)
    pre, pc = model.prefill(p, batch)
    B, S = tok.shape
    caches = init_caches(cfg, B, S, dtype=dtype, device=device)
    if ctx_np is not None:
        caches.update(xk=pc["xk"].clone(), xv=pc["xv"].clone())
    logits = [train, pre]
    for t in range(steps):
        lg, caches = model.decode_step(
            p, caches, tok[:, t:t + 1],
            torch.full((B,), t, dtype=torch.int32, device=device))
        logits.append(lg)
    return ([x.cpu() for x in logits],
            [x.cpu() for x in [pc[k] for k in sorted(pc)]
             + [caches[k] for k in sorted(caches)]])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "gemma-2b"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_model_on_the_card_equals_the_cpu(arch, dtype, monkeypatch):
    """`chip_smoke.py` J4 in small form: one numpy tree on the card and on
    the CPU, f32 with TF32 off then bf16, `train_logits`, `prefill` and 8
    decode steps within the CPU tests' tolerances; and the engine (EOS off,
    the same draws) with the same admissions, completion steps and health,
    and in f32 the same tokens."""
    import functools

    import repro_torch.models.io as MIO
    import repro_torch.models.registry as MR
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.params import init_params

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config(arch)
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tree_np = params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu"))
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    (lg, kv), (lc, kc) = (_model_run(cfg, tree_np, tok, td, d, 8)
                          for d in (dev, "cpu"))
    for what, got, want in (("logits", lg, lc), ("cache", kv, kc)):
        for g, c in zip(got, want):
            if dtype == "f32":
                assert float((g - c).abs().max()) <= MODEL_F32[what]
            else:
                assert _bf16_ulps(g, c) <= 2
    if dtype == "f32":
        monkeypatch.setattr(MR, "build_model", functools.partial(
            MR.build_model, compute_dtype=torch.float32))
        monkeypatch.setattr(MIO, "init_caches", functools.partial(
            MIO.init_caches, dtype=torch.float32))
    draws = _serve_draws(200)
    engines = []
    for d in (dev, "cpu"):
        eng = ServeEngine(cfg, params_from_numpy(tree_np, cfg, device=d,
                                                 dtype=td),
                          EngineConfig(batch_size=4, max_seq=32,
                                       eos_token=-1),
                          device=d, draws=draws,
                          tree=engines[0].scheduler.pq.tree if engines
                          else None)
        eng.run(traces.bursty_serve_workload(steps=16, seed=1),
                max_steps=100_000)
        assert eng.caches["k"].dtype == td
        engines.append(eng)
    g, c = engines
    assert g.admit_step == c.admit_step and g.done_step == c.done_step
    assert g.health() == c.health() and len(g.done_step) > 0
    if dtype == "f32":
        assert g.outputs == c.outputs


@pytest.mark.gpu
def test_full_width_decode_on_the_card_equals_recompute():
    """`chip_smoke.py` J2 in small form: llama3.2-3b at full width in bf16
    on the card, one prompt of 8 tokens: `prefill` against 8 teacher-forced
    `decode_step`s (the last logits and both caches), within
    `FULL_WIDTH_ULPS`."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model

    dev = _card()
    cfg = get_config("llama3.2-3b")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tok = torch.randint(0, cfg.vocab, (1, 8), device=dev, dtype=torch.int32,
                        generator=torch.Generator(device=dev).manual_seed(1))
    want, pre = model.prefill(params, {"tokens": tok})
    caches = init_caches(cfg, 1, 8, device=dev)
    for t in range(8):
        got, caches = model.decode_step(
            params, caches, tok[:, t:t + 1],
            torch.full((1,), t, dtype=torch.int32, device=dev))
    assert got.shape == (1, 128256) and bool(torch.isfinite(got).all())
    for g, w in ((got, want), (caches["k"], pre["k"]),
                 (caches["v"], pre["v"])):
        assert _bf16_ulps(g, w) <= FULL_WIDTH_ULPS


# ---------------------------------------------------------------------------
# the MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

# bf16 bounds of these families, card against CPU (the port against
# itself, as chip_smoke.py K3): 2 ulps, jamba's 8.
FAMILY_BF16_ULPS = {"granite-moe-1b-a400m": 2, "mamba2-780m": 2,
                    "jamba-1.5-large-398b": 8}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(FAMILY_BF16_ULPS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_family_on_the_card_equals_the_cpu(arch, dtype, monkeypatch):
    """`chip_smoke.py` K3 in small form: one numpy tree of a reduced MoE,
    SSM or hybrid model on the card and on the CPU, f32 with TF32 off then
    bf16: `train_logits`, `prefill` (every cache) and 8 decode steps within
    the CPU tests' tolerances (64 tokens for the SSD families: two
    chunks); and the engine (EOS off, the same draws) with the same
    admissions, completion steps and health, and in f32 the same tokens."""
    import functools

    import repro_torch.models.io as MIO
    import repro_torch.models.registry as MR
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.params import init_params

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config(arch)
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tree_np = params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu"))
    S = 64 if cfg.ssm else 16
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (2, S)).astype(
        np.int32)
    (lg, st), (lc, sc) = (_model_run(cfg, tree_np, tok, td, d, 8)
                          for d in (dev, "cpu"))
    for what, got, want in (("logits", lg, lc), ("cache", st, sc)):
        for g, c in zip(got, want):
            if dtype == "f32":
                assert float((g - c).abs().max()) <= MODEL_F32[what]
            else:
                assert _bf16_ulps(g, c) <= FAMILY_BF16_ULPS[arch]
    if dtype == "f32":
        monkeypatch.setattr(MR, "build_model", functools.partial(
            MR.build_model, compute_dtype=torch.float32))
        monkeypatch.setattr(MIO, "init_caches", functools.partial(
            MIO.init_caches, dtype=torch.float32))
    draws = _serve_draws(200)
    engines = []
    for d in (dev, "cpu"):
        eng = ServeEngine(cfg, params_from_numpy(tree_np, cfg, device=d,
                                                 dtype=td),
                          EngineConfig(batch_size=4, max_seq=32,
                                       eos_token=-1),
                          device=d, draws=draws,
                          tree=engines[0].scheduler.pq.tree if engines
                          else None)
        eng.run(traces.bursty_serve_workload(steps=16, seed=1),
                max_steps=100_000)
        engines.append(eng)
    g, c = engines
    assert g.admit_step == c.admit_step and g.done_step == c.done_step
    assert g.health() == c.health() and len(g.done_step) > 0
    if dtype == "f32":
        assert g.outputs == c.outputs


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 128])
def test_full_width_moe_layer_on_the_card_equals_the_cpu(T):
    """`chip_smoke.py` K1's layer check in small form: one granite-moe-3b
    `moe_block` at full width (d 1536, 40 experts, top 8, F 512) in f32
    with TF32 off, from one numpy draw, at a decode step's 8 tokens (cap 2)
    and at 128 (cap 32): the same routing and kept
    assignments, the output within 2e-5 and aux within 1e-6 relative (the
    CPU tests' tolerances)."""
    from repro_torch.models.layers import moe as TM

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(5)
    D, E, F = 1536, 40, 512
    arrays = [rng.standard_normal((1, T, D)).astype(np.float32),
              (0.02 * rng.standard_normal((D, E))).astype(np.float32)]
    arrays += [(0.02 * rng.standard_normal(s)).astype(np.float32)
               for s in ((E, D, F), (E, D, F), (E, F, D))]
    dims = TM.MoEDims(40, 40, 8, 1.25)
    runs = []
    for d in (dev, "cpu"):
        x, rw, wg, wu, wd = (torch.as_tensor(a, device=d) for a in arrays)
        out, aux = TM.moe_block(x, rw, wg, wu, wd, dims)
        _, _, sel = TM.route(x.reshape(T, D), rw, dims)
        keep = [k for _, _, k in TM.dispatch(sel, dims,
                                             TM.capacity(T, dims))]
        runs.append((out.cpu(), float(aux), sel.cpu(),
                     torch.stack(keep).cpu()))
    (og, ag, sg, kg), (oc, ac, scpu, kc) = runs
    assert TM.capacity(T, dims) == {8: 2, 128: 32}[T]
    assert torch.equal(sg, scpu) and torch.equal(kg, kc)
    assert int((~kc).sum()) > 0
    torch.testing.assert_close(og, oc, rtol=2e-5, atol=2e-5)
    assert abs(ag - ac) <= 1e-6 * abs(ac)


# ---------------------------------------------------------------------------
# the enc-dec and VLM families
# ---------------------------------------------------------------------------

# bf16 bounds card against CPU: the CPU tests'
# (tests/test_torch_encdec_vlm.py).
ENCDEC_VLM_BF16_ULPS = {"whisper-base": 2, "llama-3.2-vision-11b": 3}


def _redraw_nonzero(params, gen):
    """Norm scales and biases (scale 0.1) and the VLM's gates (scale 1)
    redrawn from `gen` in place, as the CPU tests redraw theirs: zero at
    init, they would zero whisper's logits and cut the VLM's image off."""
    from repro_torch.models.params import leaves

    for path, w in leaves(params):
        name = path.split("/")[-1]
        if name.startswith(("b", "norm", "final_norm")) or name == "gate":
            z = torch.randn(w.shape, generator=gen, device=gen.device)
            w.copy_(z * (1.0 if name == "gate" else 0.1))
    return params


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(ENCDEC_VLM_BF16_ULPS))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_encdec_vlm_on_the_card_equals_the_cpu(arch, dtype,
                                                       monkeypatch):
    """`chip_smoke.py` L4 in small form: one numpy tree of reduced
    whisper-base or llama-3.2-vision-11b (norms, biases and gates redrawn
    nonzero) on the card and on the CPU, f32 with TF32 off then bf16:
    `train_logits`, `prefill` (all four caches) and 8 decode steps from
    the prefill's `xk`/`xv` within the CPU tests' tolerances; and the
    engine (EOS off, the same draws) with the same admissions, completion
    steps and health, and in f32 the same tokens."""
    import functools

    import repro_torch.models.io as MIO
    import repro_torch.models.registry as MR
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.params import init_params

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config(arch)
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    rng = np.random.default_rng(4)
    tree_np = params_to_numpy(_redraw_nonzero(init_params(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu"), torch.Generator().manual_seed(5)))
    tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    n_ctx = 24 if cfg.family == "encdec" else cfg.n_image_tokens
    ctx = rng.standard_normal((2, n_ctx, cfg.d_model)).astype(np.float32)
    (lg, kv), (lc, kc) = (_model_run(cfg, tree_np, tok, td, d, 8, ctx)
                          for d in (dev, "cpu"))
    for what, got, want in (("logits", lg, lc), ("cache", kv, kc)):
        for g, c in zip(got, want):
            if dtype == "f32":
                assert float((g - c).abs().max()) <= MODEL_F32[what]
            else:
                assert _bf16_ulps(g, c) <= ENCDEC_VLM_BF16_ULPS[arch]
    if dtype == "f32":
        monkeypatch.setattr(MR, "build_model", functools.partial(
            MR.build_model, compute_dtype=torch.float32))
        monkeypatch.setattr(MIO, "init_caches", functools.partial(
            MIO.init_caches, dtype=torch.float32))
    draws = _serve_draws(200)
    engines = []
    for d in (dev, "cpu"):
        eng = ServeEngine(cfg, params_from_numpy(tree_np, cfg, device=d,
                                                 dtype=td),
                          EngineConfig(batch_size=4, max_seq=32,
                                       eos_token=-1),
                          device=d, draws=draws,
                          tree=engines[0].scheduler.pq.tree if engines
                          else None)
        eng.run(traces.bursty_serve_workload(steps=16, seed=1),
                max_steps=100_000)
        assert not eng.caches["xk"].any() and not eng.caches["xv"].any()
        engines.append(eng)
    g, c = engines
    assert g.admit_step == c.admit_step and g.done_step == c.done_step
    assert g.health() == c.health() and len(g.done_step) > 0
    if dtype == "f32":
        assert g.outputs == c.outputs


@pytest.mark.gpu
def test_full_width_whisper_decode_on_the_card_equals_recompute():
    """`chip_smoke.py` L1 in small form: whisper-base at full width in bf16
    on the card (norms and biases redrawn nonzero), one prompt of 8 tokens
    over whisper's 1500 encoder frames: `prefill` against 8
    teacher-forced `decode_step`s from its `xk`/`xv` (the last logits and
    both self-attention caches) within `FULL_WIDTH_ULPS`; zero frames move
    the logits by more than that."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model

    dev = _card()
    cfg = get_config("whisper-base")
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = _redraw_nonzero(model.init(gen), gen)
    tok = torch.randint(0, cfg.vocab, (1, 8), device=dev, dtype=torch.int32,
                        generator=gen)
    # one draw shared by every frame plus one a frame (chip_smoke.py's
    # `model_context`): iid frames average out under random attention
    enc = (torch.randn((1, 1, cfg.d_model), device=dev, generator=gen)
           + torch.randn((1, 1500, cfg.d_model), device=dev, generator=gen))
    want, pre = model.prefill(params, {"tokens": tok, "enc_embeds": enc})
    zero, _ = model.prefill(params, {"tokens": tok,
                                     "enc_embeds": torch.zeros_like(enc)})
    caches = dict(init_caches(cfg, 1, 8, device=dev), xk=pre["xk"],
                  xv=pre["xv"])
    for t in range(8):
        got, caches = model.decode_step(
            params, caches, tok[:, t:t + 1],
            torch.full((1,), t, dtype=torch.int32, device=dev))
    assert got.shape == (1, 51968) and bool(torch.isfinite(got).all())
    for g, w in ((got, want), (caches["k"], pre["k"]),
                 (caches["v"], pre["v"])):
        assert _bf16_ulps(g, w) <= FULL_WIDTH_ULPS
    assert _bf16_ulps(zero, want) > FULL_WIDTH_ULPS


# ---------------------------------------------------------------------------
# the int8 KV cache and training
# ---------------------------------------------------------------------------

# card against CPU, the CPU tests' bounds (tests/test_torch_grad.py,
# test_torch_train.py): the loss within 1e-6 relative, each gradient leaf
# within 1e-5 of its largest |g|; the checkpoint drill's resumed losses
# within 1e-3 relative of an uninterrupted run on the card (chip_smoke.py's
# M3_DRILL_LOSS: the embedding's backward adds with atomics).
GRAD_TOL = dict(loss=1e-6, leaf=1e-5)


def _grad_run(cfg, tree_np, batch_np, device):
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
    return float(total.detach()), [g.cpu() for g in grads]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m",
                                  "mamba2-780m"])
def test_reduced_grads_on_the_card_equal_the_cpu(arch):
    """`chip_smoke.py` M3 in small form: the training loss and every
    gradient leaf of a reduced model, f32 with TF32 off, from one numpy
    tree (norms redrawn nonzero), card against CPU."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_to_numpy
    from repro_torch.models.params import init_params

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config(arch)
    tree_np = params_to_numpy(_redraw_nonzero(init_params(
        cfg, torch.Generator().manual_seed(3), dtype=torch.float32,
        device="cpu"), torch.Generator().manual_seed(5)))
    S = 2 * cfg.ssm.chunk if cfg.ssm else 16
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (2, S + 1))
    batch = {"tokens": tok[:, :-1].astype(np.int32),
             "labels": tok[:, 1:].astype(np.int32)}
    (lg, gg), (lc, gc) = (_grad_run(cfg, tree_np, batch, d)
                          for d in (dev, "cpu"))
    assert abs(lg - lc) <= GRAD_TOL["loss"] * abs(lc)
    for a, b in zip(gg, gc):
        assert float((a - b).abs().max()) <= GRAD_TOL["leaf"] * float(
            b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["fp32", "bf16", "int8"])
def test_adamw_on_the_card_equals_the_cpu(state_dtype):
    """One `adamw_update` on the card and on the CPU from the same numpy
    parameters and gradients: f32 leaves within 2 f32 ulps of the leaf's
    largest value, bf16 moments within 2 bf16 ulps, int8 payloads within 2
    quanta.  (The clip's scale comes from a sum of squares that the card
    reduces in another order, an ulp apart at some steps, so each further
    step may add an ulp.)"""
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update, tree_leaves)

    dev = _card()
    rng = np.random.default_rng(1)
    p_np = {"stack": rng.standard_normal((2, 4, 512)).astype(np.float32),
            "norm": rng.standard_normal((256,)).astype(np.float32),
            "tiny": rng.standard_normal((3,)).astype(np.float32)}
    g_np = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in p_np.items()}]
    cfg = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    runs = []
    for d in (dev, "cpu"):
        p = {k: torch.as_tensor(v, device=d) for k, v in p_np.items()}
        st = adamw_init(p, cfg)
        for g in g_np:
            p, st = adamw_update(p, {k: torch.as_tensor(v, device=d)
                                     for k, v in g.items()}, st, cfg)
        runs.append([t.cpu() for e in tree_leaves(
            {"p": p, "m": st.m, "v": st.v})
            for t in (e if isinstance(e, tuple) else (e,))])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype
        diff = float((a.float() - b.float()).abs().max())
        top = float(b.float().abs().max())
        if b.dtype == torch.int8:
            assert diff <= 2
        elif b.dtype == torch.bfloat16:
            assert diff <= 2 * 2.0 ** (np.floor(np.log2(top)) - 7)
        else:
            assert diff <= 2 * float(np.spacing(np.float32(top)))


@pytest.mark.gpu
def test_checkpoint_drill_on_the_card(tmp_path):
    """tests/test_train.py's failure injection on the card (reduced
    gemma-2b): the step-10 checkpoint restores bit-equal to the state the
    loop saved, the resumed run finishes at 20 with losses close to an
    uninterrupted run's, and its checkpoint reads back on the CPU."""
    import repro_torch.train.loop as TL
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.params import init_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             tree_leaves)

    dev = _card()
    cfg = reduced_config("gemma-2b")
    loop = TL.LoopConfig(steps=20, batch_size=2, ckpt_every=5,
                         ckpt_dir=str(tmp_path))
    saved, save = {}, ckpt.save

    def keep(d, step, tree, **kw):
        saved[step] = ckpt._host_copy(tree)
        return save(d, step, tree, **kw)

    ckpt.save = keep
    try:
        with pytest.raises(RuntimeError, match="injected failure"):
            TL.run(cfg, loop, injector=FailureInjector(fail_at=(12,)),
                   device=dev)
    finally:
        ckpt.save = save
    assert ckpt.latest_step(tmp_path) == 10

    def state_like(d):
        p = init_params(cfg, dtype=torch.float32, device=d)
        return {"params": p, "opt": adamw_init(p, AdamWConfig())}

    def flat(tree):
        return [t for e in tree_leaves({"p": tree["params"],
                                        "m": tree["opt"].m,
                                        "v": tree["opt"].v})
                for t in (e if isinstance(e, tuple) else (e,))] + [
            tree["opt"].step]

    for a, b in zip(flat(ckpt.restore(tmp_path, state_like(dev))),
                    flat(saved[10])):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    res = TL.run(cfg, loop, device=dev)
    assert res["resumed_from"] == 10 and res["steps_done"] == 20
    whole = TL.run(cfg, TL.LoopConfig(steps=20, batch_size=2), device=dev)
    for a, b in zip(res["losses"], whole["losses"][10:]):
        assert abs(a - b) <= 1e-3 * abs(b)
    final = {"params": res["params"], "opt": res["opt_state"]}
    for a, b in zip(flat(ckpt.restore(tmp_path, state_like("cpu"))),
                    flat(final)):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reduced_int8_decode_on_the_card_equals_the_cpu(dtype):
    """8 int8 decode steps of reduced llama3.2-3b from one numpy tree, card
    against CPU: logits within the bf16 bound (2 ulps) in f32 too, payloads
    within 2 quanta (chip_smoke.py's M3: a K/V value card and CPU round an
    f32 ulp apart can land on either side of a quantum's half)."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.io import init_caches
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import build_model

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config("llama3.2-3b")
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    tree_np = params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(7), dtype=torch.float32,
        device="cpu"))
    tok = np.random.default_rng(8).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32)
    runs = []
    for d in (dev, "cpu"):
        m = build_model(cfg, compute_dtype=td, kv_int8=True, device=d)
        p = params_from_numpy(tree_np, cfg, device=d, dtype=td)
        caches = init_caches(cfg, 2, 16, dtype=td, kv_int8=True, device=d)
        logits = [m.decode_step(p, caches, torch.as_tensor(
            tok[:, t:t + 1], device=d), torch.full(
            (2,), t, dtype=torch.int32, device=d))[0].cpu()
            for t in range(8)]
        runs.append((logits, {k: v.cpu() for k, v in caches.items()}))
    (lg, cg), (lc, cc) = runs
    for a, b in zip(lg, lc):
        assert _bf16_ulps(a, b) <= 2
    for k in ("k", "v"):
        assert cg[k].dtype == torch.int8
        assert int((cg[k].int() - cc[k].int()).abs().max()) <= 2


@pytest.mark.gpu
def test_reduced_training_loss_falls_on_the_card():
    """`chip_smoke.py` M2 in small form: reduced llama3.2-3b trained by the
    loop on the card (f32 masters, bf16 compute, int8 first moments) on
    the launcher's bigram task; the losses finite and falling."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig

    dev = _card()
    cfg = reduced_config("llama3.2-3b")
    res = run(cfg, LoopConfig(steps=20, batch_size=4),
              opt_cfg=AdamWConfig(lr=1e-3, state_dtype="int8"),
              data=SyntheticLMDataset(cfg.vocab, 64, fixed_map=True),
              device=dev)
    losses = res["losses"]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
    assert res["params"]["embed"].device.type == "cuda"


@pytest.mark.gpu
def test_full_width_int8_decode_tracks_bf16():
    """`chip_smoke.py` M1 in small form: llama3.2-3b at full width in bf16,
    one prompt of 8 tokens teacher-forced through int8 and bf16 caches:
    the softmaxes within 0.05 (the reference test's bar), and the int8
    logits within 15 % of the step's largest |logit| from the bf16 ones
    (M1_LOGIT_REL: random weights amplify the quantization noise through
    28 layers and leave the top logits about 0.2 apart, so the greedy
    token is a near tie that rounding alone can move)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model

    dev = _card()
    cfg = get_config("llama3.2-3b")
    mb = build_model(cfg, device=dev)
    m8 = build_model(cfg, kv_int8=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = mb.init(gen)
    tok = torch.randint(0, cfg.vocab, (1, 8), device=dev, dtype=torch.int32,
                        generator=gen)
    cb = init_caches(cfg, 1, 64, device=dev)
    c8 = init_caches(cfg, 1, 64, kv_int8=True, device=dev)
    for t in range(8):
        lengths = torch.full((1,), t, dtype=torch.int32, device=dev)
        lb, _ = mb.decode_step(params, cb, tok[:, t:t + 1], lengths)
        li, _ = m8.decode_step(params, c8, tok[:, t:t + 1], lengths)
        lb, li = lb.float(), li.float()
        gap = (lb.softmax(-1) - li.softmax(-1)).abs().max()
        assert float(gap) < 0.05
        assert float((li - lb).abs().max() / lb.abs().max()) <= 0.15
