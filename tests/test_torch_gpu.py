"""The port on the card: each CUDA kernel against its plain version, and the
fused window on the card against the same window on the CPU.

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
         (16, 256, 8192)]
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
        (1, 2048, 128)]
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
             (16, 144)]
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
