"""Parity of the port's SSSP workload (`repro_torch.workloads.graphs` and
`.sssp`, and `kernels.ops.segment_min_into`) with the JAX package's, on the
CPU: the same graphs and oracle distances, the same segment-min, and the
whole `SSSPResult` (and the recorded trace) of every engine with the
reference's draws injected.  Integer outputs must be bit-equal: the
tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.pqueue.schedules import Schedule as JS
from repro.kernels.segmin import segment_min_scatter, segment_min_sorted
from repro.workloads import graphs as JG
from repro.workloads import registry as JR
from repro.workloads import sssp as JSS
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.pqueue.schedules import Schedule as TS
from repro_torch.kernels.ops import segment_min_into
from repro_torch.workloads import graphs as TG
from repro_torch.workloads import registry as TR
from repro_torch.workloads import sssp as TSS
from torch_draws import chunked_keys, draws_from_keys

torch.set_num_threads(1)

INF_KEY = 2**31 - 1


def _graphs(n, seed, **kw):
    return (JG.random_graph(n=n, seed=seed, **kw),
            TG.random_graph(n=n, seed=seed, device="cpu", **kw))


def _assert_result_equal(want, got):
    assert type(got).__name__ == type(want).__name__ == "SSSPResult"
    assert got._fields == want._fields
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert type(a) is type(b) and a == b, (f, a, b)


@pytest.mark.parametrize("n,seed,kw", [
    (128, 1, {}), (512, 0, {}), (300, 7, dict(avg_deg=6, deg_cap=4)),
    (64, 2, dict(max_weight=3)), (5, 3, {}),
])
def test_random_graph_and_bellman_ford_match_jax(n, seed, kw):
    jg, tg = _graphs(n, seed, **kw)
    assert (tg.n, tg.deg_cap, tg.num_edges) == (jg.n, jg.deg_cap,
                                                 jg.num_edges)
    for f in ("indptr", "indices", "weights", "nbr", "wgt"):
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f)
        b = b.numpy() if torch.is_tensor(b) else b
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for src in (0, n // 2):
        a, b = JG.bellman_ford(jg, src), TG.bellman_ford(tg, src)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,E", [(64, 512), (1000, 64), (7, 300), (1, 9)])
def test_segment_min_into_matches_both_jax_arms(n, E):
    """Drop sentinels (n and beyond), INF lanes and many duplicate
    targets."""
    rng = np.random.default_rng(n * E)
    dist = rng.integers(0, 1000, n).astype(np.int32)
    dist[rng.random(n) < 0.3] = INF_KEY
    tgt = rng.integers(0, min(n, 5) if E > 100 else n, E).astype(np.int32)
    tgt[rng.random(E) < 0.2] = n
    tgt[rng.random(E) < 0.05] = n + 3
    vals = rng.integers(0, 1200, E).astype(np.int32)
    vals[rng.random(E) < 0.2] = INF_KEY
    got = segment_min_into(torch.as_tensor(dist), torch.as_tensor(tgt),
                           torch.as_tensor(vals))
    assert got.dtype == torch.int32 and got.shape == (n,)
    for arm in (segment_min_scatter, segment_min_sorted):
        want = np.asarray(arm(jnp.asarray(dist), jnp.asarray(tgt),
                              jnp.asarray(vals)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("schedule", ["STRICT_FLAT", "HIER", "FFWD"])
def test_sssp_exact_matches_bellman_ford_and_jax(schedule):
    jg, tg = _graphs(512, 0)
    want = JSS.run_sssp(jg, JS[schedule], m=32, seed=1)
    got = TSS.run_sssp(tg, TS[schedule], m=32, seed=1)
    assert got.converged
    np.testing.assert_array_equal(got.dist, TG.bellman_ford(tg))
    _assert_result_equal(want, got)


@pytest.mark.parametrize("schedule,n,kw", [
    ("SPRAY_HERLIHY", 128, {}), ("MULTIQ", 128, {}),
    ("SPRAY_FRASER", 128, dict(num_shards=4, npods=4)),
    ("LOCAL", 512, {}), ("MULTIQ", 512, dict(m=8, chunk=4)),
])
def test_sssp_relaxed_with_jax_draws_matches_jax(schedule, n, kw):
    """The relaxed schedules with the reference's draws: the whole result
    (pops, wasted pops, steps) equals the reference's, and the distances
    are exact once the queue drains."""
    jg, tg = _graphs(n, 1 if n == 128 else 0)
    want = JSS.run_sssp(jg, JS[schedule], seed=1, **kw)
    m, chunk = kw.get("m", 32), kw.get("chunk", 8)
    draws = draws_from_keys(chunked_keys(1, want.steps, chunk),
                            kw.get("num_shards", 8), m, 256)
    got = TSS.run_sssp(tg, TS[schedule], seed=1, draws=draws, **kw)
    _assert_result_equal(want, got)
    assert got.converged
    np.testing.assert_array_equal(got.dist, TG.bellman_ford(tg))


@pytest.fixture(scope="module")
def trees():
    """Each package's registry tree, trained once from its own training
    set (the two are equal: tests/test_torch_smartpq.py)."""
    JR._TREE = j_train_tree(*j_training_set(), 4, max_depth=8)
    TR._TREE = train_tree(*make_training_set(), 4, max_depth=8)


@pytest.mark.parametrize("n,graph_seed,seed,kw", [
    (128, 1, 2, {}),
    (512, 0, 3, {}),
    (128, 1, 2, dict(num_clients=512)),  # the spray runs, then HIER
    (128, 1, 5, dict(mode_schedules=("MULTIQ",) * 3)),
    (128, 1, 6, dict(mode_schedules=("STRICT_FLAT",) * 3,
                     eliminate=False, chunk=3)),
])
def test_sssp_smartpq_with_jax_draws_matches_jax(trees, n, graph_seed, seed,
                                                  kw):
    """The adaptive engine with the reference's draws: the whole result
    (modes and transitions included) and the recorded trace equal the
    reference's."""
    kw = dict(kw)
    schedules = kw.pop("mode_schedules", None)
    pq_kw = {"eliminate": kw.pop("eliminate")} if "eliminate" in kw else {}
    jg, tg = _graphs(n, graph_seed)
    jpq = JR.default_pq(head_width=256, mode_schedules=None if schedules is
                        None else tuple(JS[s] for s in schedules), **pq_kw)
    tpq = TR.default_pq(head_width=256, mode_schedules=None if schedules is
                        None else tuple(TS[s] for s in schedules),
                        device="cpu", **pq_kw)
    want, wtrace = JSS.run_sssp_smartpq(jg, jpq, m=16, seed=seed,
                                        record=True, **kw)
    draws = draws_from_keys(chunked_keys(seed, want.steps,
                                         kw.get("chunk", 8)),
                            8, 16 * 8 + 16, 256)
    got, gtrace = TSS.run_sssp_smartpq(tg, tpq, m=16, seed=seed, record=True,
                                       draws=draws, **kw)
    _assert_result_equal(want, got)
    assert got.converged
    np.testing.assert_array_equal(got.dist, TG.bellman_ford(tg))
    assert gtrace.seed == wtrace.seed
    for f in ("ops", "keys", "vals", "num_clients", "init_keys",
              "init_vals"):
        a, b = getattr(wtrace, f), getattr(gtrace, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if "num_clients" in kw:
        assert {0, 2} <= set(got.modes.tolist())


def test_sssp_without_draws_converges_from_a_generator(trees):
    """Without draws the engines draw from a generator seeded with `seed`:
    relaxed runs converge to the oracle and repeat bit for bit."""
    _, tg = _graphs(128, 1)
    ref = TG.bellman_ford(tg)
    runs = [TSS.run_sssp(tg, TS.MULTIQ, seed=4) for _ in range(2)]
    _assert_result_equal(runs[0], runs[1])
    pq = TR.default_pq(head_width=256, device="cpu")
    for r in runs + [TSS.run_sssp_smartpq(tg, pq, seed=4,
                                          num_clients=512)[0]]:
        assert r.converged
        np.testing.assert_array_equal(r.dist, ref)


def test_sssp_smartpq_batch_wider_than_head_raises_like_jax(trees):
    jg, tg = _graphs(128, 1)
    with pytest.raises(ValueError) as want:
        JSS.make_smartpq_sssp_engine(jg, JR.default_pq(head_width=128), m=16)
    with pytest.raises(ValueError) as got:
        TSS.make_smartpq_sssp_engine(
            tg, TR.default_pq(head_width=128, device="cpu"), m=16)
    assert str(got.value) == str(want.value)
    assert "batch width 144" in str(got.value)
