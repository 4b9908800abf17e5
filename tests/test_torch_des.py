"""Parity of the port's DES hold model, workload registry, host PQ oracle
and trace datasets with the JAX package's, on the CPU: the same hold times
and initial events, the heapq oracle and the reference's `DESResult` and
trace with its draws injected, the registry's six quick traces, the
`RefPQ` cases of tests/test_pqueue_oracle.py against the port's schedules,
and the same trace-derived classifier examples and trained tree.  Integer
outputs must be bit-equal: the tolerance is zero.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.classifier.dataset import (
    examples_from_trace as j_examples_from_trace,
    make_mixed_training_set as j_mixed_training_set,
    make_trace_test_set as j_trace_test_set,
    make_trace_training_set as j_trace_training_set,
    make_training_set as j_training_set,
)
from repro.core.classifier.inference import pack_tree as j_pack_tree
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.pqueue.ref import RefPQ as JRefPQ
from repro.core.pqueue.schedules import Schedule as JS
from repro.workloads import des as JD
from repro.workloads import registry as JR
from repro.workloads import traces as JT
from repro_torch.core.classifier.dataset import (
    examples_from_trace,
    make_mixed_training_set,
    make_trace_test_set,
    make_trace_training_set,
    make_training_set,
)
from repro_torch.core.classifier.features import NUM_CLASSES
from repro_torch.core.classifier.inference import pack_arrays
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.pqueue import ops as O
from repro_torch.core.pqueue.ref import RefPQ
from repro_torch.core.pqueue.schedules import Schedule as TS
from repro_torch.core.pqueue.schedules import multiq_bound
from repro_torch.core.pqueue.state import INF_KEY, invariant_violations
from repro_torch.core.pqueue.state import make_state
from repro_torch.workloads import des as TD
from repro_torch.workloads import registry as TR
from repro_torch.workloads import traces as TT
from torch_draws import chunked_keys, draws_from_keys, window_keys

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    """Each package's registry tree, trained once from its own training
    set (the two are equal: tests/test_torch_smartpq.py)."""
    JR._TREE = j_train_tree(*j_training_set(), 4, max_depth=8)
    TR._TREE = train_tree(*make_training_set(), 4, max_depth=8)


def _pqs(schedule=None, **kw):
    js = None if schedule is None else (JS[schedule],) * 3
    ts = None if schedule is None else (TS[schedule],) * 3
    return (JR.default_pq(mode_schedules=js, **kw),
            TR.default_pq(mode_schedules=ts, device="cpu", **kw))


def _assert_fields_equal(want, got, fields):
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert type(a) is type(b) and a == b, (f, a, b)


RESULT = ("popped", "n_out", "modes", "transitions", "events", "final_size")
TRACE = ("ops", "keys", "vals", "num_clients", "seed", "init_keys",
         "init_vals")


# ---------------------------------------------------------------------------
# the hold model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,B,mean_hold,seed", [(48, 32, 64, 3), (5, 7, 1, 0),
                                                (16, 64, 1 << 20, 9)])
def test_holds_and_initial_events_match_jax(K, B, mean_hold, seed):
    for a, b in ((JD.sample_holds(K, B, mean_hold, seed),
                  TD.sample_holds(K, B, mean_hold, seed)),
                 (JD.initial_events(4 * B, mean_hold, seed),
                  TD.initial_events(4 * B, mean_hold, seed))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_hold_model_strict_matches_heapq_oracle_and_jax(trees):
    B, K = 32, 48
    jpq, tpq = _pqs("STRICT_FLAT")
    want = JD.run_hold_model(jpq, B=B, K=K, seed=3, record=True)
    got = TD.run_hold_model(tpq, B=B, K=K, seed=3, record=True)
    oracle = TD.hold_model_oracle(B, K, seed=3)
    assert oracle == JD.hold_model_oracle(B, K, seed=3)
    assert got.events == sum(len(o) for o in oracle)
    for t in range(K):
        np.testing.assert_array_equal(got.popped[t][: got.n_out[t]],
                                      np.asarray(oracle[t], np.int32),
                                      err_msg=f"step {t}")
    _assert_fields_equal(want, got, RESULT)
    _assert_fields_equal(want.trace, got.trace, TRACE)


@pytest.mark.parametrize("schedule,B,K,seed,kw", [
    (None, 32, 48, 3, {}),
    (None, 16, 24, 8, dict(num_clients=512, n_init=300)),
    ("MULTIQ", 32, 24, 4, {}),
    ("SPRAY_HERLIHY", 24, 20, 1, dict(mean_hold=5)),
])
def test_hold_model_with_jax_draws_matches_jax(trees, schedule, B, K, seed,
                                               kw):
    jpq, tpq = _pqs(schedule)
    want = JD.run_hold_model(jpq, B=B, K=K, seed=seed, record=True, **kw)
    draws = draws_from_keys(window_keys(seed, K), 8, 2 * B, 256)
    got = TD.run_hold_model(tpq, B=B, K=K, seed=seed, record=True,
                            draws=draws, **kw)
    _assert_fields_equal(want, got, RESULT)
    _assert_fields_equal(want.trace, got.trace, TRACE)
    if kw.get("num_clients") == 512:
        assert 0 in got.modes.tolist()


def test_hold_model_multiq_conserves_events(trees):
    """The reference test's identity (tests/test_workloads.py:113-135): a
    relaxed schedule may under-serve but never loses an event."""
    B, K = 32, 24
    exact = TD.run_hold_model(_pqs("STRICT_FLAT")[1], B=B, K=K, seed=4)
    relaxed = TD.run_hold_model(_pqs("MULTIQ")[1], B=B, K=K, seed=4,
                                generator=torch.Generator().manual_seed(4))
    for res in (exact, relaxed):
        rescheduled = int(np.sum(res.n_out[:-1]))
        assert res.events + res.final_size == 4 * B + rescheduled
    assert relaxed.events <= exact.events
    assert exact.events - relaxed.events <= K * 2


def test_recorded_hold_trace_replays_the_live_run(trees):
    """The adaptive run's own op log, replayed with the same draws, pops
    exactly what the live run popped."""
    B, K = 16, 16
    _, tpq = _pqs()
    draws = draws_from_keys(window_keys(5, K), 8, 2 * B, 256)
    res = TD.run_hold_model(tpq, B=B, K=K, seed=5, record=True, draws=draws,
                            num_clients=512)
    _, rep = TT.replay(tpq, res.trace, draws=draws)
    np.testing.assert_array_equal(rep.keys.numpy()[:, :B], res.popped)
    np.testing.assert_array_equal(rep.mode.numpy(), res.modes)
    assert int(rep.n_out.sum()) == res.events


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_names_and_unknown_name():
    assert TR.names() == JR.names()
    assert {n: (s.kind, s.description) for n, s in TR.WORKLOADS.items()} \
        == {n: (s.kind, s.description) for n, s in JR.WORKLOADS.items()}
    for reg in (JR, TR):
        with pytest.raises(KeyError, match="unknown workload 'nope'"):
            reg.get("nope")


@pytest.mark.parametrize("name", sorted(JR.WORKLOADS))
def test_registry_quick_traces_match_jax(trees, name):
    """Every workload's quick trace; the recorders take the reference's
    draws."""
    want = JR.get(name).make_trace(True, 11)
    kw = {}
    if name == "sssp":
        kw["draws"] = draws_from_keys(chunked_keys(11, want.num_steps),
                                      8, want.width, 256)
    elif name == "des_hold":
        kw["draws"] = draws_from_keys(window_keys(11, want.num_steps),
                                      8, want.width, 256)
    got = TR.get(name).make_trace(True, 11, device="cpu", **kw)
    _assert_fields_equal(want, got, TRACE)


# ---------------------------------------------------------------------------
# RefPQ: the cases of tests/test_pqueue_oracle.py against the port
# ---------------------------------------------------------------------------


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assert_healthy(st):
    viols = invariant_violations(st, first_only=True)
    assert not viols, viols[0]


def _queued_keys(st):
    k = st.keys.numpy()
    return np.sort(k[k < INF_KEY].ravel()).astype(np.int64)


@pytest.mark.parametrize("S,C,B", [(8, 64, 16), (4, 128, 32), (16, 32, 8)])
def test_strict_matches_oracle(S, C, B):
    rng = np.random.default_rng(0)
    st, ref, jref = make_state(S, C, device="cpu"), RefPQ(S, C), JRefPQ(S, C)
    for step in range(12):
        keys = rng.integers(0, 10000, B).astype(np.int32)
        vals = rng.integers(0, 100, B).astype(np.int32)
        st, dropped = O.insert(st, _t(keys), _t(vals))
        n_drop = ref.insert_batch(keys, vals)
        assert int(dropped.sum()) == n_drop == jref.insert_batch(keys, vals)
        _assert_healthy(st)
        n_del = int(rng.integers(0, B))
        res = O.delete_min(st, B, schedule=TS.STRICT_FLAT, active=n_del)
        st = res.state
        rk, rv = ref.delete_min_exact(n_del)
        jk, jv = jref.delete_min_exact(n_del)
        np.testing.assert_array_equal(rk, jk)
        np.testing.assert_array_equal(rv, jv)
        n = int(res.n_out)
        assert n == len(rk)
        np.testing.assert_array_equal(res.keys.numpy()[:n], rk)
        np.testing.assert_array_equal(res.vals.numpy()[:n], rv)
        _assert_healthy(st)
    np.testing.assert_array_equal(_queued_keys(st), ref.key_multiset())
    assert len(ref) == len(jref) and ref.total_dropped == jref.total_dropped


def _filled(S=8, C=64, n=200, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 5000, n).astype(np.int32)
    vals = rng.integers(0, 99, n).astype(np.int32)
    st, _ = O.insert(make_state(S, C, device="cpu"), _t(keys), _t(vals))
    ref = RefPQ(S, C)
    ref.insert_batch(keys, vals)
    return st, ref


def _draws(key, S=8, m=8):
    return tuple(d[0] for d in draws_from_keys(key[None], S, m, 64))


def test_exact_schedules_agree():
    st, _ = _filled()
    a = O.delete_min(st, 8, schedule=TS.STRICT_FLAT, active=8)
    b = O.delete_min(st, 8, schedule=TS.HIER, active=8, npods=4)
    c = O.delete_min(st, 8, schedule=TS.FFWD, active=8)
    for res in (b, c):
        assert torch.equal(a.keys, res.keys) and torch.equal(a.vals, res.vals)
        assert torch.equal(a.state.keys, res.state.keys)


@pytest.mark.parametrize("variant", ["SPRAY_HERLIHY", "SPRAY_FRASER", "LOCAL",
                                     "MULTIQ"])
def test_relaxed_envelope_and_conservation(variant):
    st, ref = _filled()
    jref = JRefPQ(8, 64)
    jref._items = list(ref._items)
    draws = None if variant == "LOCAL" else _draws(jax.random.key(42))
    res = O.delete_min(st, 8, schedule=TS[variant], active=8,
                       draws=None if draws is None else
                       (draws[0], draws[2] if variant == "MULTIQ"
                        else draws[1]))
    got = res.keys.numpy()[: int(res.n_out)]
    if variant != "LOCAL":
        assert ref.check_spray_result(got, 8) == jref.check_spray_result(
            got, 8) == (True, "ok")
    assert ref.remove_multiset(got), "returned keys not present in queue"
    np.testing.assert_array_equal(_queued_keys(res.state),
                                  ref.key_multiset())
    _assert_healthy(res.state)


def test_multiq_rank_error_oracle():
    """Every MULTIQ batch sits within the first m entries of some shard, and
    the global rank error stays within multiq_bound over many draws — the
    port's counts equal the reference oracle's on the same batches."""
    m = 8
    violations = total = 0
    for trial in range(20):
        st, ref = _filled(S=8, C=64, n=400, seed=100 + trial)
        jref = JRefPQ(8, 64)
        jref._items = list(ref._items)
        sc, _, cb = _draws(jax.random.key(1000 + trial))
        res = O.delete_min(st, m, schedule=TS.MULTIQ, active=m,
                           draws=(sc, cb))
        got = res.keys.numpy()[: int(res.n_out)]
        ok, msg = ref.check_multiq_result(got, m)
        assert ok, f"trial {trial}: {msg}"
        v, t = ref.global_envelope_violations(got, m, bound=multiq_bound(8, m))
        assert (v, t) == jref.global_envelope_violations(
            got, m, bound=multiq_bound(8, m))
        violations += v
        total += t
        v_spray, _ = ref.global_envelope_violations(got, m)
        assert v_spray <= v
    assert total > 0
    assert violations / total < 0.05, (violations, total)


def test_multiq_tighter_than_spray_observed():
    def mean_rank(schedule, trials=15, m=8):
        errs = []
        for t in range(trials):
            st, ref = _filled(S=8, C=64, n=400, seed=200 + t)
            all_keys = np.sort(ref.key_multiset())
            sc, hi, cb = _draws(jax.random.key(t))
            res = O.delete_min(st, m, schedule=schedule, active=m,
                               draws=(sc, cb if schedule == TS.MULTIQ
                                      else hi))
            got = res.keys.numpy()[: int(res.n_out)]
            errs.extend(int(np.searchsorted(all_keys, k, side="left"))
                        for k in got)
        return float(np.mean(errs))

    assert mean_rank(TS.MULTIQ) <= mean_rank(TS.SPRAY_HERLIHY) + 1.0


def test_mixed_op_batch_linearization():
    st, ref = _filled()
    rng = np.random.default_rng(7)
    ops = rng.integers(0, 2, 16).astype(np.int32)
    keys = rng.integers(0, 5000, 16).astype(np.int32)
    vals = rng.integers(0, 99, 16).astype(np.int32)
    r = O.apply_op_batch(st, _t(ops), _t(keys), _t(vals),
                         schedule=TS.STRICT_FLAT)
    ref.insert_batch(keys, vals, mask=ops == O.OP_INSERT)
    rk, _ = ref.delete_min_exact(int((ops == O.OP_DELETE_MIN).sum()))
    np.testing.assert_array_equal(
        r.deleted_keys.numpy()[: int(r.n_deleted)], rk)


def test_empty_queue_delete():
    res = O.delete_min(make_state(4, 16, device="cpu"), 8,
                       schedule=TS.STRICT_FLAT, active=8)
    assert int(res.n_out) == 0
    assert bool((res.keys == INF_KEY).all())


def test_capacity_overflow_reported():
    st, dropped = O.insert(make_state(2, 4, device="cpu"),
                           torch.arange(32, dtype=torch.int32),
                           torch.zeros(32, dtype=torch.int32))
    assert int(st.total_size) == 8
    assert int(dropped.sum()) == 32 - 8
    ref = RefPQ(2, 4)
    assert ref.insert_batch(np.arange(32, dtype=np.int32),
                            np.zeros(32, np.int32)) == 24


# ---------------------------------------------------------------------------
# the classifier's trace datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make,window", [
    (lambda M: M.size_ramp_trace(seed=9), 4),
    (lambda M: M.bursty_des_trace(seed=2), 8),
    (lambda M: M.phase_flip_trace(seed=1)._replace(
        init_keys=np.arange(500, dtype=np.int32),
        init_vals=np.zeros(500, np.int32)), 5),
])
def test_examples_from_trace_match_jax(make, window):
    jx, jy = j_examples_from_trace(make(JT), window=window)
    tx, ty = examples_from_trace(make(TT), window=window)
    for a, b in ((jx, tx), (jy, ty)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert np.all((0 <= ty) & (ty < NUM_CLASSES))


def test_trace_sets_match_jax_and_train_the_same_tree():
    for jset, tset in ((j_trace_training_set(seeds=(0, 3)),
                        make_trace_training_set(seeds=(0, 3))),
                       (j_trace_test_set(), make_trace_test_set()),
                       (j_mixed_training_set(), make_mixed_training_set())):
        for a, b in zip(jset, tset):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    X, y = make_mixed_training_set()
    jp = j_pack_tree(j_train_tree(*j_mixed_training_set(), NUM_CLASSES,
                                  max_depth=8))
    tp = pack_arrays(train_tree(X, y, NUM_CLASSES, max_depth=8))
    for f in ("feature", "threshold", "left", "right", "label"):
        a = np.asarray(getattr(jp, f))
        assert a.dtype == tp[f].dtype
        np.testing.assert_array_equal(a, tp[f], err_msg=f)
    assert jp.depth == tp["depth"]
