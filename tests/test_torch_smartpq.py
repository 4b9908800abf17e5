"""Parity of the port's SmartPQ with the JAX package, on the CPU.

The configurations are the default three-mode SmartPQ (SPRAY_HERLIHY,
MULTIQ, HIER for classes 0, 1, 2), the paper's two-mode one (the spray for
classes 0 and 1) and single-schedule ones.  The port's `run_window` must be
bit-identical to the JAX `SmartPQ.jit_run_window` — per-step outputs, the
mode trace, every state leaf and stats field, dtypes included — with the
reference's spray and MULTIQ draws injected, at the small coordinates of
tests/test_fused_window.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.classifier.dataset import make_test_set as j_test_set
from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.features import featurize_jnp
from repro.core.classifier.inference import pack_tree as j_pack_tree
from repro.core.classifier.inference import (
    tree_predict_batch as j_tree_predict_batch,
)
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.pqueue.schedules import Schedule as JS
from repro.core.smartpq import SmartPQ as JPQ
from repro.core.smartpq import SmartPQConfig as JCfg
from repro.core.smartpq import carry_fingerprint as j_carry_fingerprint
from repro.workloads import traces as JT
import repro_torch.core.pqueue.local as TL
from repro_torch import convert
from repro_torch.core.classifier.dataset import make_test_set, make_training_set
from repro_torch.core.classifier.features import featurize_t
from repro_torch.core.classifier.inference import pack_arrays, tree_predict_batch
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.pqueue.schedules import Schedule as TS
from repro_torch.core.smartpq import SmartPQ as TPQ
from repro_torch.core.smartpq import SmartPQConfig as TCfg
from repro_torch.core.smartpq import carry_fingerprint as t_carry_fingerprint
from repro_torch.workloads import traces as TT

# The tensors here are small: one intra-op thread per test process keeps
# torch from contending for the cores with the suite's other workers.
torch.set_num_threads(1)

S, C, B, K = 8, 512, 32, 5
TWO_MODE = ("SPRAY_HERLIHY", "SPRAY_HERLIHY", "HIER")
THREE_MODE = ("SPRAY_HERLIHY", "MULTIQ", "HIER")


@pytest.fixture(scope="module")
def trees():
    """The classifier trained by each package from its own copy of the
    analytic training set."""
    X, y = make_training_set()
    Xj, yj = j_training_set()
    return j_train_tree(Xj, yj, 4, max_depth=8), train_tree(X, y, 4,
                                                             max_depth=8)


def _pair(trees, schedules=TWO_MODE, **kw):
    cfg = dict(num_shards=S, capacity=C, npods=2, decision_interval=2, **kw)
    jpq = JPQ(JCfg(mode_schedules=tuple(JS[s] for s in schedules), **cfg),
              tree=trees[0])
    tpq = TPQ(TCfg(mode_schedules=tuple(TS[s] for s in schedules), **cfg),
              tree=trees[1], device="cpu")
    return jpq, tpq


def _window(seed, ins_frac=0.5, key_range=4096, num_clients=64):
    rng = np.random.default_rng(seed)
    ops = (rng.random((K, B)) > ins_frac).astype(np.int32)
    keys = rng.integers(0, key_range, (K, B)).astype(np.int32)
    vals = rng.integers(0, 99, (K, B)).astype(np.int32)
    rngs = jax.random.split(jax.random.key(seed), K)
    nc = np.broadcast_to(np.asarray(num_clients, np.int32), (K,)).copy()
    return ops, keys, vals, rngs, nc


def _draws(rngs, H, S=S, B=B):
    """The reference's per-step draws from the window's step keys: the
    spray core's (shard_choice, hi) (schedules.py:252-256,275-276) and the
    MULTIQ core's second choice (schedules.py:323-328); its first choice is
    shard_choice, the same call on the same key."""
    pad = (max(int(S - 1).bit_length(), 1) + 1) ** 2
    W = min(B + pad, H)
    sc, hi, cb = [], [], []
    for r in rngs:
        k_shard, k_pos = jax.random.split(r)
        sc.append(np.asarray(jax.random.randint(k_shard, (B,), 0, S)))
        hi.append(np.asarray(jax.random.randint(
            k_pos, (S, W), 0, (1 << 31) // (W + 1) - 1, dtype=jnp.int32)))
        cb.append(np.asarray(jax.random.randint(k_pos, (B,), 0, S)))
    return tuple(torch.as_tensor(np.stack(x)) for x in (sc, hi, cb))


def _t(a):
    return torch.as_tensor(np.array(a))


def _run_both(jpq, tpq, jc, tc, window, mode_override=None):
    ops, keys, vals, rngs, nc = window
    jov = None if mode_override is None else jnp.asarray(mode_override)
    tov = None if mode_override is None else _t(mode_override)
    jc, jr = jpq.jit_run_window(jc, jnp.asarray(ops), jnp.asarray(keys),
                                jnp.asarray(vals), rngs, jnp.asarray(nc), jov)
    tc, tr = tpq.run_window(tc, _t(ops), _t(keys), _t(vals),
                            draws=_draws(rngs, tc.state.head_width,
                                         S=tc.state.num_shards,
                                         B=ops.shape[1]),
                            num_clients=_t(nc), mode_override=tov)
    _assert_equal(jr, tr, ("keys", "vals", "n_out", "mode"))
    _assert_carry_equal(jc, tc)
    return jc, tc, tr



def _assert_equal(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), getattr(b, f).cpu().numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_carry_equal(jc, tc):
    _assert_equal(jc.state, tc.state,
                  [f.name for f in dataclasses.fields(jc.state)])
    _assert_equal(jc.stats, tc.stats, jc.stats._fields)
    assert j_carry_fingerprint(jc) == t_carry_fingerprint(tc)


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------


def test_same_data_trains_the_same_packed_tree(trees):
    jp = j_pack_tree(trees[0])
    tp = pack_arrays(trees[1])
    for f in ("feature", "threshold", "left", "right", "label"):
        a = np.asarray(getattr(jp, f))
        assert a.dtype == tp[f].dtype
        np.testing.assert_array_equal(a, tp[f], err_msg=f)
    assert jp.depth == tp["depth"]


def test_test_set_and_its_predictions_match(trees):
    """The off-grid test set (paper 4.2.1) is the same in both packages, and
    the port's packed tree classifies it as the JAX one does."""
    jx, jy, jb = j_test_set(n=500, seed=3)
    tx, ty, tb = make_test_set(n=500, seed=3)
    for a, b in ((jx, tx), (jy, ty), (jb, tb)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    want = np.asarray(j_tree_predict_batch(j_pack_tree(trees[0]),
                                           jnp.asarray(jx)))
    tpk = convert.packed_tree_from_numpy(pack_arrays(trees[1]), device="cpu")
    np.testing.assert_array_equal(
        tree_predict_batch(tpk, torch.as_tensor(tx)).numpy(), want)


def test_features_within_one_ulp_and_class_trace_exact(trees):
    """float32 log2 may differ by one ulp between XLA and torch; the tree
    must still reach the same class for every input."""
    rng = np.random.default_rng(0)
    nc = np.concatenate([[1, 2, 8, 16, 64, 384, 512],
                         rng.integers(1, 513, 200)]).astype(np.int32)
    n = nc.size
    size = np.concatenate([2 ** np.arange(7), rng.integers(0, 1 << 22, n - 7)])
    kr = np.concatenate([2 ** np.arange(11, 18),
                         rng.integers(1, 1 << 28, n - 7)])
    frac = (rng.integers(0, 65, n) / np.maximum(rng.integers(0, 65, n), 1))
    frac = np.minimum(frac, 1.0).astype(np.float32)
    jf = np.stack([np.asarray(featurize_jnp(jnp.int32(a), jnp.int32(b),
                                            jnp.int32(c), jnp.float32(d)))
                   for a, b, c, d in zip(nc, size, kr, frac)])
    tf = torch.stack([featurize_t(_t(np.int32(a)), _t(np.int32(b)),
                                  _t(np.int32(c)), _t(np.float32(d)))
                      for a, b, c, d in zip(nc, size, kr, frac)])
    assert tf.dtype == torch.float32
    ulps = np.abs(jf.view(np.int32).astype(np.int64)
                  - tf.numpy().view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    want = np.asarray(j_tree_predict_batch(j_pack_tree(trees[0]),
                                           jnp.asarray(jf)))
    tpk = convert.packed_tree_from_numpy(pack_arrays(trees[1]), device="cpu")
    np.testing.assert_array_equal(tree_predict_batch(tpk, tf).numpy(), want)


# ---------------------------------------------------------------------------
# the fused window, four ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedules", [TWO_MODE, ("SPRAY_HERLIHY",) * 3,
                                       ("HIER",) * 3, THREE_MODE,
                                       ("MULTIQ",) * 3],
                         ids=["adaptive", "spray", "hier", "three_mode",
                              "multiq"])
def test_run_window_bitmatches_jax(trees, schedules):
    jpq, tpq = _pair(trees, schedules)
    jc, tc = jpq.init(), tpq.init()
    for w, ins_frac in enumerate((0.7, 0.5, 0.3)):
        jc, tc, _ = _run_both(jpq, tpq, jc, tc, _window(w, ins_frac))


def test_run_window_with_mode_override_bitmatches_jax(trees):
    jpq, tpq = _pair(trees, head_width=64)
    jc, tc = jpq.init(), tpq.init()
    for w, ov in enumerate(([-1, 0, 2, -1, 2], [2, 2, -1, 1, 0],
                            [-1, -1, -1, 2, 0])):
        jc, tc, tr = _run_both(jpq, tpq, jc, tc, _window(10 + w, 0.6),
                               mode_override=np.asarray(ov, np.int32))
        pinned = np.asarray(ov) >= 0
        np.testing.assert_array_equal(tr.mode.numpy()[pinned],
                                      np.asarray(ov)[pinned])


def test_longer_run_visits_both_modes_refills_and_compacts(trees,
                                                           monkeypatch):
    """Insert-heavy windows grow the queue, drain-heavy ones shrink it, and
    the active-client feature alternates: both modes run, the head refills
    from the tail and the tail compacts — bit-identical to JAX throughout."""
    compactions = []
    compact = TL.compact_tail
    monkeypatch.setattr(TL, "compact_tail",
                        lambda st: compactions.append(1) or compact(st))
    jpq, tpq = _pair(trees, head_width=64)
    jc, tc = jpq.init(), tpq.init()
    alternate = np.where(np.arange(K) % 2 == 0, 8, 64)
    for w in range(10):
        nc = alternate if w % 2 else 64
        jc, tc, _ = _run_both(jpq, tpq, jc, tc,
                              _window(100 + w, 0.9 if w < 6 else 0.35,
                                      num_clients=nc))
    steps = tc.stats.mode_steps.numpy()
    assert steps[0] + steps[1] > 0 and steps[2] > 0, steps
    assert int(tc.stats.transitions) > 0
    assert int(tc.stats.head_refills) > 0
    assert compactions


def test_run_window_equals_k_steps(trees):
    """The port's window is K of its own steps (smartpq.py:393-397)."""
    _, tpq = _pair(trees, head_width=64)
    ops, keys, vals, rngs, nc = _window(5, 0.5)
    sc, hi, _ = _draws(rngs, 64)
    cw, rw = tpq.run_window(tpq.init(), _t(ops), _t(keys), _t(vals),
                            draws=(sc, hi), num_clients=64)
    cs = tpq.init()
    for k in range(K):
        cs, res = tpq.step(cs, _t(ops[k]), _t(keys[k]), _t(vals[k]),
                           draws=(sc[k], hi[k]), num_clients=64)
        for f in ("keys", "vals", "n_out"):
            assert torch.equal(getattr(res, f), getattr(rw, f)[k])
        assert torch.equal(cs.stats.mode, rw.mode[k])
    assert t_carry_fingerprint(cs) == t_carry_fingerprint(cw)


def test_jax_carry_carries_across(trees):
    """A carry the JAX package built continues in the port exactly."""
    jpq, tpq = _pair(trees)
    ops, keys, vals, rngs, nc = _window(21, 0.8)
    jc, _ = jpq.jit_run_window(jpq.init(), jnp.asarray(ops),
                               jnp.asarray(keys), jnp.asarray(vals), rngs,
                               jnp.asarray(nc))
    state = {f.name: np.asarray(getattr(jc.state, f.name))
             for f in dataclasses.fields(jc.state)}
    stats = {f: np.asarray(v) for f, v in jc.stats._asdict().items()}
    tc = convert.carry_from_numpy(state, stats, device="cpu")
    _assert_carry_equal(jc, tc)
    back_state, back_stats = convert.carry_to_numpy(tc)
    assert all(np.array_equal(back_state[f], state[f]) for f in state)
    assert all(np.array_equal(back_stats[f], stats[f]) for f in stats)
    _run_both(jpq, tpq, jc, tc, _window(22, 0.4))


# ---------------------------------------------------------------------------
# the default three-mode SmartPQ
# ---------------------------------------------------------------------------


def test_default_config_constructs_and_runs():
    """`SmartPQ()` takes the default three-mode config, trains its own tree
    and runs a window from a `torch.Generator`; forcing mode 1 runs MULTIQ."""
    pq = TPQ(device="cpu")
    assert tuple(pq.config.mode_schedules) == tuple(
        TS[s] for s in THREE_MODE)
    ops, keys, vals, _, _ = _window(30, 0.5)
    gen = torch.Generator().manual_seed(0)
    carry, res = pq.run_window(pq.init(), _t(ops), _t(keys), _t(vals),
                               mode_override=1, generator=gen)
    assert res.mode.tolist() == [1] * K
    assert int(carry.stats.mode_steps[1]) == K
    admitted = int(np.sum(ops == 0))
    assert int(carry.state.total_size) == admitted - int(res.n_out.sum())
    assert int(res.n_out.sum()) > 0
    assert not pq.validate_carry(carry)


def test_three_mode_window_with_mode_override_bitmatches_jax(trees):
    """Overrides pin every mode, MULTIQ (1) among them, between steps the
    classifier decides."""
    jpq, tpq = _pair(trees, THREE_MODE, head_width=64)
    jc, tc = jpq.init(), tpq.init()
    for w, ov in enumerate(([-1, 1, 1, -1, 2], [1, 0, -1, 1, 1],
                            [-1, -1, 1, 2, 0])):
        jc, tc, tr = _run_both(jpq, tpq, jc, tc, _window(40 + w, 0.6),
                               mode_override=np.asarray(ov, np.int32))
        pinned = np.asarray(ov) >= 0
        np.testing.assert_array_equal(tr.mode.numpy()[pinned],
                                      np.asarray(ov)[pinned])
    assert int(tc.stats.mode_steps[1]) >= 6


def test_bursty_three_phase_trace_visits_every_mode(trees):
    """The three-phase trace of tests/test_smartpq.py:125-170 (the bursty
    M/M/1 profile): many clients inserting, then a mixed load from few
    clients, then a delete-heavy one drive oblivious -> MULTIQ -> aware, step
    for step as the JAX package does."""
    cfg = dict(num_shards=8, capacity=1024, npods=2, decision_interval=2)
    jpq = JPQ(JCfg(**cfg), tree=trees[0])
    tpq = TPQ(TCfg(**cfg), tree=trees[1], device="cpu")
    Bw = 128
    rng = np.random.default_rng(0)
    ops, keys, clients = [], [], []
    for d, p, steps in TT.BURSTY_PHASES:
        for _ in range(steps):
            ops.append((rng.random(Bw) > p).astype(np.int32))
            keys.append(rng.integers(0, 16384, Bw).astype(np.int32))
            clients.append(d)
    ops, keys = np.stack(ops), np.stack(keys)
    Kw = ops.shape[0]
    window = (ops, keys, np.zeros((Kw, Bw), np.int32),
              jax.random.split(jax.random.key(1), Kw),
              np.asarray(clients, np.int32))
    _, tc, tr = _run_both(jpq, tpq, jpq.init(), tpq.init(), window)
    modes = tr.mode.tolist()
    p1 = TT.BURSTY_PHASES[0][2]
    p2 = p1 + TT.BURSTY_PHASES[1][2]
    assert 0 in modes[:p1] and 1 in modes[p1:p2] and 2 in modes[p2:], modes
    assert int(tc.stats.transitions) >= 2


def test_paper_mix_trace_multiq_to_spray_bitmatches_jax(trees):
    """The paper's Fig. 10 c_mix trace (Table 2, 22 clients) at the
    benchmark's coordinates (benchmarks/fig10_dynamic.py:25-31,60-66): 16
    shards, 8192 keys prefilled.  MULTIQ, then the spray once the deletes
    stop."""
    cfg = dict(num_shards=16, capacity=1 << 15, npods=2, decision_interval=2)
    jpq = JPQ(JCfg(**cfg), tree=trees[0])
    tpq = TPQ(TCfg(**cfg), tree=trees[1], device="cpu")
    phases = TT.TABLE2["c_mix"]
    trace = TT.phased_trace(phases, steps_per_phase=6, seed=0)
    keys = np.random.default_rng(0).integers(
        0, phases[0]["key_range"], 8192).astype(np.int32)
    vals = np.zeros_like(keys)
    jc = jpq.init()
    jc = jc._replace(state=JT.prefill(jc.state, keys, vals))
    state = {f.name: np.asarray(getattr(jc.state, f.name))
             for f in dataclasses.fields(jc.state)}
    tc = tpq.init()._replace(state=convert.state_from_numpy(state, "cpu"))
    window = (trace.ops, trace.keys, trace.vals, JT.trace_rngs(trace),
              trace.num_clients)
    _, _, tr = _run_both(jpq, tpq, jc, tc, window)
    assert {0, 1} <= set(tr.mode.tolist()), tr.mode.tolist()


def test_mode_steps_and_host_prediction_match_jax(trees):
    """`make_mode_steps`: one step function per mode on one state, each
    bit-identical to the JAX one; `predict_mode_host` agrees too."""
    jpq, tpq = _pair(trees, THREE_MODE, head_width=64)
    keys = np.random.default_rng(50).integers(0, 4096, 300).astype(np.int32)
    jstate = JT.prefill(jpq.init().state, keys, keys % 97)
    tstate = convert.state_from_numpy(
        {f.name: np.asarray(getattr(jstate, f.name))
         for f in dataclasses.fields(jstate)}, "cpu")
    jsteps, tsteps = jpq.make_mode_steps(), tpq.make_mode_steps()
    assert sorted(jsteps) == sorted(tsteps) == [0, 1, 2]
    o, k, v, r, _ = _window(51, 0.3)
    draws = tuple(d[0] for d in _draws(r[:1], 64))
    for mode in (0, 1, 2):
        jr = jsteps[mode](jax.tree.map(jnp.copy, jstate), jnp.asarray(o[0]),
                          jnp.asarray(k[0]), jnp.asarray(v[0]), r[0])
        tr = tsteps[mode](tstate, _t(o[0]), _t(k[0]), _t(v[0]), draws=draws)
        _assert_equal(jr, tr, ("keys", "vals", "n_out"))
        _assert_equal(jr.state, tr.state,
                      [f.name for f in dataclasses.fields(jr.state)])
    for point in ((64, 4000, 4096, 0.5), (16, 3000, 1 << 20, 0.6),
                  (512, 100, 1 << 14, 0.95), (8, 1 << 16, 1 << 24, 0.1)):
        assert tpq.predict_mode_host(*point) == jpq.predict_mode_host(*point)
