"""Parity of the port's trace pipeline (`repro_torch.workloads.traces`)
with the JAX package's: the generators and arrival processes give the same
arrays, the open-loop request streams the same requests, the npz format is shared both ways, a damaged file raises the typed
error with the reference's message, `replay` is bit-identical to the
reference's `jit_run_window` with the reference's draws injected, and
`prefill` equals the reference's bulk insert.  Integer outputs must be
bit-equal: the tolerance is zero.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.errors import TraceCorruptError as JTraceCorruptError
from repro.core.pqueue.schedules import Schedule as JS
from repro.core.pqueue.state import make_state as j_make_state
from repro.core.smartpq import SmartPQ as JPQ
from repro.core.smartpq import SmartPQConfig as JCfg
from repro.faults import FaultSpec, corrupt_trace_npz
from repro.workloads import des as JD
from repro.workloads import traces as JT
from repro_torch import convert
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.errors import InvariantViolation, TraceCorruptError
from repro_torch.core.pqueue.schedules import Schedule as TS
from repro_torch.core.pqueue.state import (INF_KEY, invariant_violations,
                                           make_state)
from repro_torch.core.smartpq import SmartPQ as TPQ
from repro_torch.core.smartpq import SmartPQConfig as TCfg
from repro_torch.workloads import traces as TT
from torch_draws import draws_from_keys, window_keys

torch.set_num_threads(1)

FIELDS = ("ops", "keys", "vals", "num_clients", "init_keys", "init_vals")


def _assert_trace_equal(want, got):
    assert got.seed == want.seed
    for f in FIELDS:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# generators and arrival processes
# ---------------------------------------------------------------------------

GENERATORS = {
    "phase_flip": lambda M, s: M.phase_flip_trace(seed=s),
    "phase_flip_narrow": lambda M, s: M.phase_flip_trace(
        B=32, steps_per_phase=4, n_flips=5, key_range=1000, seed=s),
    "size_ramp": lambda M, s: M.size_ramp_trace(seed=s),
    "size_ramp_short": lambda M, s: M.size_ramp_trace(
        B=16, steps_per_phase=3, seed=s),
    "mix_drift": lambda M, s: M.mix_drift_trace(seed=s),
    "mix_drift_one_step": lambda M, s: M.mix_drift_trace(steps=1, seed=s),
    "bursty_des": lambda M, s: M.bursty_des_trace(seed=s),
    "bursty_des_quick": lambda M, s: M.bursty_des_trace(
        B=64, phases=M.BURSTY_PHASES_QUICK, mean_interarrival=7, seed=s),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("seed", [0, 5, 101])
def test_generators_match_jax(name, seed):
    _assert_trace_equal(GENERATORS[name](JT, seed), GENERATORS[name](TT, seed))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_arrival_counts_and_hash_match_jax(seed):
    for args in ((64, 12.0), (200, 0.5), (1, 3.0)):
        a = JT.poisson_arrival_counts(*args, seed=seed)
        b = TT.poisson_arrival_counts(*args, seed=seed)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for kw in ({}, dict(rates=(20.0, 2.0, 0.1), mean_dwell=(4.0, 8.0, 2.0))):
        a = JT.mmpp_arrival_counts(300, seed=seed, **kw)
        b = TT.mmpp_arrival_counts(300, seed=seed, **kw)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    uids = np.arange(0, 5000, 7, dtype=np.int64) + seed * (1 << 33)
    np.testing.assert_array_equal(JT._hash_u32(uids, seed * 3 + 1),
                                  TT._hash_u32(uids, seed * 3 + 1))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_request_streams_match_jax(seed):
    """`open_loop_requests` (default and custom class weights, ranges and
    uid base) and `bursty_serve_workload` give the reference's requests,
    field by field, as the port's `Request`."""
    from repro_torch.serve import Request

    counts = JT.poisson_arrival_counts(48, 9.5, seed=seed)
    pairs = [(JT.open_loop_requests(counts, seed=seed, **kw),
              TT.open_loop_requests(counts, seed=seed, **kw))
             for kw in ({}, dict(uid_base=1000, slo_weights=(1, 1, 2, 4),
                                 prompt_range=(1, 3),
                                 new_tokens_range=(5, 6)))]
    pairs.append((JT.bursty_serve_workload(steps=64, seed=seed),
                  TT.bursty_serve_workload(steps=64, seed=seed)))
    for want, got in pairs:
        assert [len(t) for t in got] == [len(t) for t in want]
        assert sum(map(len, got)) > 0
        for wt, gt in zip(want, got):
            for w, g in zip(wt, gt):
                assert type(g) is Request
                assert dataclasses.asdict(g) == dataclasses.asdict(w)


# ---------------------------------------------------------------------------
# the npz format: shared both ways, typed errors on damage
# ---------------------------------------------------------------------------


def _recorded_trace():
    """A reference trace with pre-fill arrays: phase_flip with init keys."""
    tr = JT.phase_flip_trace(B=32, steps_per_phase=3, seed=7)
    keys = np.random.default_rng(7).integers(0, 1 << 14, 300).astype(np.int32)
    return tr._replace(init_keys=keys, init_vals=keys % 97, seed=123)


def test_trace_saved_by_jax_loads_in_port_and_back(tmp_path):
    tr = _recorded_trace()
    JT.save_trace(tmp_path / "jax.npz", tr)
    _assert_trace_equal(tr, TT.load_trace(tmp_path / "jax.npz"))
    TT.save_trace(tmp_path / "torch", tr)  # the suffix is appended
    _assert_trace_equal(tr, JT.load_trace(tmp_path / "torch.npz"))
    assert (tmp_path / "torch.npz").read_bytes() == (
        tmp_path / "jax.npz").read_bytes()


def _bad_traces():
    tr = JT.phase_flip_trace(B=8, steps_per_phase=2, seed=1)
    illegal = tr.ops.copy()
    illegal[3, 5] = 7
    return {
        "ops_1d": tr._replace(ops=tr.ops[0]),
        "ops_float": tr._replace(ops=tr.ops.astype(np.float32)),
        "keys_shape": tr._replace(keys=tr.keys[:, :4]),
        "vals_shape": tr._replace(vals=tr.vals[:-1]),
        "num_clients_shape": tr._replace(num_clients=tr.num_clients[:3]),
        "illegal_op": tr._replace(ops=illegal),
        "init_mismatch": tr._replace(init_keys=np.zeros(3, np.int32)),
    }


@pytest.mark.parametrize("case", sorted(_bad_traces()))
def test_validate_trace_raises_the_references_error(case):
    tr = _bad_traces()[case]
    with pytest.raises(JTraceCorruptError) as want:
        JT.validate_trace(tr, path="x.npz")
    with pytest.raises(TraceCorruptError) as got:
        TT.validate_trace(tr, path="x.npz")
    assert str(got.value) == str(want.value)
    assert got.value.code == want.value.code == "TRACE_CORRUPT"
    assert got.value.detail == want.value.detail and got.value.path == "x.npz"


def test_trace_corrupt_bumps_errors_total(tmp_path):
    """Each refused trace counts ``errors_total{code=TRACE_CORRUPT}`` in the
    process-wide metrics before the typed error, as the reference's does
    (src/repro/workloads/traces.py:129-131,146-148)."""
    from repro_torch import obs

    prev = obs.set_default(obs.Observability())
    try:
        m = obs.get_default().metrics
        bad = _bad_traces()
        for tr in bad.values():
            with pytest.raises(TraceCorruptError):
                TT.validate_trace(tr)
        assert m.value("errors_total", code="TRACE_CORRUPT") == len(bad)
        (tmp_path / "cut.npz").write_bytes(b"PK\x03\x04 not a zip")
        with pytest.raises(TraceCorruptError, match="unreadable npz"):
            TT.load_trace(tmp_path / "cut.npz")
        assert m.value("errors_total", code="TRACE_CORRUPT") == len(bad) + 1
    finally:
        obs.set_default(prev)


@pytest.mark.parametrize("variant", ["truncate", "flip", "missing_array"])
def test_damaged_npz_raises_typed_error(tmp_path, variant):
    p = tmp_path / "trace.npz"
    tr = JT.phased_trace(JT.TABLE2["c_mix"], steps_per_phase=2, seed=7)
    if variant == "missing_array":
        np.savez(p, ops=tr.ops, keys=tr.keys, vals=tr.vals)
    else:
        JT.save_trace(p, tr)
        _assert_trace_equal(tr, TT.load_trace(p))
        corrupt_trace_npz(p, FaultSpec(kind="corrupt_trace_npz", seed=3,
                                       rate=0.5, variant=variant))
    with pytest.raises(JTraceCorruptError) as want:
        JT.load_trace(p)
    with pytest.raises(TraceCorruptError) as got:
        TT.load_trace(p)
    assert str(got.value) == str(want.value)
    assert got.value.code == "TRACE_CORRUPT"


# ---------------------------------------------------------------------------
# replay through run_window
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees():
    return (j_train_tree(*j_training_set(), 4, max_depth=8),
            train_tree(*make_training_set(), 4, max_depth=8))


def _pair(trees, schedules=("SPRAY_HERLIHY", "MULTIQ", "HIER"), **kw):
    cfg = dict(num_shards=8, capacity=1024, npods=2, decision_interval=2,
               **kw)
    return (JPQ(JCfg(mode_schedules=tuple(JS[s] for s in schedules), **cfg),
                tree=trees[0]),
            TPQ(TCfg(mode_schedules=tuple(TS[s] for s in schedules), **cfg),
                tree=trees[1], device="cpu"))


def _assert_carry_equal(jc, tc):
    state, stats = convert.carry_to_numpy(tc)
    for f in dataclasses.fields(jc.state):
        a = np.asarray(getattr(jc.state, f.name))
        assert a.dtype == state[f.name].dtype, f.name
        np.testing.assert_array_equal(a, state[f.name], err_msg=f.name)
    for f in jc.stats._fields:
        a = np.asarray(getattr(jc.stats, f))
        assert a.dtype == stats[f].dtype, f
        np.testing.assert_array_equal(a, stats[f], err_msg=f)


REPLAYS = {
    "phase_flip": lambda: JT.phase_flip_trace(B=32, steps_per_phase=4,
                                              seed=7),
    "bursty_des_quick": lambda: JT.bursty_des_trace(
        phases=JT.BURSTY_PHASES_QUICK, seed=5),
    "with_prefill": _recorded_trace,
}


@pytest.mark.parametrize("name", sorted(REPLAYS))
def test_saved_trace_replays_bit_for_bit_against_jax(tmp_path, trees, name):
    """A trace the reference saved, loaded by the port and replayed with the
    reference's per-step draws: outputs, mode trace and every carry leaf
    equal the reference's `replay`."""
    tr = REPLAYS[name]()
    JT.save_trace(tmp_path / "t.npz", tr)
    loaded = TT.load_trace(tmp_path / "t.npz")
    jpq, tpq = _pair(trees)
    jc, jr = JT.replay(jpq, tr)
    draws = draws_from_keys(window_keys(tr.seed, tr.num_steps), 8,
                            tr.width, 256)
    tc, tr_res = TT.replay(tpq, loaded, draws=draws)
    for f in ("keys", "vals", "n_out", "mode"):
        a, b = np.asarray(getattr(jr, f)), getattr(tr_res, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    _assert_carry_equal(jc, tc)
    if name == "bursty_des_quick":
        assert len(set(tr_res.mode.tolist())) >= 2


def test_replay_without_draws_is_reproducible(trees):
    """Without draws, replay draws from a generator seeded with the trace's
    seed: two replays agree bit for bit."""
    tr = TT.bursty_des_trace(phases=TT.BURSTY_PHASES_QUICK, seed=2)
    _, tpq = _pair(trees)
    (c1, r1), (c2, r2) = TT.replay(tpq, tr), TT.replay(tpq, tr)
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)
    for a, b in zip(convert.carry_to_numpy(c1), convert.carry_to_numpy(c2)):
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_replay_with_validate_runs_validate_carry(trees, monkeypatch):
    tr = TT.phase_flip_trace(B=16, steps_per_phase=2, seed=4)
    _, quiet = _pair(trees)
    _, guarded = _pair(trees, validate=True)
    calls = []
    for pq in (quiet, guarded):
        check = pq.validate_carry
        monkeypatch.setattr(pq, "validate_carry",
                            lambda c, check=check: calls.append(1) or check(c))
    TT.replay(quiet, tr)
    assert calls == []
    TT.replay(guarded, tr)
    assert calls == [1]
    # a carry whose head is out of order trips the guard with the typed error
    carry = guarded.init()
    head = carry.state.head_keys.clone()
    head[0, :2] = torch.tensor([5, 3], dtype=torch.int32)
    size = carry.state.head_size.clone()
    size[0] = 2
    bad = carry._replace(state=dataclasses.replace(
        carry.state, head_keys=head, head_size=size))
    with pytest.raises(InvariantViolation):
        TT.replay(guarded, tr._replace(ops=np.full_like(tr.ops, 2)),
                  carry=bad)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _state_equal(jst, tst):
    for f in dataclasses.fields(jst):
        a = np.asarray(getattr(jst, f.name))
        b = getattr(tst, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("S,C,H,n", [(8, 4096, None, 3000), (4, 512, 64, 900),
                                     (16, 1024, 256, 1)])
def test_prefill_in_one_slice_matches_jax(S, C, H, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-50, 1 << 20, n).astype(np.int32)
    vals = rng.integers(0, 1 << 20, n).astype(np.int32)
    want = JT.prefill(j_make_state(S, C, head_width=H), keys, vals)
    got = TT.prefill(make_state(S, C, head_width=H, device="cpu"), keys,
                     vals)
    _state_equal(want, got)


def test_prefill_over_several_slices_holds_multiset_and_invariants(
        monkeypatch):
    """Narrow the slice to 64 keys (the merge's widest row less H): 1000
    keys go in 16 inserts and the queue holds the same (key, val) multiset
    as the reference's one insert, with invariants I1-I6."""
    S, C, H = 8, 512, 32
    monkeypatch.setattr(TT, "MAX_MERGE_WINDOW", H + 64)
    inserts = []
    insert = TT.O.insert
    monkeypatch.setattr(TT.O, "insert",
                        lambda *a, **k: inserts.append(1) or insert(*a, **k))
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 3000, 1000).astype(np.int32)
    vals = rng.integers(0, 99, 1000).astype(np.int32)
    got = TT.prefill(make_state(S, C, head_width=H, device="cpu"), keys,
                     vals)
    assert len(inserts) == 16
    assert not invariant_violations(got, first_only=False)
    want = JT.prefill(j_make_state(S, C, head_width=H), keys, vals)
    assert int(got.total_size) == int(want.total_size) == 1000

    def pairs(k, v):
        k, v = np.asarray(k).ravel(), np.asarray(v).ravel()
        live = k < INF_KEY
        return sorted(zip(k[live].tolist(), v[live].tolist()))

    assert pairs(got.keys, got.vals) == pairs(want.keys, want.vals)
    assert pairs(got.keys, got.vals) == sorted(zip(keys.tolist(),
                                                   vals.tolist()))


def test_prefill_raises_when_keys_are_dropped():
    st = make_state(2, 8, head_width=4, device="cpu")
    with pytest.raises(ValueError, match="dropped 4 of 20 keys"):
        TT.prefill(st, np.arange(20, dtype=np.int32),
                   np.zeros(20, np.int32))


def test_des_trace_recorded_by_jax_replays_in_port(trees):
    """A hold-model op log recorded by the reference (state-dependent keys,
    a pre-fill) replays in the port exactly as in the reference."""
    jpq, tpq = _pair(trees, ("STRICT_FLAT",) * 3)
    res = JD.run_hold_model(jpq, B=16, K=12, seed=5, record=True)
    jc, jr = JT.replay(jpq, res.trace)
    tc, tr = TT.replay(tpq, res.trace)
    np.testing.assert_array_equal(tr.keys.numpy()[:, :16], res.popped)
    np.testing.assert_array_equal(tr.keys.numpy(), np.asarray(jr.keys))
    _assert_carry_equal(jc, tc)
    assert int(np.sum(np.asarray(jr.n_out))) == int(tr.n_out.sum()) \
        == res.events
