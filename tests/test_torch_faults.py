"""Chaos tests of the port: every `repro_torch.faults` injector against the
reference's on the same input and `FaultSpec`, then driven through the
port's stack.

Each injector must reproduce the reference's fault exactly (the same
arrays, request streams, files or hook outputs; the tolerance is zero), and
the port must keep the reference's contract (tests/test_faults.py): an
injected fault is absorbed (sanitized, clamped, spilled to the backlog,
rolled back and retried) or surfaces as a typed error from
`repro_torch.core.errors`.  `tests/test_torch_hygiene.py` checks that every
name in `repro_torch.faults.INJECTORS` appears here.
"""

import dataclasses
import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.scheduler as JSM
from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.pqueue.state import PQState as JPQState
from repro.core.smartpq import SmartPQ as JPQ
from repro.core.smartpq import SmartPQCarry as JCarry
from repro.core.smartpq import SmartPQConfig as JCfg
from repro.core.smartpq import SmartPQStats as JStats
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import inject as j_inject
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.workloads import traces as JT
from repro_torch import convert
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.errors import TraceCorruptError, WindowValidationError
from repro_torch.core.pqueue.ops import OP_INSERT
from repro_torch.core.smartpq import (MODE_AWARE, NUM_MODES, SmartPQ,
                                      SmartPQConfig)
from repro_torch.faults import FaultSpec, inject
from repro_torch.obs import Observability, get_default
from repro_torch.serve import (DurabilityConfig, DurableStore, EngineConfig,
                               OverloadConfig, Request, ServeEngine,
                               SmartPQScheduler, WriteAheadLog)
from repro_torch.workloads import traces as TT
from torch_draws import draws_from_keys, window_keys

pytestmark = pytest.mark.chaos
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PHASES = [
    dict(num_clients=16, key_range=1_000, insert_frac=0.8),
    dict(num_clients=16, key_range=1_000, insert_frac=0.3),
]


@pytest.fixture(scope="module")
def trees():
    """(reference tree, port tree), the same tree; the reference's
    schedulers and engines get it without training their own."""
    jtree = j_train_tree(*j_training_set(), 4, max_depth=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSM, "SmartPQ", functools.partial(JPQ, tree=jtree))
        yield jtree, train_tree(*make_training_set(), 4, max_depth=8)


def _pq_cfg(validate=True):
    return dict(num_shards=4, capacity=512, decision_interval=4,
                validate=validate)


def _pq(trees, validate=True):
    return SmartPQ(SmartPQConfig(**_pq_cfg(validate)), tree=trees[1],
                   device="cpu")


def _sched(trees, validate=False, **kw):
    cfg = SmartPQConfig(num_shards=4, capacity=1024, decision_interval=4,
                        initial_mode=MODE_AWARE, validate=validate)
    return SmartPQScheduler(batch_size=8, pq_config=cfg, seed=0,
                            device="cpu", tree=trees[1], **kw)


def _reqs(n, uid0=0, step=0):
    return [Request(uid=uid0 + i, prompt_len=8 + i, max_new_tokens=4,
                    slo_class=i % 3, arrival_step=step) for i in range(n)]


def _both(target_j, target_t, **spec):
    """The reference's and the port's injector on their own targets."""
    return (j_inject(target_j, JFaultSpec(**spec)),
            inject(target_t, FaultSpec(**spec)))


def _requests(stream):
    return [[dataclasses.asdict(r) for r in tick] for tick in stream]


# ---------------------------------------------------------------------------
# trace-level faults
# ---------------------------------------------------------------------------


def test_nonfinite_keys_match_jax_and_are_rejected(trees):
    """`nonfinite_keys`: the same poisoned keys as the reference's; the
    port's replay (validated) refuses exactly those lanes into
    `stats.rejected`, and its carry and outputs equal the reference's
    replay of the reference's poisoned trace."""
    jt = JT.phased_trace(PHASES, steps_per_phase=4, seed=3)
    tt = TT.phased_trace(PHASES, steps_per_phase=4, seed=3)
    jbad, tbad = _both(jt, tt, kind="nonfinite_keys", seed=1, rate=0.3)
    assert tbad.keys.dtype == np.float32
    np.testing.assert_array_equal(tbad.keys, jbad.keys)
    expected = int(((tbad.ops == OP_INSERT) & ~np.isfinite(tbad.keys)).sum())
    assert expected > 0
    jpq = JPQ(JCfg(**_pq_cfg()), tree=trees[0])
    jc, jr = JT.replay(jpq, jbad)
    draws = draws_from_keys(window_keys(tbad.seed, tbad.num_steps), 4,
                            tbad.width, 64)
    tc, tr = TT.replay(_pq(trees), tbad, draws=draws)
    assert int(tc.stats.rejected) == expected == int(jc.stats.rejected)
    state, stats = convert.carry_to_numpy(tc)
    for f, got in {**state, **stats}.items():
        src = jc.state if f in state else jc.stats
        np.testing.assert_array_equal(np.asarray(getattr(src, f)), got,
                                      err_msg=f)
    for f in ("keys", "vals", "n_out", "mode"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)


def test_duplicate_keys_match_jax_and_are_absorbed(trees):
    """`duplicate_keys`: the same equal-key storm; legal input, so nothing
    is rejected and every invariant holds (validated replay)."""
    jt = JT.phased_trace(PHASES, steps_per_phase=4, seed=5)
    tt = TT.phased_trace(PHASES, steps_per_phase=4, seed=5)
    jdup, tdup = _both(jt, tt, kind="duplicate_keys", seed=2, rate=0.9)
    np.testing.assert_array_equal(tdup.keys, jdup.keys)
    assert not np.array_equal(tdup.keys, tt.keys)
    carry, _ = TT.replay(_pq(trees), tdup)
    assert int(carry.stats.rejected) == 0


@pytest.mark.parametrize("variant", ["truncate", "flip"])
def test_corrupt_trace_npz_matches_jax_and_raises_typed(tmp_path, variant):
    """`corrupt_trace_npz`: the same damaged bytes as the reference's; the
    port's loader raises `TraceCorruptError`, counted where it is raised."""
    p = tmp_path / "trace.npz"
    TT.save_trace(p, TT.phased_trace(PHASES, steps_per_phase=2, seed=7))
    q = tmp_path / "copy.npz"
    shutil.copy(p, q)
    _both(q, p, kind="corrupt_trace_npz", seed=3, rate=0.5, variant=variant)
    assert p.read_bytes() == q.read_bytes()
    before = get_default().metrics.value("errors_total", code="TRACE_CORRUPT")
    with pytest.raises(TraceCorruptError) as err:
        TT.load_trace(p)
    assert err.value.code == "TRACE_CORRUPT" and str(p) in str(err.value)
    after = get_default().metrics.value("errors_total", code="TRACE_CORRUPT")
    assert after == before + 1


# ---------------------------------------------------------------------------
# serving-workload faults
# ---------------------------------------------------------------------------


def test_ring_overflow_storm_matches_jax_bounded_and_accounted(trees):
    """`ring_overflow_storm`: the same storm stream as the reference's; on
    the port's scheduler with an overload controller the backlog stays
    capped, the host map holds in-flight work only, and every arrival is
    accounted for."""
    counts = TT.poisson_arrival_counts(24, 6.0, seed=3)
    spec = dict(kind="ring_overflow_storm", rate=1 / 8, magnitude=2.0)
    jstorm, storm = _both(JT.open_loop_requests(counts, seed=3),
                          TT.open_loop_requests(counts, seed=3), **spec)
    assert _requests(storm) == _requests(jstorm)
    total = sum(len(s) for s in storm)
    cap = 64
    sched = _sched(trees, ring_capacity=16, overload=OverloadConfig(
        targets=(8.0, 16.0, 32.0), backlog_cap=cap, min_samples=4))
    assert max(len(s) for s in storm) > sched.ring_capacity
    for w in range(0, len(storm), 4):
        chunk = storm[w:w + 4]
        sched.tick_window(chunk, [4] * len(chunk))
        assert len(sched._arrival_backlog) <= cap
        assert len(sched._requests) == sched.pending
    st = sched.stats
    assert st.inserted + len(sched._arrival_backlog) + st.shed \
        + st.evicted == total
    assert st.evicted + st.shed > 0


@pytest.mark.parametrize("variant", ["low", "high"])
def test_forecast_extreme_matches_jax_and_every_request_completes(trees,
                                                                  variant):
    """`forecast_extreme`: the same pinned estimate; the forecast is
    advisory, so every request still completes."""
    counts = TT.poisson_arrival_counts(12, 2.0, seed=9)
    workload = TT.open_loop_requests(counts, seed=9)
    ecfg = dict(batch_size=8, max_seq=256, sched_window=4, forecast=True)
    ref = JServeEngine(None, None, JEngineConfig(**ecfg), seed=1)
    eng = ServeEngine(None, None, EngineConfig(**ecfg), seed=1, device="cpu",
                      tree=trees[1])
    _both(ref, eng, kind="forecast_extreme", variant=variant, magnitude=64.0)
    assert eng._service_est == ref._service_est
    assert eng.run(workload, max_steps=800)["completed"] == sum(
        len(s) for s in workload) > 0


# ---------------------------------------------------------------------------
# core-state / classifier faults
# ---------------------------------------------------------------------------


def test_oob_tree_class_matches_jax_and_is_clamped(trees):
    """`oob_tree_class`: the same corrupted labels on the queue's device;
    the step's keep rule and clamp keep every realized mode in range."""
    jpq = JPQ(JCfg(**_pq_cfg()), tree=trees[0])
    pq = _pq(trees)
    _both(jpq, pq, kind="oob_tree_class", seed=4, rate=1.0)
    assert pq.packed.label.device == pq.device
    np.testing.assert_array_equal(pq.packed.label.numpy(),
                                  np.asarray(jpq.packed.label))
    assert (pq.packed.label.numpy() < 0).any()
    carry, res = TT.replay(pq, TT.phased_trace(PHASES, steps_per_phase=8,
                                               seed=11))
    modes = res.mode.numpy()
    assert ((modes >= 0) & (modes < NUM_MODES)).all()
    assert 0 <= int(carry.stats.mode) < NUM_MODES


def _jcarry(carry):
    state, stats = convert.carry_to_numpy(carry)
    return JCarry(JPQState(**{k: jnp.asarray(v) for k, v in state.items()}),
                  JStats(**{k: jnp.asarray(v) for k, v in stats.items()}))


@pytest.mark.parametrize("fill", [6, 0], ids=["reversed-head", "empty-shard"])
def test_corrupt_state_matches_jax(trees, fill):
    """`corrupt_state` on one carry in both packages: the same scrambled
    head tier (a reversed prefix, or a key planted in an empty shard's
    padding)."""
    sched = _sched(trees)
    sched.tick(_reqs(fill), 0)
    jbad, tbad = _both(_jcarry(sched.carry), sched.carry,
                       kind="corrupt_state", seed=1)
    np.testing.assert_array_equal(tbad.state.head_keys.numpy(),
                                  np.asarray(jbad.state.head_keys))
    assert not torch.equal(tbad.state.head_keys, sched.carry.state.head_keys)


def test_corrupt_state_rolls_back_and_surfaces_typed_error(trees):
    """tests/test_faults.py's rollback drill on the port: corruption that
    predates the checkpoint trips both attempts, the checkpoint is
    restored and `WindowValidationError` surfaces, for a tick and a
    window, every raise site counted."""
    obs = Observability()
    sched = _sched(trees, validate=True, obs=obs)
    sched.tick(_reqs(6), 0)
    assert sched.stats.failed_windows == 0
    pending_before = sched.pending
    sched.carry = inject(sched.carry, FaultSpec(kind="corrupt_state", seed=1))
    with pytest.raises(WindowValidationError) as err:
        sched.tick([], 0)
    assert err.value.code == "WINDOW_VALIDATION"
    assert err.value.first and err.value.retry
    assert sched.stats.failed_windows == 1
    assert sched.pending == pending_before
    with pytest.raises(WindowValidationError):
        sched.tick_window([[], []], [0, 0])
    assert sched.stats.failed_windows == 2
    assert sched.pending == pending_before
    assert obs.metrics.value("errors_total", code="WINDOW_VALIDATION") == 2
    assert obs.metrics.value("errors_total", code="INVARIANT") >= 4
    assert obs.metrics.value("sched_window_rollbacks_total") == 2


def test_validator_tripwire_matches_jax():
    """`validator_tripwire`: the same violations for the same calls."""
    spec = dict(kind="validator_tripwire", magnitude=2)
    jhook, hook = _both(None, None, **spec)
    for _ in range(4):
        assert [(v.invariant, v.shard, v.detail) for v in hook(None)] == \
            [(v.invariant, v.shard, v.detail) for v in jhook(None)]


def test_validator_tripwire_recovery_succeeds(trees):
    """One trip: rollback, the fallback retry validates, dispatch goes on."""
    hook = inject(None, FaultSpec(kind="validator_tripwire", magnitude=1))
    obs = Observability()
    sched = _sched(trees, validate_hook=hook, obs=obs)
    reqs = _reqs(4)
    sched.tick(reqs, 0)
    assert sched.stats.recovered_windows == 1
    assert sched.stats.failed_windows == 0
    assert obs.metrics.value("sched_windows_recovered_total") == 1
    assert obs.metrics.value("sched_window_rollbacks_total") == 1
    assert obs.metrics.value("errors_total", code="WINDOW_VALIDATION") == 0
    assert sched.pending == len(reqs)
    out = sched.tick([], 4)
    assert {r.uid for r in out} <= {r.uid for r in reqs} and len(out) == 4


def test_validator_tripwire_double_trip_surfaces_error(trees):
    """Two trips: a typed error with the state restored; the next window
    runs clean."""
    hook = inject(None, FaultSpec(kind="validator_tripwire", magnitude=2))
    sched = _sched(trees, validate_hook=hook)
    with pytest.raises(WindowValidationError):
        sched.tick(_reqs(4), 0)
    assert sched.stats.failed_windows == 1 and sched.pending == 0
    sched.tick(_reqs(4), 0)
    assert sched.stats.failed_windows == 1 and sched.pending == 4


def test_unknown_fault_kind_is_rejected():
    with pytest.raises(KeyError):
        inject(None, FaultSpec(kind="not_a_registered_fault"))


# ---------------------------------------------------------------------------
# durability faults
# ---------------------------------------------------------------------------


def _store(root, obs=None, **kw):
    return DurableStore(DurabilityConfig(dir=root, **kw), obs=obs)


def _log_windows(store, n=4):
    reqs = TT.open_loop_requests(TT.poisson_arrival_counts(n, 3.0, seed=1),
                                 seed=1)
    for t in range(n):
        store.log_window(t, [reqs[t]])
        store.log_commit(t + 1)


@pytest.mark.parametrize("variant", ["", "flip", "garbage"])
def test_torn_wal_matches_jax_prefix_recovered_and_truncated(tmp_path,
                                                             variant):
    """`torn_wal` on a store: the same torn bytes as the reference's; the
    port's recovery returns the intact prefix, truncates the file to it,
    and a second recovery is clean."""
    store = _store(tmp_path / "store")
    _log_windows(store)
    store.close()
    whole = WriteAheadLog(store.wal.path).recover()[0]
    assert len(whole) == 8
    shutil.copytree(tmp_path / "store", tmp_path / "ref")
    _both(tmp_path / "ref", store, kind="torn_wal", variant=variant,
          rate=0.5)
    assert store.wal.path.read_bytes() == \
        (tmp_path / "ref" / "wal.log").read_bytes()
    records, dropped_r, dropped_b = WriteAheadLog(store.wal.path).recover()
    assert records == whole[:len(records)]
    if variant == "flip":
        assert len(records) < len(whole)
    else:
        assert dropped_b > 0 and dropped_r >= 1
    assert WriteAheadLog(store.wal.path).recover() == (records, 0, 0)


def _snapshot_pair(tmp_path, values):
    """A store with two snapshots, and a byte copy of its directory."""
    obs = Observability()
    store = _store(tmp_path / "store", obs=obs)
    for step, tag, x in values:
        store.snapshot(step, {"x": x}, {"tag": tag})
    shutil.copytree(tmp_path / "store", tmp_path / "ref")
    return store, obs


def _same_dirs(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("variant", ["truncate", "delete"])
def test_partial_snapshot_matches_jax_and_falls_back(tmp_path, variant):
    """`partial_snapshot`: the same damaged shard as the reference's; the
    port's store skips the snapshot with accounting and loads the older
    one."""
    store, obs = _snapshot_pair(tmp_path, [
        (4, "old", np.arange(8, dtype=np.int32)),
        (8, "new", np.arange(8, dtype=np.int32) * 2)])
    _both(tmp_path / "ref", store, kind="partial_snapshot", variant=variant)
    _same_dirs(tmp_path / "store", tmp_path / "ref")
    got = store.load_newest_valid({"x": np.arange(8, dtype=np.int32)})
    assert got is not None
    step, tree_, extra = got
    assert step == 4 and extra["tag"] == "old"
    np.testing.assert_array_equal(tree_["x"], np.arange(8))
    assert store.stats.snapshots_skipped_invalid == 1
    assert obs.metrics.value("errors_total", code="SNAPSHOT_CORRUPT") == 1
    assert obs.metrics.value("snapshots_total") == 2


@pytest.mark.parametrize("variant", ["", "garbage"])
def test_stale_manifest_matches_jax_and_scans_to_valid(tmp_path, variant):
    """`stale_manifest`: the same damaged metadata as the reference's; the
    port's store scans newest first and loads a valid snapshot."""
    store, _ = _snapshot_pair(tmp_path, [
        (2, 2, np.full(4, 2, np.int64)), (6, 6, np.full(4, 6, np.int64))])
    _both(tmp_path / "ref", store, kind="stale_manifest", variant=variant)
    _same_dirs(tmp_path / "store", tmp_path / "ref")
    got = store.load_newest_valid({"x": np.zeros(4, np.int64)})
    assert got is not None
    want = 2 if variant == "garbage" else 6
    assert got[0] == want and got[2]["tag"] == want
    assert int(got[1]["x"][0]) == want


def test_crash_at_step_marker_disarms_inline(tmp_path, trees):
    """`crash_at_step` with the marker already there (an earlier
    incarnation crashed): a transparent wrapper, the run completes."""
    marker = tmp_path / "marker"
    marker.write_text("crashed\n")
    eng = ServeEngine(None, None, EngineConfig(batch_size=4), seed=0,
                      device="cpu", tree=trees[1])
    inject(eng, FaultSpec(kind="crash_at_step", magnitude=0.0,
                          variant=str(marker)))
    wl = TT.open_loop_requests(TT.poisson_arrival_counts(6, 2.0, seed=2),
                               seed=2)
    assert eng.run(wl, max_steps=64)["completed"] == sum(len(t) for t in wl)


def test_crash_at_step_kills_the_process(tmp_path):
    """`crash_at_step` armed (no marker yet): the wrapped step SIGKILLs the
    process at the chosen engine step, after writing the marker."""
    marker = tmp_path / "marker"
    code = (
        "from repro_torch.faults import FaultSpec, inject\n"
        "from repro_torch.serve import EngineConfig, ServeEngine\n"
        "from repro_torch.workloads.traces import (open_loop_requests,"
        " poisson_arrival_counts)\n"
        "eng = ServeEngine(None, None, EngineConfig(batch_size=2), seed=0,"
        " device='cpu')\n"
        f"inject(eng, FaultSpec(kind='crash_at_step', magnitude=2.0,"
        f" variant={str(marker)!r}))\n"
        "wl = open_loop_requests(poisson_arrival_counts(4, 2.0, 3), seed=3)\n"
        "eng.run(wl, max_steps=32)\n"
        "print('survived')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    assert marker.read_text() == "crashed\n"
