"""Parity of the port's durable serving tier (`repro_torch.core.persist`,
`repro_torch.serve.durability`, the durable `ServeEngine`, the supervisor
and the worker) with the JAX package's, on the CPU.

The recovery contract is the reference's (tests/test_durability.py): a
durable run that is paused or killed and restarted finishes bit-identical
to one that never stopped (completion set, done steps, outputs, the carry's
fingerprint, the conservation ledger).  Across the packages: the same
records give the same write-ahead-log bytes, each package recovers the
other's log (torn tails included), the port validates the reference's
snapshot directories and rejects the same damaged copies with the same
messages, and a port run with the reference's draws injected, paused and
resumed, equals the reference's uninterrupted run.  The tolerance is zero
throughout.  The slow drills SIGKILL a worker on the CPU mid-window.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

import repro.serve.scheduler as JSM
from repro.core import persist as jpersist
from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.smartpq import SmartPQ as JPQ
from repro.core.smartpq import carry_fingerprint as j_fingerprint
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import inject as j_inject
from repro.serve import durability as jdur
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.workloads.traces import bursty_serve_workload as j_bursty
from repro_torch.core import persist
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.errors import CrashLoopError, SnapshotCorruptError
from repro_torch.core.smartpq import carry_fingerprint
from repro_torch.faults import FaultSpec, inject
from repro_torch.serve import (DurabilityConfig, DurableStore, EngineConfig,
                               ServeEngine, Supervisor, SupervisorConfig,
                               WriteAheadLog)
from repro_torch.serve import durability as tdur
from repro_torch.workloads.traces import bursty_serve_workload
from torch_draws import draws_from_keys, scheduler_keys

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
H = 256  # the default queue's head width


@pytest.fixture(scope="module")
def tree():
    """The port's tree; the reference's engines get the reference's (the
    same tree) without training one for every scheduler."""
    jtree = j_train_tree(*j_training_set(), 4, max_depth=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSM, "SmartPQ", functools.partial(JPQ, tree=jtree))
        yield train_tree(*make_training_set(), 4, max_depth=8)


# ---------------------------------------------------------------------------
# the write-ahead log
# ---------------------------------------------------------------------------


def _records():
    """Window, shed, evict and commit records as the engine writes them,
    from the reference's bursty workload."""
    wl = j_bursty(steps=12, seed=4)
    out = []
    for t in range(0, 12, 4):
        out.append({"kind": "window", "step0": t, "arrivals": [
            [jdur.request_to_dict(r) for r in tick] for tick in wl[t:t + 4]]})
        out.append({"kind": "shed", "step": t + 1, "uids": [t, t + 7],
                    "classes": [2, 1]})
        out.append({"kind": "evict", "step": t + 2, "uids": [], "classes": []})
        out.append({"kind": "commit", "step": t + 4, "health": {
            "engine_service_est": 7.123456789, "sched_inserted": 3 * t,
            "errors_total{code=INVARIANT}": 0.0}})
    return out


def _write_log(mod, path, records):
    wal = mod.WriteAheadLog(path)
    for r in records:
        wal.append(r)
    wal.sync()
    wal.close()
    return path


def test_wal_writes_the_references_bytes(tmp_path):
    recs = _records()
    want = _write_log(jdur, tmp_path / "jax.log", recs).read_bytes()
    got = _write_log(tdur, tmp_path / "torch.log", recs).read_bytes()
    assert got == want and len(got) > 1000
    wl = bursty_serve_workload(steps=12, seed=4)
    assert ([tdur.request_to_dict(r) for tick in wl for r in tick]
            == [jdur.request_to_dict(r) for tick in j_bursty(steps=12, seed=4)
                for r in tick])


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("variant", ["", "flip", "garbage"])
def test_each_package_recovers_the_others_torn_log(tmp_path, writer,
                                                   variant):
    """One log, torn by each package's `torn_wal`: the torn files are the
    same bytes, and each package's `recover` of each returns the same
    records, drop counts and truncation offset."""
    src = _write_log(jdur if writer == "jax" else tdur, tmp_path / "w.log",
                     _records())
    whole = WriteAheadLog(src).recover()[0]
    torn, results = {}, []
    for tearer, inj, spec in (("jax", j_inject, JFaultSpec),
                              ("torch", inject, FaultSpec)):
        p = tmp_path / f"torn_{tearer}.log"
        shutil.copy(src, p)
        inj(p, spec("torn_wal", variant=variant, rate=0.5, seed=3))
        torn[tearer] = p.read_bytes()
        for reader in (jdur, tdur):
            q = tmp_path / f"read_{tearer}_{reader.__name__}.log"
            shutil.copy(p, q)
            recs, dropped_r, dropped_b = reader.WriteAheadLog(q).recover()
            results.append((recs, dropped_r, dropped_b, q.stat().st_size))
    assert torn["jax"] == torn["torch"]
    assert all(r == results[0] for r in results)
    recs, dropped_r, dropped_b, size = results[0]
    assert recs == whole[:len(recs)]
    assert len(recs) == len(whole) - (variant != "garbage")
    assert size == len(torn["jax"]) - dropped_b and dropped_r == 1


def test_wal_roundtrip_torn_tail_and_append_after_recovery(tmp_path):
    """tests/test_durability.py's three log tests on the port's log."""
    path = tmp_path / "wal.log"
    recs = [{"kind": "window", "step0": i, "arrivals": [[]]}
            for i in range(5)]
    _write_log(tdur, path, recs)
    assert WriteAheadLog(path).recover() == (recs, 0, 0)
    path.write_bytes(path.read_bytes()[:-3])  # tear the last frame
    got, dropped_r, dropped_b = WriteAheadLog(path).recover()
    assert got == recs[:4] and dropped_r == 1 and dropped_b > 0
    assert WriteAheadLog(path).recover() == (got, 0, 0), \
        "truncate was not durable"
    path.write_bytes(path.read_bytes() + b"\x07garbage")
    wal = WriteAheadLog(path)
    assert wal.recover()[0] == recs[:4]
    wal.append({"n": 1})
    wal.sync()
    wal.close()
    assert WriteAheadLog(path).recover()[0] == recs[:4] + [{"n": 1}]


# ---------------------------------------------------------------------------
# persist: snapshot trees
# ---------------------------------------------------------------------------


class _Pair(NamedTuple):
    a: object
    b: object


def _tree(k: int):
    """Dicts and a NamedTuple over numpy arrays, numpy scalars and a
    Python scalar (the carry's dataclass is held apart, as jax flattens
    only registered dataclasses)."""
    return {"a": np.arange(6, dtype=np.int64) + k,
            "b": {"c": np.full((2, 3), float(k), np.float32)},
            "t": _Pair(np.int32(k), {"u": np.uint8(k), "p": k})}


def test_flatten_paths_match_jax(tree):
    """The port names and orders the leaves as `jax.tree_util` does, for
    nested containers and for the reference's carry against the port's."""
    paths, leaves, treedef = persist.flatten_with_paths(_tree(3))
    flat, _ = jax.tree_util.tree_flatten_with_path(_tree(3))
    assert paths == ["/".join(str(k) for k in p) for p, _ in flat]
    for x, (_, y) in zip(leaves, flat):
        np.testing.assert_array_equal(x, y)
    back = persist.unflatten(treedef, leaves)
    assert isinstance(back["t"], _Pair) and back["t"].b == {"u": 3, "p": 3}
    jeng = JServeEngine(None, None, JEngineConfig(batch_size=2))
    teng = ServeEngine(None, None, EngineConfig(batch_size=2), device="cpu",
                       tree=tree)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        {"carry": jeng.scheduler.carry})
    tpaths = persist.flatten_with_paths({"carry": teng.scheduler.carry})[0]
    assert tpaths == ["/".join(str(k) for k in p) for p, _ in jflat]
    assert tpaths[0] == "['carry']/.state/.head_keys"


def test_save_tree_roundtrip_prune_and_newest_valid(tmp_path):
    """tests/test_durability.py's persist tests on the port."""
    persist.save_tree(tmp_path, 3, _tree(3), extra={"tag": "x"})
    persist.save_tree(tmp_path, 7, _tree(7))
    assert persist.latest_step(tmp_path) == 7
    assert persist.available_steps(tmp_path) == [7, 3]
    got, manifest = persist.load_tree(tmp_path, _tree(0), 3)
    assert manifest["extra"] == {"tag": "x"}
    np.testing.assert_array_equal(got["a"], np.arange(6) + 3)
    assert got["b"]["c"].dtype == np.float32
    assert got["t"].b["p"].dtype == np.asarray(0).dtype
    shard = persist.step_dir(tmp_path, 7) / "shard_0.npz"
    shard.write_bytes(shard.read_bytes()[:40])  # torn write
    with pytest.raises(SnapshotCorruptError):
        persist.validate_step(tmp_path, 7)
    assert persist.newest_valid_step(tmp_path) == 3
    for s in (8, 9, 10):
        persist.save_tree(tmp_path, s, _tree(s))
    assert persist.prune_steps(tmp_path, keep=2) == 3
    assert persist.available_steps(tmp_path) == [10, 9]
    p = tmp_path / "t.npz"
    persist.atomic_savez(p, x=np.arange(4))
    persist.atomic_savez(p, x=np.arange(9))
    with np.load(p) as z:
        assert z["x"].shape == (9,)
    assert not list(tmp_path.glob(".t.npz.*")), "tmp files leaked"


def _damage(d: Path, how: str) -> None:
    shard, mpath = d / "shard_0.npz", d / "manifest.json"
    m = json.loads(mpath.read_text())
    if how == "truncated shard":
        shard.write_bytes(shard.read_bytes()[:40])
    elif how == "flipped shard byte":
        blob = bytearray(shard.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        shard.write_bytes(bytes(blob))
    elif how == "missing shard":
        shard.unlink()
    elif how == "missing manifest":
        mpath.unlink()
    elif how == "garbage manifest":
        mpath.write_text("{torn json" + "\x00" * 16)
    elif how == "no n_shards":
        del m["n_shards"]
        mpath.write_text(json.dumps(m))
    elif how == "stale leaf":
        m["leaves"]["['a']"] = [3, "leaf_0"]
        mpath.write_text(json.dumps(m))


DAMAGE = ["truncated shard", "flipped shard byte", "missing shard",
          "missing manifest", "garbage manifest", "no n_shards",
          "stale leaf"]


@pytest.mark.parametrize("how", DAMAGE)
def test_validate_step_reads_the_references_snapshots(tmp_path, how):
    """A directory written by the reference's `save_tree` validates and
    loads in the port (and the port's in the reference); a damaged copy is
    rejected by both with the same message."""
    jpersist.save_tree(tmp_path / "j", 5, _tree(5), extra={"s": 5})
    persist.save_tree(tmp_path / "t", 5, _tree(5), extra={"s": 5})
    for root in ("j", "t"):
        want = jpersist.validate_step(tmp_path / root, 5)
        got = persist.validate_step(tmp_path / root, 5)
        assert got == want and got["extra"] == {"s": 5}
    tree_, _ = persist.load_tree(tmp_path / "j", _tree(0))
    for x, y in zip(persist.flatten_with_paths(tree_)[1],
                    persist.flatten_with_paths(_tree(5))[1]):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype
    _damage(persist.step_dir(tmp_path / "j", 5), how)
    errors = []
    for validate in (jpersist.validate_step, persist.validate_step):
        with pytest.raises(Exception) as err:
            validate(tmp_path / "j", 5)
        assert err.value.code == "SNAPSHOT_CORRUPT"
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert persist.newest_valid_step(tmp_path / "j") is None


def test_store_snapshot_cadence_suffix_and_empty_dir(tmp_path):
    """tests/test_durability.py's store tests on the port."""
    store = DurableStore(DurabilityConfig(dir=tmp_path, snapshot_interval=2,
                                          keep_snapshots=2))
    for w in range(4):
        store.log_window(w * 4, [[]])
        store.log_commit((w + 1) * 4)
        store.window_committed()
        if store.should_snapshot():
            store.snapshot((w + 1) * 4, {"x": np.arange(3)}, {"w": w})
    assert store.stats.snapshots_written == 2
    assert store.stats.last_snapshot_step == 16
    fresh = DurableStore(DurabilityConfig(dir=tmp_path))
    assert [r["step0"] for r in fresh.window_suffix(8)] == [8, 12]
    got = fresh.load_newest_valid({"x": np.zeros(3, np.int64)})
    assert got is not None and got[0] == 16 and got[2] == {"w": 3}
    assert (tmp_path / "heartbeat.json").exists()
    store.close()
    empty = DurableStore(DurabilityConfig(dir=tmp_path / "new"))
    assert empty.read_wal() == []
    assert empty.load_newest_valid({"x": np.zeros(2)}) is None
    empty.close()


def test_load_tree_places_tensors_like_their_leaves(tmp_path, tree):
    """The default placer gives each tensor leaf the device and dtype of
    its `like` leaf; the generator state comes back as the CPU uint8
    tensor `Generator.set_state` takes, and the draw cursor as int64."""
    eng = ServeEngine(None, None, EngineConfig(batch_size=2), device="cpu",
                      tree=tree)
    like = eng.scheduler.snapshot_arrays()
    persist.save_tree(tmp_path, 1, like)
    got, _ = persist.load_tree(tmp_path, like)
    assert got["generator"].dtype == torch.uint8
    assert got["generator"].device.type == "cpu"
    assert got["draw_cursor"].dtype == torch.int64
    assert got["carry"].state.head_keys.dtype == torch.int32
    assert carry_fingerprint(got["carry"]) == carry_fingerprint(like["carry"])
    assert carry_fingerprint(persist.host_tree(like["carry"])) == \
        carry_fingerprint(like["carry"])


# ---------------------------------------------------------------------------
# the durable engine against the reference
# ---------------------------------------------------------------------------


def _ecfg(cls, root, K, **kw):
    return cls(batch_size=4, sched_window=K,
               durable_dir=None if root is None else str(root),
               snapshot_interval=3, **kw)


def _prints(eng, fingerprint):
    return (dict(eng.done_step),
            {u: list(v) for u, v in eng.outputs.items()},
            fingerprint(eng.scheduler.carry))


@pytest.mark.parametrize("K", [1, 4])
def test_pause_resume_matches_the_references_uninterrupted_run(tmp_path,
                                                                tree, K):
    """The reference's uninterrupted durable run against the port's, with
    the reference's draws injected: the same health, log bytes and final
    manifest `extra`; and a port run paused at step 8 and resumed by a
    fresh engine (snapshot restore, draw cursor restored) ends equal to
    it: done steps, outputs, carry fingerprint and the health counters."""
    ref = JServeEngine(None, None, _ecfg(JEngineConfig, tmp_path / "j", K),
                       seed=3)
    want = ref.run(j_bursty(steps=16, seed=3), max_steps=500)
    draws = draws_from_keys(scheduler_keys(3, want["steps"] + K), 16, 64, H)

    def engine(root):
        return ServeEngine(None, None, _ecfg(EngineConfig, root, K), seed=3,
                           device="cpu", tree=tree, draws=draws)

    whole = engine(tmp_path / "t")
    got = whole.run(bursty_serve_workload(steps=16, seed=3), max_steps=500)
    assert {k: v for k, v in got.items() if k != "wall_s"} == \
        {k: v for k, v in want.items() if k != "wall_s"}
    assert whole.health() == ref.health()
    assert (tmp_path / "t" / "wal.log").read_bytes() == \
        (tmp_path / "j" / "wal.log").read_bytes()
    snaps = [jpersist.validate_step(root / "snapshots",
                                    jpersist.latest_step(root / "snapshots"))
             for root in (tmp_path / "j", tmp_path / "t")]
    assert snaps[0]["extra"] == snaps[1]["extra"]

    e1 = engine(tmp_path / "cut")
    e1.run(bursty_serve_workload(steps=16, seed=3), max_steps=8)
    assert e1._step == 8
    e2 = engine(tmp_path / "cut")
    e2.run(bursty_serve_workload(steps=16, seed=3), max_steps=500)
    assert _prints(e2, carry_fingerprint) == _prints(ref, j_fingerprint)
    hr, h2 = ref.health(), e2.health()
    for k in hr:
        if k != "durability":
            assert hr[k] == h2[k], k
    assert e2.durability.stats.replayed_windows == 0
    for e in (ref, whole, e1, e2):
        e.durability.close()


def test_recover_replays_the_log_suffix_after_a_torn_commit(tmp_path, tree):
    """A crash mid-window (log_window written, no commit, nothing
    snapshotted): a fresh engine's recover() replays both windows and lands
    on the state the crashed engine reached."""
    def engine():
        return ServeEngine(None, None, _ecfg(EngineConfig, tmp_path / "d", 4),
                           seed=9, device="cpu", tree=tree)

    wl = bursty_serve_workload(steps=8, seed=9)
    live = engine()
    for w in range(2):
        arr = [wl[w * 4 + i] for i in range(4)]
        live.durability.log_window(w * 4, arr)
        live._advance(arr, w * 4, 1 << 62)
        if w == 0:
            live.durability.log_commit(live._step)
    want = _prints(live, carry_fingerprint)
    live.durability.close()
    fresh = engine()
    info = fresh.recover()
    assert info["snapshot_step"] is None and info["replayed_windows"] == 2
    assert _prints(fresh, carry_fingerprint) == want
    assert fresh.durability.stats.replayed_windows == 2
    assert fresh.obs.metrics.value("engine_recoveries_total") == 1
    fresh.durability.close()


def test_recover_rejects_a_carry_fingerprint_mismatch(tmp_path, tree):
    def engine():
        return ServeEngine(None, None, _ecfg(EngineConfig, tmp_path / "d", 1),
                           seed=2, device="cpu", tree=tree)

    eng = engine()
    eng.run(bursty_serve_workload(steps=4, seed=2), max_steps=4)
    eng.durability.close()
    snap_root = tmp_path / "d" / "snapshots"
    mpath = persist.step_dir(snap_root,
                             persist.latest_step(snap_root)) / "manifest.json"
    m = json.loads(mpath.read_text())
    m["extra"]["carry_crc"] ^= 0xDEAD
    mpath.write_text(json.dumps(m))
    fresh = engine()
    with pytest.raises(SnapshotCorruptError, match="fingerprint mismatch"):
        fresh.recover()
    assert fresh.obs.metrics.value("errors_total",
                                   code="SNAPSHOT_CORRUPT") == 1
    fresh.durability.close()


def test_health_surface_and_conservation(tree):
    """tests/test_durability.py::test_health_surface_and_conservation on
    the port: `durability` is None on an engine that is not durable."""
    wl = bursty_serve_workload(steps=12, seed=5)
    eng = ServeEngine(None, None, _ecfg(EngineConfig, None, 4), seed=5,
                      device="cpu", tree=tree)
    eng.run(wl, max_steps=200)
    h = eng.health()
    total = sum(len(t) for t in wl)
    assert h["inserted"] + h["arrival_backlog"] + h["shed"] \
        + h["evicted"] == total
    assert h["inserted"] == h["dispatched"] + h["on_device"]
    assert h["completed"] == len(eng.done_step)
    assert h["durability"] is None and h["overload"] is None


def test_shed_and_evict_records_reach_the_log(tmp_path, tree):
    """The scheduler's `wal_sink`: with an overload controller shedding,
    the durable engine's log holds shed records whose uids add up to the
    scheduler's `shed` count; a replay appends none."""
    from repro_torch.workloads.traces import (open_loop_requests,
                                              poisson_arrival_counts)

    wl = open_loop_requests(poisson_arrival_counts(24, 40.0, seed=1), seed=1)
    eng = ServeEngine(None, None, _ecfg(
        EngineConfig, tmp_path / "d", 4, slo_targets=(1.0, 2.0, 4.0),
        backlog_cap=16), seed=1, device="cpu", tree=tree)
    eng.run(wl, max_steps=24)
    eng.durability.close()
    recs = WriteAheadLog(tmp_path / "d" / "wal.log").recover()[0]
    kinds = [r["kind"] for r in recs]
    shed = sum(len(r["uids"]) for r in recs if r["kind"] == "shed")
    evicted = sum(len(r["uids"]) for r in recs if r["kind"] == "evict")
    st = eng.scheduler.stats
    assert shed == st.shed > 0 and evicted == st.evicted
    assert kinds.count("window") == kinds.count("commit") == 6
    fresh = ServeEngine(None, None, _ecfg(
        EngineConfig, tmp_path / "d", 4, slo_targets=(1.0, 2.0, 4.0),
        backlog_cap=16), seed=1, device="cpu", tree=tree)
    (tmp_path / "d" / "snapshots" / "LATEST").unlink()
    shutil.rmtree(tmp_path / "d" / "snapshots")
    fresh.recover()
    assert fresh.scheduler.stats == st
    fresh.durability.close()
    assert len(WriteAheadLog(tmp_path / "d" / "wal.log").recover()[0]) \
        == len(recs)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

_SUP_CFG = SupervisorConfig(
    heartbeat_timeout=1.0, startup_timeout=10.0, poll_interval=0.02,
    backoff_base=0.02, backoff_max=0.1, max_restarts=3, crash_window=60.0,
)


def _script_child(tmp_path, body: str):
    p = tmp_path / "child.py"
    p.write_text(body)
    return [sys.executable, str(p)]


def test_supervisor_restarts_until_success(tmp_path):
    argv = _script_child(tmp_path, f"""
import os, sys
count = "{tmp_path}/count"
n = int(open(count).read()) if os.path.exists(count) else 0
open(count, "w").write(str(n + 1))
sys.exit(0 if n >= 2 else 1)
""")
    rep = Supervisor(argv, tmp_path / "hb.json", _SUP_CFG).run()
    assert rep.outcome == "completed"
    assert rep.restarts == 2 and rep.exit_codes == [1, 1, 0]
    assert rep.hang_kills == 0


def test_supervisor_kills_hung_child(tmp_path):
    argv = _script_child(tmp_path, f"""
import json, os, sys, time
marker = "{tmp_path}/ran_once"
if os.path.exists(marker):
    sys.exit(0)
open(marker, "w").write("1")
open("{tmp_path}/hb.json", "w").write(json.dumps({{"step": 1}}))
time.sleep(120)  # wedged: no further heartbeats
""")
    t0 = time.time()
    rep = Supervisor(argv, tmp_path / "hb.json", _SUP_CFG).run()
    assert rep.outcome == "completed" and rep.hang_kills == 1
    assert rep.exit_codes[0] == -9
    assert time.time() - t0 < 60, "watchdog did not fire promptly"


def test_supervisor_circuit_breaker_trips(tmp_path):
    from repro_torch.obs import get_default

    argv = _script_child(tmp_path, "import sys; sys.exit(1)\n")
    before = get_default().metrics.value("errors_total", code="CRASH_LOOP")
    with pytest.raises(CrashLoopError) as ei:
        Supervisor(argv, tmp_path / "hb.json", _SUP_CFG).run()
    assert ei.value.code == "CRASH_LOOP"
    assert len(ei.value.exit_codes) == _SUP_CFG.max_restarts + 1
    after = get_default().metrics.value("errors_total", code="CRASH_LOOP")
    assert after == before + 1


# ---------------------------------------------------------------------------
# SIGKILL drills of the worker on the CPU (slow lane)
# ---------------------------------------------------------------------------

ARTIFACTS = ("completions", "done_step", "outputs_crc", "carry_crc",
             "conservation")


def _worker_argv(store, out, K, kill_at=None, marker=None):
    cmd = [sys.executable, "-m", "repro_torch.serve.worker",
           "--dir", str(store), "--out", str(out), "--steps", "24",
           "--seed", "3", "--window", str(K), "--snapshot-interval", "3",
           "--device", "cpu"]
    if kill_at is not None:
        cmd += ["--sigkill-at-step", str(kill_at)]
    if marker is not None:
        cmd += ["--crash-marker", str(marker)]
    return cmd


def _worker(*args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(_worker_argv(*args, **kw), cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.slow
@pytest.mark.parametrize("K", [1, 16])
def test_sigkill_recovery_bit_identical(tmp_path, K):
    """The reference's acceptance drill on the port's worker: SIGKILLed at
    step 9 (after the log append, before the commit) and restarted with
    the same command line, it ends with the uninterrupted run's artifacts."""
    ref = _worker(tmp_path / "ref", tmp_path / "ref.json", K)
    assert ref.returncode == 0, ref.stderr[-3000:]
    crash = _worker(tmp_path / "c", tmp_path / "c.json", K, kill_at=9,
                    marker=tmp_path / "marker")
    assert crash.returncode == -9, crash.stderr[-3000:]
    assert not (tmp_path / "c.json").exists(), "dead worker wrote results"
    assert (tmp_path / "c" / "wal.log").exists()
    restart = _worker(tmp_path / "c", tmp_path / "c.json", K, kill_at=9,
                      marker=tmp_path / "marker")
    assert restart.returncode == 0, restart.stderr[-3000:]
    a = json.loads((tmp_path / "ref.json").read_text())
    b = json.loads((tmp_path / "c.json").read_text())
    for key in ARTIFACTS:
        assert a[key] == b[key], f"{key} diverged after crash+recovery"
    assert b["conservation"]["admitted_ok"]
    assert b["conservation"]["dispatch_ok"]
    assert b["health"]["durability"]["replayed_windows"] >= 1
    assert b["recover"]["replayed_windows"] >= 1


@pytest.mark.slow
def test_supervised_worker_survives_crash(tmp_path):
    ref = _worker(tmp_path / "ref", tmp_path / "ref.json", 4)
    assert ref.returncode == 0, ref.stderr[-3000:]
    sup = Supervisor(
        _worker_argv(tmp_path / "s", tmp_path / "s.json", 4, kill_at=9,
                     marker=tmp_path / "m"),
        tmp_path / "s" / "heartbeat.json",
        SupervisorConfig(heartbeat_timeout=60.0, startup_timeout=300.0,
                         poll_interval=0.05, backoff_base=0.05),
        env={"PYTHONPATH": str(REPO / "src")},
    )
    rep = sup.run()
    assert rep.outcome == "completed"
    assert rep.restarts == 1 and rep.exit_codes == [-9, 0]
    a = json.loads((tmp_path / "ref.json").read_text())
    b = json.loads((tmp_path / "s.json").read_text())
    for key in ARTIFACTS:
        assert a[key] == b[key], key
