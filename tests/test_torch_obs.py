"""Parity of the port's observability layer (`repro_torch.obs`) with the JAX
package's, on the CPU: the same writes give the same registry (counters,
gauges, labels, percentiles, the Prometheus text and the saved payload,
which each package loads from the other), the tracer's rollback truncation
and bounded buffer, `Observability`'s identity under deepcopy, the
`torch.profiler` hooks, and a traced serving run whose timeline carries the
reference's events and arguments.  Integer and float values from integer
writes must be equal; the classifier features on mode transitions are
float32 and compared within 1 ulp.
"""

import copy
import functools
import json

import numpy as np
import pytest
import torch

import repro.obs as JO
import repro.serve.scheduler as JSM
from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.smartpq import SmartPQ as JPQ
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.workloads.traces import bursty_serve_workload as j_bursty
from repro_torch import obs as TO
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.smartpq import MODE_AWARE, SmartPQConfig
from repro_torch.core.smartpq import carry_fingerprint
from repro_torch.obs.profiling import annotate, trace_session
from repro_torch.serve import (EngineConfig, Request, ServeEngine,
                               SmartPQScheduler)
from repro_torch.workloads.traces import bursty_serve_workload
from torch_draws import draws_from_keys, scheduler_keys

torch.set_num_threads(1)


def _writes(m, edges_mod):
    """One script of registry writes, from a seeded numpy generator."""
    rng = np.random.default_rng(3)
    m.inc("a")
    m.inc("a", n=2.5)
    m.inc("errors_total", code="INVARIANT")
    m.inc("errors_total", n=3, code="TRACE_CORRUPT")
    m.set_gauge("g", 3.5, shard=1)
    m.set_gauge("g", -2.0, shard=2)
    m.set_gauge("pq_mode_steps", 7, index=0)
    for v in rng.integers(0, 80, 300):
        m.observe("latency_queue_steps", int(v),
                  edges=edges_mod.LATENCY_STEP_EDGES, slo=int(v) % 3)
    for v in rng.integers(1, 400, 200) / 7.0:
        m.observe("latency_per_token_steps", float(v),
                  edges=edges_mod.PER_TOKEN_EDGES, slo=int(v * 7) % 3)
    for v in (0.5, 1.0, 1.5, 3.0, 99.0):
        m.observe("custom", v, edges=(1.0, 2.0), zone="x")
    m.observe("custom", 1.0, zone="y")  # the name's first edges are kept


def test_registry_matches_jax():
    """Counters, gauges, labelled series, merged-label percentiles,
    summaries, the compact payload and the Prometheus text: the same as the
    reference's for the same writes; a disabled registry records nothing."""
    want, got = JO.MetricsRegistry(), TO.MetricsRegistry()
    _writes(want, JO)
    _writes(got, TO)
    assert TO.LATENCY_STEP_EDGES == JO.LATENCY_STEP_EDGES
    assert TO.PER_TOKEN_EDGES == JO.PER_TOKEN_EDGES
    assert got.to_dict() == want.to_dict()
    assert got.compact() == want.compact()
    assert got.to_prometheus() == want.to_prometheus()
    for name in ("latency_queue_steps", "latency_per_token_steps", "custom",
                 "missing"):
        for labels in ({}, {"slo": 0}, {"slo": 2}, {"zone": "x"}):
            for q in (0, 1, 50, 90, 99, 100):
                a = got.percentile(name, q, **labels)
                b = want.percentile(name, q, **labels)
                assert a == b or (np.isnan(a) and np.isnan(b))
            assert got.hist_count(name, **labels) == want.hist_count(
                name, **labels)
            assert got.hist_sum(name, **labels) == want.hist_sum(name,
                                                                 **labels)
    for name, labels in (("a", {}), ("errors_total", {"code": "INVARIANT"}),
                         ("g", {"shard": 2}), ("never", {})):
        assert got.value(name, **labels) == want.value(name, **labels)
    off = TO.MetricsRegistry(enabled=False)
    _writes(off, TO)
    assert off.to_dict() == JO.MetricsRegistry(enabled=False).to_dict()
    got.clear()
    assert got.to_dict() == JO.MetricsRegistry().to_dict()


def test_registry_save_load_both_ways(tmp_path):
    """The saved payload (`SCHEMA` 1, written atomically) loads in the
    other package to the same registry; a foreign schema is refused."""
    want, got = JO.MetricsRegistry(), TO.MetricsRegistry()
    _writes(want, JO)
    _writes(got, TO)
    got.save(tmp_path / "port.json")
    want.save(tmp_path / "ref.json")
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "ref.json").read_text())
    back_j, back_t = JO.MetricsRegistry(), TO.MetricsRegistry()
    back_j.load(tmp_path / "port.json")
    back_t.load(tmp_path / "ref.json")
    assert back_j.to_dict() == back_t.to_dict() == want.to_dict()
    back_t.observe("latency_queue_steps", 5, slo=1)
    back_j.observe("latency_queue_steps", 5, slo=1)
    assert back_t.to_dict() == back_j.to_dict()
    bad = json.loads((tmp_path / "port.json").read_text())
    bad["schema"] = 2
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="schema"):
        TO.MetricsRegistry().load(tmp_path / "bad.json")


def _trace_script(tr):
    tr.instant("kept", cat="guard", step=1)
    mark = tr.mark()
    tr.instant("rolled_back")
    with tr.span("rolled_back_span"):
        pass
    tr.truncate(mark)
    tr.span_at("window", 10.0, 5.0, cat="sched", ticks=4)
    for i in range(10):
        tr.instant(f"x{i}", ts=float(i))


@pytest.mark.parametrize("max_events", [4, 100])
def test_tracer_truncate_and_bounded_buffer_match_jax(tmp_path, max_events):
    """mark/truncate drop a rolled-back attempt's events, a full buffer
    drops the newest with a count, and the Chrome payload holds the same
    events as the reference's (wall-clock stamps aside)."""
    got = TO.Tracer(enabled=True, max_events=max_events)
    want = JO.Tracer(enabled=True, max_events=max_events)
    _trace_script(got)
    _trace_script(want)
    strip = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if not (e["name"] == "kept" and k == "ts")}
                         for e in evs]
    assert strip(got.events) == strip(want.events)
    assert got.dropped == want.dropped == (8 if max_events == 4 else 0)
    payload = json.loads(got.export(tmp_path / "t.json").read_text())
    assert payload["displayTimeUnit"] == "ms"
    assert payload["otherData"] == {"producer": "repro_torch.obs.tracing",
                                    "dropped_events": got.dropped}
    assert strip(payload["traceEvents"]) == strip(want.to_chrome()[
        "traceEvents"])
    got.clear()
    assert got.events == [] and got.dropped == 0
    off = TO.Tracer(enabled=False)
    _trace_script(off)
    assert off.events == []


def test_observability_identity_and_defaults():
    """Checkpoint deep copies do not fork telemetry; `NULL` records nothing;
    `set_default` swaps the process-wide bundle and returns the old one."""
    obs = TO.Observability(metrics=True, tracing=True, max_trace_events=3)
    assert copy.deepcopy(obs) is obs and copy.copy(obs) is obs
    assert obs.enabled and obs.tracer.max_events == 3
    assert not TO.NULL.enabled
    TO.NULL.metrics.inc("x")
    assert TO.NULL.metrics.to_dict()["counters"] == {}
    mine = TO.Observability()
    prev = TO.set_default(mine)
    try:
        assert TO.get_default() is mine
    finally:
        assert TO.set_default(prev) is mine
    assert TO.get_default() is prev


def test_profiling_hooks_use_torch_profiler(tmp_path):
    """`annotate` is a `record_function` range; `trace_session(dir)` writes
    a Chrome trace holding it; `trace_session(None)` is a no-op."""
    assert isinstance(annotate("x"), torch.profiler.record_function)
    with trace_session(None) as s:
        assert s is None
    with trace_session(str(tmp_path / "prof")):
        with annotate("serve_window@0"):
            torch.ones(4).add_(1)
    files = list((tmp_path / "prof").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "serve_window@0" in names


@pytest.fixture(scope="module")
def tree():
    jtree = j_train_tree(*j_training_set(), 4, max_depth=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSM, "SmartPQ", functools.partial(JPQ, tree=jtree))
        yield train_tree(*make_training_set(), 4, max_depth=8)


def test_traced_engine_run_matches_jax(tree, tmp_path):
    """A K = 16 bursty serving run with tracing on (tests/test_obs.py::
    test_trace_export_round_trip): the port's timeline holds the
    reference's events in order with the same arguments, the classifier
    features on each mode transition within 1 ulp; tick spans nest in their
    windows and the transition instants equal the device's counter; the
    profiled run labels its windows."""
    K = 16
    ecfg = dict(batch_size=4, sched_window=K, tracing=True)
    ref = JServeEngine(None, None, JEngineConfig(**ecfg), seed=3)
    want = ref.run(j_bursty(steps=32, seed=3), max_steps=4000)
    draws = draws_from_keys(scheduler_keys(3, want["steps"] + K), 16, 64, 256)
    eng = ServeEngine(None, None, EngineConfig(
        **ecfg, profile_dir=str(tmp_path / "prof")), seed=3, device="cpu",
        tree=tree, draws=draws)
    got = eng.run(bursty_serve_workload(steps=32, seed=3), max_steps=4000)
    assert got["completed"] == want["completed"] > 0
    evs_t, evs_j = eng.obs.tracer.events, ref.obs.tracer.events
    assert [(e["name"], e["cat"], e["ph"]) for e in evs_t] == [
        (e["name"], e["cat"], e["ph"]) for e in evs_j]
    for et, ej in zip(evs_t, evs_j):
        at, aj = dict(et.get("args", {})), dict(ej.get("args", {}))
        ft, fj = at.pop("features", None), aj.pop("features", None)
        assert at == aj
        if fj is not None:
            np.testing.assert_array_max_ulp(np.float32(ft), np.float32(fj), 1)
    windows = [e for e in evs_t if e["name"] == "window"]
    ticks = [e for e in evs_t if e["name"] == "tick"]
    assert len(windows) == got["steps"] // K and len(ticks) == K * len(
        windows)
    for t in ticks:
        assert any(w["ts"] - 1e-3 <= t["ts"]
                   and t["ts"] + t["dur"] <= w["ts"] + w["dur"] + 1e-3
                   for w in windows)
    transitions = [e for e in evs_t if e["name"] == "mode_transition"]
    assert len(transitions) == int(eng.scheduler.carry.stats.transitions)
    trace = list((tmp_path / "prof").glob("*.json"))
    assert len(trace) == 1
    names = {e.get("name") for e in json.loads(trace[0].read_text())[
        "traceEvents"]}
    assert {f"serve_window@{w * K}" for w in range(len(windows))} <= names


def _drive_windows(obs, tree):
    sched = SmartPQScheduler(
        batch_size=8, pq_config=SmartPQConfig(
            num_shards=4, capacity=1024, decision_interval=4,
            initial_mode=MODE_AWARE),
        seed=5, obs=obs, device="cpu", tree=tree)
    out_uids, uid, K = [], 0, 4
    for w in range(4):
        arrivals = []
        for t in range(K):
            arrivals.append([
                Request(uid=uid + i, prompt_len=8 + (uid + i) % 32,
                        max_new_tokens=4, slo_class=(uid + i) % 3,
                        arrival_step=w * K + t)
                for i in range(4)])
            uid += 4
        out = sched.tick_window(arrivals, [2] * K)
        out_uids.append([[r.uid for r in tick] for tick in out])
    return out_uids, sched


def test_obs_on_off_dispatch_streams_bit_identical(tree):
    """Telemetry fully on gives the dispatch stream and carry of telemetry
    off, and it observed the run."""
    u_off, s_off = _drive_windows(TO.Observability(metrics=False), tree)
    u_on, s_on = _drive_windows(TO.Observability(metrics=True, tracing=True),
                                tree)
    assert u_on == u_off
    assert carry_fingerprint(s_on.carry) == carry_fingerprint(s_off.carry)
    m = s_on.obs.metrics
    assert m.value("sched_windows_total") == 4
    assert m.value("sched_ticks_total") == 16
    assert len([e for e in s_on.obs.tracer.events
                if e["name"] == "window"]) == 4
