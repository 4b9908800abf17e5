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
import timeit

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
from repro_torch.obs.profiling import trace_session
from repro_torch.obs.tracing import ANCHOR, NULL_SPAN, to_profiler_clock
from repro_torch.utils import hostsync
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
    """`trace_session(dir)` writes a Chrome trace of the ops run inside it;
    `trace_session(None)` is a no-op; with an enabled tracer the file also
    holds the tracer's spans (pid 0, named "program spans") on the
    profiler's clock, each around the ops it ran, and a disabled tracer
    adds nothing."""
    with trace_session(None) as s:
        assert s is None
    with trace_session(str(tmp_path / "plain"), TO.Tracer(enabled=False)):
        torch.ones(4).add_(1)
    tr = TO.Tracer(enabled=True)
    with trace_session(str(tmp_path / "prof"), tr):
        with tr.span("outer", "test"):
            torch.ones(4).add_(1)
    (plain,) = (tmp_path / "plain").glob("*.json")
    events = json.loads(plain.read_text())["traceEvents"]
    assert "aten::add_" in {e.get("name") for e in events}
    assert not any(e.get("pid") == 0 for e in events)
    (merged,) = (tmp_path / "prof").glob("*.json")
    events = json.loads(merged.read_text())["traceEvents"]
    meta = [e for e in events if e.get("ph") == "M" and e.get("pid") == 0]
    assert meta[0]["args"] == {"name": "program spans"}
    (outer,) = [e for e in events if e.get("name") == "outer"]
    (add,) = [e for e in events if e.get("name") == "aten::add_"]
    assert outer["pid"] == 0 and outer["cat"] == "test"
    assert (outer["ts"] - 20 <= add["ts"]
            and add["ts"] + add["dur"] <= outer["ts"] + outer["dur"] + 20)
    assert sum(e.get("name", "").startswith(ANCHOR + ".")
               for e in events) == 2


@pytest.fixture(scope="module")
def tree():
    jtree = j_train_tree(*j_training_set(), 4, max_depth=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSM, "SmartPQ", functools.partial(JPQ, tree=jtree))
        yield train_tree(*make_training_set(), 4, max_depth=8)


# The reference's names of the port's spans where they differ.
REF_NAMES = {"sched.window": "window"}


def test_traced_engine_run_matches_jax(tree, tmp_path):
    """A K = 16 bursty serving run with tracing on (tests/test_obs.py::
    test_trace_export_round_trip): the port's events of the categories the
    reference emits are, in time order, the reference's events (its
    `window` span is the port's `sched.window`) with the same arguments,
    the classifier features on each mode transition within 1 ulp; tick
    spans nest in their windows and the transition instants equal the
    device's counter; the profiled run's trace file holds every
    `sched.window` span."""
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
    evs_j = ref.obs.tracer.events
    cats = {e["cat"] for e in evs_j}
    evs_t = sorted((e for e in eng.obs.tracer.events if e["cat"] in cats),
                   key=lambda e: e["ts"])
    assert [(REF_NAMES.get(e["name"], e["name"]), e["cat"], e["ph"])
            for e in evs_t] == [(e["name"], e["cat"], e["ph"]) for e in evs_j]
    for et, ej in zip(evs_t, evs_j):
        at, aj = dict(et.get("args", {})), dict(ej.get("args", {}))
        ft, fj = at.pop("features", None), aj.pop("features", None)
        assert at == aj
        if fj is not None:
            np.testing.assert_array_max_ulp(np.float32(ft), np.float32(fj), 1)
    windows = [e for e in evs_t if e["name"] == "sched.window"]
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
    merged = [e for e in json.loads(trace[0].read_text())["traceEvents"]
              if e.get("name") == "sched.window"]
    assert [e["args"] for e in merged] == [w["args"] for w in windows]


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
                if e["name"] == "sched.window"]) == 4


def test_spans_nest_and_a_disabled_span_costs_one_branch():
    """An enabled tracer's spans enter the buffer when they open, each with
    its parent's id (the enclosing open span), args given or filled in
    later, and close on an exception too; a disabled tracer returns the
    shared null span and records nothing, at under 0.5 us a call (the
    best of 200 timings of 1,000 calls, which finds a slice of the run
    that no other process slowed)."""
    tr = TO.Tracer(enabled=True)
    with tr.span("a", "x") as a:
        with tr.span("b", "x", {"k": 1}) as b:
            pass
        with tr.span("c", "x") as c:
            c["args"] = {"late": 2}
    with pytest.raises(ValueError):
        with tr.span("d", "x"):
            raise ValueError("closes all the same")
    with tr.span("e", "x"):
        pass
    assert [(e["name"], e["parent_id"]) for e in tr.events] == [
        ("a", None), ("b", a["span_id"]), ("c", a["span_id"]), ("d", None),
        ("e", None)]
    assert b["args"] == {"k": 1} and tr.events[2]["args"] == {"late": 2}
    assert a["ts"] <= b["ts"] <= b["ts"] + b["dur"] <= c["ts"]
    assert c["ts"] + c["dur"] <= a["ts"] + a["dur"]
    assert len({e["span_id"] for e in tr.events}) == 5
    off = TO.Tracer(enabled=False)
    assert off.span("a", "x") is NULL_SPAN
    with off.span("a", "x") as ev:
        assert ev is None
    assert off.events == []
    n = 1000
    per_call = min(timeit.repeat(
        'with span("pq.step", "pq"):\n    pass',
        globals={"span": off.span}, number=n, repeat=200)) / n
    print(f"disabled span: {per_call * 1e6:.3f} us a call")
    assert per_call < 0.5e-6


def _new_reqs(uid0, n, t):
    return [Request(uid=uid0 + i, prompt_len=8 + (uid0 + i) % 32,
                    max_new_tokens=4, slo_class=(uid0 + i) % 3,
                    arrival_step=t) for i in range(n)]


def test_tick_spans_are_real_and_hold_their_queue_step(tree):
    """Each traced window is a `sched.window` span holding, in order and
    without overlap, `sched.ring`, K real `tick` spans, `sched.read` and
    `sched.collect`; each tick holds one `pq.step`, which holds the step's
    phases; every tick carries its mode, dispatches and eliminations."""
    _, sched = _drive_windows(TO.Observability(metrics=False, tracing=True),
                              tree)
    evs = sched.obs.tracer.events
    kids = {}
    for e in evs:
        kids.setdefault(e.get("parent_id"), []).append(e)
    windows = [e for e in evs if e["name"] == "sched.window"]
    assert len(windows) == 4
    for w in windows:
        parts = kids[w["span_id"]]
        assert [e["name"] for e in parts] == (
            ["sched.ring"] + ["tick"] * 4 + ["sched.read", "sched.collect"])
        for x, y in zip(parts, parts[1:]):
            assert x["ts"] + x["dur"] <= y["ts"]
        assert w["ts"] <= parts[0]["ts"]
        assert parts[-1]["ts"] + parts[-1]["dur"] <= w["ts"] + w["dur"]
        for t in parts[1:5]:
            assert set(t["args"]) == {"step", "mode", "dispatched",
                                      "eliminated"}
            (step,) = kids[t["span_id"]]
            assert step["name"] == "pq.step"
            assert t["ts"] <= step["ts"]
            assert step["ts"] + step["dur"] <= t["ts"] + t["dur"]
            assert [e["name"] for e in kids[step["span_id"]]] == [
                "pq.decide", "pq.eliminate", "pq.insert", "pq.refill",
                "pq.delete_min"]


def test_a_window_counts_its_host_reads_by_site(tree):
    """A K = 4 window of inserts and deletes (elimination off, so every
    tick inserts) reads the window's outputs once and, per tick, the
    insert's three predicates, the refill predicate and the mode; the
    total moves by as much, and turning tracing on adds no read."""
    K = 4
    got = []
    for tracing in (False, True):
        sched = SmartPQScheduler(
            batch_size=8, pq_config=SmartPQConfig(
                num_shards=4, capacity=1024, decision_interval=4,
                initial_mode=MODE_AWARE, eliminate=False),
            seed=5, obs=TO.Observability(tracing=tracing), device="cpu",
            tree=tree)
        before, total = hostsync.site_counts(), hostsync.SYNCS["count"]
        sched.tick_window([_new_reqs(4 * t, 4, t) for t in range(K)],
                          [2] * K)
        after = hostsync.site_counts()
        reads = {k: v[0] - before.get(k, [0, 0.0])[0]
                 for k, v in after.items()
                 if v[0] != before.get(k, [0, 0.0])[0]}
        assert hostsync.SYNCS["count"] - total == sum(reads.values())
        assert all(v[1] >= before.get(k, [0, 0.0])[1]
                   for k, v in after.items())
        got.append(reads)
    assert got[0] == got[1] == {
        "sched.window": 1, "ops.insert": K, "local.insert_compact": K,
        "local.insert_spill": K, "smartpq.refill": K, "smartpq.mode": K}


def test_spans_on_the_profilers_clock_hold_their_ops(tree, monkeypatch,
                                                     tmp_path):
    """A reduced llama engine's windows under the CPU profiler, the
    tracer's clock anchored at the start and the end: each `model.attend`
    and `pq.step` span, placed on the profiler's clock, holds the ops
    issued inside it (those of a `record_function` range around the same
    call, as the benchmark's harness lays them) to within 20 us at each
    edge.  The spans a tick records are counted and reported: the model's
    are 3 + 3 per layer."""
    import repro_torch.models.model as M
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.params import init_params

    def ranged(fn, name):
        def call(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return call

    cfg = reduced_config("llama3.2-3b")
    K = 4
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"), EngineConfig(
        batch_size=4, max_seq=32, kv_chunk=16, sched_window=K,
        tracing=True), device="cpu", tree=tree)
    monkeypatch.setattr(M, "attend_chunked",
                        ranged(M.attend_chunked, "ref.attend"))
    pq = eng.scheduler.pq
    pq.step = ranged(pq.step, "ref.pq_step")
    tr = eng.obs.tracer
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr.anchor()
        eng._advance([_new_reqs(0, 6, 0)] + [[]] * (K - 1), 0, 1 << 62)
        eng._advance([[]] * K, K, 1 << 62)
        tr.anchor()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = [e for e in json.loads((tmp_path / "t.json").read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    placed, bound = to_profiler_clock(tr.events, events)
    print(f"clock bound {bound:.1f} us")
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    for span, rng in (("model.attend", "ref.attend"),
                      ("pq.step", "ref.pq_step")):
        spans = sorted((e for e in placed if e["name"] == span),
                       key=lambda e: e["ts"])
        ranges = sorted((e for e in events if e["name"] == rng),
                        key=lambda e: e["ts"])
        assert len(spans) == len(ranges) > 0
        for s, r in zip(spans, ranges):
            inner = [o for o in ops if r["ts"] <= o["ts"]
                     and o["ts"] + o["dur"] <= r["ts"] + r["dur"]]
            assert inner
            assert min(o["ts"] for o in inner) >= s["ts"] - 20
            assert (max(o["ts"] + o["dur"] for o in inner)
                    <= s["ts"] + s["dur"] + 20)
    per_tick = {}
    for e in tr.events:
        if e["ph"] == "X":
            per_tick[e["name"]] = per_tick.get(e["name"], 0) + 1 / (2 * K)
    print("spans a tick:", sum(per_tick.values()), per_tick)
    model = sum(v for k, v in per_tick.items() if k.startswith("model."))
    assert model == pytest.approx(3 + 3 * cfg.n_layers)
    assert per_tick["engine.step"] == per_tick["tick"] == 1
    assert per_tick["pq.step"] == 1


def test_hybrid_decode_spans_nest_and_its_counters_count(tree):
    """The engine with reduced granite-4.0-h-small (a port-only
    architecture: no reference counterpart), traced: each decode step's
    `model.decode_step` holds, per layer, a `model.moe` with
    `model.moe.route`, `.experts`, `.combine` and `.shared` in order, and
    per SSD layer a `model.ssm` holding `model.ssm.norm`; the counters read
    E x cap and T x K a MoE call (cap = T, dropless) and the admitted
    slots' SSD resets.  The same engine untraced records no span and
    counts the same."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.params import init_params

    cfg = reduced_config("granite-4.0-h-small")
    params = init_params(cfg, device="cpu")
    B, K = 4, 4
    counts = []
    for tracing in (True, False):
        eng = ServeEngine(cfg, params, EngineConfig(
            batch_size=B, max_seq=32, kv_chunk=16, sched_window=K,
            tracing=tracing), device="cpu", tree=tree)
        eng._advance([_new_reqs(0, 6, 0)] + [[]] * (K - 1), 0, 1 << 62)
        eng._advance([[]] * K, K, 1 << 62)
        m = eng.obs.metrics
        steps, n_moe = 2 * K, cfg.n_layers
        E, topk = cfg.moe.n_experts, cfg.moe.top_k
        assert m.value("moe.buffer_rows") == steps * n_moe * E * B
        assert m.value("moe.assignments") == steps * n_moe * B * topk
        assert m.value("engine.ssm_state_resets") == len(eng.admit_step) == 6
        counts.append(m.to_dict())
        ev = [e for e in eng.obs.tracer.events if e["ph"] == "X"]
        if not tracing:
            assert ev == []
            continue
        by_id = {e["span_id"]: e for e in ev}

        def parent(e):
            return by_id.get(e["parent_id"], {}).get("name")

        for step in (e for e in ev if e["name"] == "model.decode_step"):
            kids = [e for e in ev if e["parent_id"] == step["span_id"]]
            names = [e["name"] for e in kids]
            assert names.count("model.moe") == n_moe
            assert names.count("model.ssm") == n_moe - 1
        moe = [e for e in ev if e["name"] == "model.moe"]
        assert len(moe) == steps * n_moe
        assert all(parent(e) == "model.decode_step" for e in moe)
        for e in moe:
            inner = [x["name"] for x in ev if x["parent_id"] == e["span_id"]]
            assert inner == ["model.moe.route", "model.moe.experts",
                             "model.moe.combine", "model.moe.shared"]
        norms = [e for e in ev if e["name"] == "model.ssm.norm"]
        assert len(norms) == steps * (n_moe - 1)
        assert all(parent(e) == "model.ssm" for e in norms)
    assert counts[0] == counts[1]
