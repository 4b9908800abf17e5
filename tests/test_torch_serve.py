"""Parity of the port's serving tier (`repro_torch.serve`) with the JAX
package's, on the CPU: `Request.priority_key`, the scheduler's `tick` and
`tick_window` (dispatch streams, pending, stats, mode trace, final carry)
with the reference's per-tick draws injected, the guard tier's rollback and
retry, the engine's slot-availability forecast, the synthetic-decode
`ServeEngine` (run summary, `health()`, latency records, the metrics
registry) and `ServeEngine` with a reduced llama3.2-3b,
granite-moe-1b-a400m or mamba2-780m model (admissions, completion steps
and `health()` in bf16 with EOS off; the tokens too in f32, both engines
built in f32 by patching their `build_model` and `init_caches`).  The port's own contracts are pinned beside: `tick_window`
equals K `tick` calls, a checkpoint survives two restores, and no step
writes into the carry it was given.  Every compared value is an integer
(or a float the reference computes from integers the same way): the
tolerance is zero.  The model's logits are floats, held to a tolerance in
tests/test_torch_models.py; here only what the engine derives from them is
compared, exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.io as JIO
import repro.models.registry as JMR
import repro.serve.scheduler as JSM
import repro_torch.models.io as TIO
import repro_torch.models.registry as TMR
from repro.configs.registry import reduced_config as j_reduced_config
from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.errors import InvariantViolation as JInvariantViolation
from repro.core.pqueue.schedules import Schedule as JSch
from repro.core.smartpq import SmartPQ as JPQ
from repro.core.smartpq import SmartPQConfig as JCfg
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.overload import OverloadConfig as JOverloadConfig
from repro.workloads.traces import bursty_serve_workload as j_bursty
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import carry_to_numpy, params_from_numpy
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.errors import InvariantViolation, WindowValidationError
from repro_torch.core.pqueue.schedules import Schedule as TSch
from repro_torch.core.pqueue.schedules import step_draws
from repro_torch.core.smartpq import MODE_AWARE, carry_fingerprint
from repro_torch.core.smartpq import SmartPQConfig as TCfg
from repro_torch.models.params import init_params
from repro_torch.serve import (EngineConfig, OverloadConfig, Request,
                               ServeEngine, SmartPQScheduler)
from repro_torch.workloads.traces import bursty_serve_workload
from torch_draws import draws_from_keys, scheduler_keys

torch.set_num_threads(1)

S, C, B, H = 4, 1024, 8, 256  # the small geometry of tests/test_serve.py
MODEL_ARCH = "llama3.2-3b"  # the engine-with-a-model cases


@pytest.fixture(scope="module")
def tree():
    """The port's tree; the reference's queues get the reference's (the
    same tree, tests/test_torch_smartpq.py) without retraining it for
    every scheduler."""
    jtree = j_train_tree(*j_training_set(), 4, max_depth=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSM, "SmartPQ", functools.partial(JPQ, tree=jtree))
        yield train_tree(*make_training_set(), 4, max_depth=8)


def _cfgs(schedule=None, **kw):
    base = dict(num_shards=S, capacity=C, decision_interval=4,
                initial_mode=MODE_AWARE)
    base.update(kw)
    if schedule is not None:
        return (JCfg(mode_schedules=(JSch[schedule],) * 3, **base),
                TCfg(mode_schedules=(TSch[schedule],) * 3, **base))
    return JCfg(**base), TCfg(**base)


def _carry_equal(jcarry, tcarry):
    tstate, tstats = carry_to_numpy(tcarry)
    for f, got in tstate.items():
        np.testing.assert_array_equal(np.asarray(getattr(jcarry.state, f)),
                                      got, err_msg=f)
    for f, got in tstats.items():
        np.testing.assert_array_equal(np.asarray(getattr(jcarry.stats, f)),
                                      got, err_msg=f)


def _uids(ticks):
    return [[r.uid for r in t] for t in ticks]


def _stream(seed, K, windows, max_arrivals=24, max_budget=6):
    """Per window: K arrival lists of (uid, prompt_len, slo_class, tick)
    tuples and K budgets, from a numpy generator."""
    rng = np.random.default_rng(seed)
    out, uid = [], 0
    for w in range(windows):
        arrivals = []
        for t in range(K):
            n = int(rng.integers(0, max_arrivals))
            arrivals.append([(uid + i, int(rng.integers(1, 64)),
                              int(rng.integers(0, 3)), w * K + t)
                             for i in range(n)])
            uid += n
        out.append((arrivals,
                    [int(rng.integers(0, max_budget)) for _ in range(K)]))
    return out


def _reqs(cls, arrivals):
    return [[cls(uid=u, prompt_len=p, max_new_tokens=2, slo_class=c,
                 arrival_step=a) for u, p, c, a in tick] for tick in arrivals]


def _drive(sched, cls, arrivals, budgets):
    reqs = _reqs(cls, arrivals)
    if len(reqs) == 1:
        return [sched.tick(reqs[0], budgets[0])]
    return sched.tick_window(reqs, budgets)


# ---------------------------------------------------------------------------
# Request.priority_key
# ---------------------------------------------------------------------------


def test_priority_key_semantics_match_jax():
    """The cases of tests/test_serve.py::test_priority_key_semantics on the
    port's `Request`, and the same keys as the reference's over a sweep of
    classes, prompts and ages."""
    interactive = Request(uid=0, prompt_len=1 << 20, max_new_tokens=1,
                          slo_class=0)
    batch = Request(uid=1, prompt_len=1, max_new_tokens=1, slo_class=2)
    assert interactive.priority_key(0) < batch.priority_key(0)
    short = Request(uid=2, prompt_len=8, max_new_tokens=1, slo_class=1)
    long = Request(uid=3, prompt_len=64, max_new_tokens=1, slo_class=1)
    assert short.priority_key(0) < long.priority_key(0)
    keys = [long.priority_key(s) for s in range(0, 20)]
    assert all(a >= b for a, b in zip(keys, keys[1:]))
    assert keys[-1] == 1 << 27
    assert long.priority_key(16) == 1 << 27
    fresh = Request(uid=4, prompt_len=8, max_new_tokens=1, slo_class=1,
                    arrival_step=16)
    assert long.priority_key(16) < fresh.priority_key(16)
    for slo in range(4):
        for plen in (0, 1, 7, 64, 1 << 20, (1 << 27) - 1):
            for arrival, step in ((0, 0), (3, 5), (5, 3), (0, 1 << 20)):
                kw = dict(uid=9, prompt_len=plen, max_new_tokens=1,
                          slo_class=slo, arrival_step=arrival)
                assert (Request(**kw).priority_key(step)
                        == JSM.Request(**kw).priority_key(step))


# ---------------------------------------------------------------------------
# the scheduler against the reference
# ---------------------------------------------------------------------------

CASES = [("three-mode", None, 1, 24), ("three-mode", None, 4, 8),
         ("three-mode", None, 16, 3), ("spray-only", "SPRAY_HERLIHY", 4, 6)]


@pytest.mark.parametrize("name,schedule,K,windows", CASES,
                         ids=[f"{c[0]}-K{c[2]}" for c in CASES])
def test_scheduler_matches_jax(tree, name, schedule, K, windows):
    """The same arrival and budget stream through the reference's scheduler
    and the port's, with an overload controller live, a 16-entry admission
    ring, a backlog cap of 24 and a requeue mid-stream, so that lane
    overflow, ring overflow, shedding and eviction all happen.  After every
    window: the same dispatch stream, stats, backlog and in-flight map, and
    the conservation identities hold; at the end the same carry.  K = 1
    drives `tick`, K > 1 `tick_window`."""
    jcfg, tcfg = _cfgs(schedule)
    ov = dict(targets=(2.0, 4.0, 8.0), backlog_cap=24, min_samples=4,
              window=64)
    j = JSM.SmartPQScheduler(batch_size=B, pq_config=jcfg, seed=K,
                             ring_capacity=16,
                             overload=JOverloadConfig(**ov))
    t = SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=K,
                         ring_capacity=16, overload=OverloadConfig(**ov),
                         device="cpu", tree=tree,
                         draws=draws_from_keys(scheduler_keys(K, K * windows),
                                               S, B, H))
    submitted = requeued = 0
    spilled = deferred = False
    for w, (arrivals, budgets) in enumerate(_stream(100 + K, K, windows)):
        got = _drive(t, Request, arrivals, budgets)
        want = _drive(j, JSM.Request, arrivals, budgets)
        assert _uids(got) == _uids(want), f"window {w}"
        submitted += sum(map(len, arrivals))
        assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
        assert [r.uid for r in t._arrival_backlog] == [
            r.uid for r in j._arrival_backlog]
        assert list(t._requests) == list(j._requests)
        assert t.pending == j.pending
        st, backlog = t.stats, len(t._arrival_backlog)
        on_device = t.pending - backlog
        assert (st.inserted + backlog + st.shed + st.evicted
                == submitted + requeued)
        assert st.inserted == st.dispatched + on_device
        assert len(t._requests) == on_device + backlog
        assert backlog <= ov["backlog_cap"]
        spilled |= backlog > 0
        deferred |= int(t.carry.stats.ring_deferred) > 0
        if w == windows // 2:
            back = [r for tick in want for r in tick][:3]
            j.requeue(back)
            t.requeue([r for tick in got for r in tick][:3])
            requeued += len(back)
    _carry_equal(j.carry, t.carry)
    assert t.overload.state_dict() == j.overload.state_dict()
    assert spilled and t.stats.shed + t.stats.evicted > 0
    assert deferred == (K > 1)


@pytest.mark.parametrize("schedule", [None, "SPRAY_HERLIHY"],
                         ids=["three-mode", "spray-only"])
@pytest.mark.parametrize("injected", [True, False],
                         ids=["draws", "generator"])
def test_tick_window_equals_k_ticks(tree, schedule, injected):
    """In the port itself: a window dispatches exactly what K `tick` calls
    with the same budgets dispatch, leaves the same carry (but for
    `ring_deferred`, which only windows count), and leaves the same draw
    stream behind (one more tick agrees), whether the draws are injected or
    come from the seeded generator."""
    _, tcfg = _cfgs(schedule)
    K, windows = 4, 5
    draws = None
    if injected:
        draws = step_draws(tcfg.mode_schedules, S, B, H, steps=K * windows + 1,
                           generator=torch.Generator().manual_seed(3))
    win, seq = (SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=5,
                                 device="cpu", tree=tree, draws=draws)
                for _ in range(2))
    for arrivals, budgets in _stream(7, K, windows, max_arrivals=14,
                                     max_budget=9):
        got = win.tick_window(_reqs(Request, arrivals), budgets)
        want = [seq.tick(a, b)
                for a, b in zip(_reqs(Request, arrivals), budgets)]
        assert _uids(got) == _uids(want)
    assert win.stats == seq.stats and win.pending == seq.pending
    assert _uids([win.tick([], 8)]) == _uids([seq.tick([], 8)])
    got, want = carry_to_numpy(win.carry), carry_to_numpy(seq.carry)
    assert int(got[1].pop("ring_deferred")) > 0  # the window's own counter
    assert int(want[1].pop("ring_deferred")) == 0
    for g, w in zip(got, want):
        for f in w:
            np.testing.assert_array_equal(g[f], w[f], err_msg=f)


def test_no_step_writes_into_the_carry_it_was_given(tree):
    """Checkpoints rely on the step building fresh tensors: the carry a
    tick or a window starts from is left as it was."""
    _, tcfg = _cfgs()
    s = SmartPQScheduler(batch_size=B, pq_config=tcfg, device="cpu",
                         tree=tree)
    for arrivals, budgets in _stream(11, 4, 6, max_budget=9):
        before = s.carry
        saved = carry_to_numpy(before)
        if arrivals[0]:
            s.tick(_reqs(Request, arrivals)[0], budgets[0])
        s.tick_window(_reqs(Request, arrivals), budgets)
        for want, got in zip(saved, carry_to_numpy(before)):
            for f in want:
                np.testing.assert_array_equal(want[f], got[f], err_msg=f)
    assert s.stats.dispatched > 0


# ---------------------------------------------------------------------------
# the guard tier
# ---------------------------------------------------------------------------


def _tripwire(cls, trip_on):
    """A validate hook whose n-th call (from 0) reports one violation when
    n is in `trip_on`."""
    calls = []

    def hook(state):
        calls.append(1)
        if len(calls) - 1 in trip_on:
            return [cls("I9", -1, "tripwire")]
        return []

    return hook


def test_one_trip_recovers_like_jax(tree):
    """A window whose first attempt trips rolls back and reruns on the
    STRICT_FLAT, elimination-off fallback queue: the same dispatch stream,
    stats and carry as the reference's recovery, and the same as running
    that window on the fallback queue directly."""
    jcfg, tcfg = _cfgs()
    stream = _stream(21, 4, 3)
    draws = draws_from_keys(scheduler_keys(2, 12), S, B, H)
    j = JSM.SmartPQScheduler(batch_size=B, pq_config=jcfg, seed=2,
                             validate_hook=_tripwire(JInvariantViolation,
                                                     {1}))
    t = SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=2, device="cpu",
                         tree=tree, draws=draws,
                         validate_hook=_tripwire(InvariantViolation, {1}))
    direct = SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=2,
                              device="cpu", tree=tree, draws=draws)
    for w, (arrivals, budgets) in enumerate(stream):
        got = _drive(t, Request, arrivals, budgets)
        assert _uids(got) == _uids(_drive(j, JSM.Request, arrivals, budgets))
        fb = direct._window_impl(_reqs(Request, arrivals), budgets, w == 1)
        assert _uids(fb) == _uids(got)
    assert t.stats.recovered_windows == 1 and t.stats.failed_windows == 0
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(j.stats)
    _carry_equal(j.carry, t.carry)
    assert carry_fingerprint(direct.carry) == carry_fingerprint(t.carry)


def test_two_trips_raise_and_restore(tree):
    """Both attempts trip: `WindowValidationError`, the pre-window carry,
    host state and draw cursor restored, the counters bumped."""
    from repro_torch.obs import Observability

    _, tcfg = _cfgs()
    obs = Observability(metrics=True, tracing=True)
    t = SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=2, device="cpu",
                         tree=tree, obs=obs,
                         validate_hook=_tripwire(InvariantViolation, {1, 2}))
    stream = _stream(22, 4, 2)
    t.tick_window(_reqs(Request, stream[0][0]), stream[0][1])
    ckpt = t.checkpoint()
    fp, host, n_events = (carry_fingerprint(t.carry), t.host_state(),
                          len(obs.tracer.events))
    with pytest.raises(WindowValidationError) as err:
        t.tick_window(_reqs(Request, stream[1][0]), stream[1][1])
    assert len(err.value.first) == len(err.value.retry) == 1
    assert carry_fingerprint(t.carry) == fp
    host["stats"]["failed_windows"] = 1
    assert t.host_state() == host
    assert t._cursor == ckpt.draw_cursor
    assert torch.equal(t._gen.get_state(), ckpt.generator_state)
    m = obs.metrics
    assert m.value("errors_total", code="INVARIANT") == 2
    assert m.value("errors_total", code="WINDOW_VALIDATION") == 1
    assert m.value("sched_window_rollbacks_total") == 1
    names = [e["name"] for e in obs.tracer.events[n_events:]]
    assert names == ["rollback", "window_failed"]


def test_checkpoint_survives_two_restores(tree):
    """rollback -> rerun -> rollback -> rerun: each rerun from the one
    checkpoint gives the first run's dispatch stream and carry, with the
    generator's draws (spray-only, so every tick draws)."""
    _, tcfg = _cfgs("SPRAY_HERLIHY")
    t = SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=4, device="cpu",
                         tree=tree)
    stream = _stream(23, 4, 3)
    t.tick_window(_reqs(Request, stream[0][0]), stream[0][1])
    ckpt = t.checkpoint()
    runs = []
    for _ in range(3):
        t.restore(ckpt)
        out = [t.tick_window(_reqs(Request, a), b) for a, b in stream[1:]]
        runs.append((_uids(sum(out, [])), carry_fingerprint(t.carry),
                     t.host_state(), t.pending))
    assert runs[0] == runs[1] == runs[2]
    arrays = t.snapshot_arrays()
    fresh = SmartPQScheduler(batch_size=B, pq_config=tcfg, seed=99,
                             device="cpu", tree=tree)
    fresh.restore_arrays(arrays)
    fresh.load_host_state(t.host_state())
    a, b = stream[1]
    assert (_uids(fresh.tick_window(_reqs(Request, a), b))
            == _uids(t.tick_window(_reqs(Request, a), b)))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_window_budgets_match_jax(tree):
    """The slot-availability forecast against the reference's for the same
    slot states: forecast off and on, service estimates, EOS hazards."""
    ref = JServeEngine(None, None, JEngineConfig(batch_size=8, max_seq=32))
    eng = ServeEngine(None, None, EngineConfig(batch_size=8, max_seq=32),
                      device="cpu", tree=tree)
    rng = np.random.default_rng(5)
    for case in range(40):
        active = rng.random(8) < rng.random()
        remaining = rng.integers(0, 20, 8)
        fields = dict(forecast=bool(case % 4), eos_hazard=float(
            rng.choice([0.0, 0.05, 0.3, 0.9])))
        est = float(rng.choice([1.0, 2.6, 8.0, 40.0]))
        for e, cls in ((ref, JSM.Request), (eng, Request)):
            e.active = [cls(uid=i, prompt_len=4, max_new_tokens=8) if a
                        else None for i, a in enumerate(active)]
            e.remaining = remaining.astype(np.int64)
            e._service_est = est
            e.ecfg = dataclasses.replace(e.ecfg, **fields)
        for K in (1, 4, 16):
            assert eng._window_budgets(K) == ref._window_budgets(K)


@pytest.mark.parametrize("K", [1, 4])
def test_engine_run_matches_jax(tree, K):
    """`ServeEngine(None, ...)` at the scheduler's default geometry on the
    reference's `bursty_serve_workload(steps=16)`: the run summary,
    `health()`, `latency_records()`, the outputs and the whole metrics
    registry (counters, gauges, latency histograms) equal the reference's."""
    ecfg = dict(batch_size=8, max_seq=512, sched_window=K)
    ref = JServeEngine(None, None, JEngineConfig(**ecfg))
    want = ref.run(j_bursty(steps=16, seed=1), max_steps=100_000)
    eng = ServeEngine(None, None, EngineConfig(**ecfg), device="cpu",
                      tree=tree,
                      draws=draws_from_keys(scheduler_keys(0, want["steps"]
                                                           + K), 16, 64, H))
    got = eng.run(bursty_serve_workload(steps=16, seed=1), max_steps=100_000)
    for k in want:
        if k != "wall_s":
            assert got[k] == want[k], k
    assert got["completed"] == len(eng.outputs) > 0
    assert eng.health() == ref.health()
    lat_t, lat_j = eng.latency_records(), ref.latency_records()
    for k in lat_j:
        assert lat_t[k].dtype == lat_j[k].dtype
        np.testing.assert_array_equal(lat_t[k], lat_j[k], err_msg=k)
    assert eng.outputs == ref.outputs
    assert eng.obs.metrics.to_dict() == ref.obs.metrics.to_dict()
    for name in ("latency_queue_steps", "latency_per_token_steps"):
        for c in range(3):
            assert (eng.obs.metrics.summary(name, slo=c)
                    == ref.obs.metrics.summary(name, slo=c))
    _carry_equal(ref.scheduler.carry, eng.scheduler.carry)


def test_engine_refuses_what_is_not_ported(tree, tmp_path):
    """A model config of every family builds (its bf16 K/V caches of
    batch_size x max_seq, its f32 SSD states, the enc-dec and VLM
    families' cross K/V) and serves; the int8 KV cache, ported since,
    builds; the sharding slice, ported since, restores a checkpoint onto
    a mesh placement and steps a train step over a (1, 1) mesh; the
    durable engine
    (`durable_dir`), ported since, runs and reports its store in
    `health()`."""
    cfg = reduced_config(MODEL_ARCH)
    eng = ServeEngine(cfg, init_params(cfg, device="cpu"),
                      EngineConfig(batch_size=2, max_seq=8), device="cpu",
                      tree=tree)
    assert eng.caches["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                     cfg.resolved_head_dim)
    assert eng.caches["v"].dtype == torch.bfloat16
    for arch, kinds in (("granite-moe-1b-a400m", ("k", "v")),
                        ("granite-moe-3b-a800m", ("k", "v")),
                        ("mamba2-780m", ("ssm_h", "ssm_conv")),
                        ("jamba-1.5-large-398b",
                         ("k", "v", "ssm_h", "ssm_conv")),
                        ("whisper-base", ("k", "v", "xk", "xv")),
                        ("llama-3.2-vision-11b", ("k", "v", "xk", "xv"))):
        fcfg = reduced_config(arch)
        eng = ServeEngine(fcfg, init_params(fcfg, device="cpu"),
                          EngineConfig(batch_size=2, max_seq=8),
                          device="cpu", tree=tree)
        assert tuple(eng.caches) == kinds, arch
        for k in kinds:
            assert eng.caches[k].dtype == (torch.float32 if "ssm" in k
                                           else torch.bfloat16), (arch, k)
        assert eng.run([[Request(uid=0, prompt_len=4, max_new_tokens=3)]],
                       max_steps=20)["completed"] == 1, arch
    # the int8 KV cache (item 8.4) and the sharding slice (item 8.5) are
    # ported: a placement restores and a train step builds on a mesh
    assert TMR.build_model(cfg, kv_int8=True, device="cpu").kv_int8
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import P, named
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    checkpoint.save(tmp_path / "ck", 1, {"w": torch.arange(4.)})
    with make_mesh((1, 1), ("data", "model"), device="cpu") as mesh:
        back = checkpoint.restore(tmp_path / "ck", {"w": torch.zeros(2)},
                                  shardings={"w": named(mesh, P("model"))})
        assert torch.equal(back["w"], torch.arange(4.))
        step, model = make_train_step(cfg, mesh, AdamWConfig(lr=1e-3),
                                      device="cpu")
        assert model.mesh is mesh
        params = model.init(torch.Generator().manual_seed(0))
        st = adamw_init(params, AdamWConfig(lr=1e-3), mesh, model.specs)
        tok = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator(
            ).manual_seed(1), dtype=torch.int32)
        _, st, m = step(params, st, {"tokens": tok[:, :-1],
                                     "labels": tok[:, 1:]})
        assert int(st.step) == 1 and torch.isfinite(m["loss"])
    eng = ServeEngine(None, None, EngineConfig(
        batch_size=4, sched_window=4, durable_dir=str(tmp_path / "d")),
        device="cpu", tree=tree)
    wl = bursty_serve_workload(steps=8, seed=2)
    assert eng.run(wl, max_steps=400)["completed"] == sum(map(len, wl))
    dur = eng.health()["durability"]
    assert dur["commits"] > 0 and dur["snapshots_written"] > 0
    assert (tmp_path / "d" / "wal.log").exists()
    eng.durability.close()


def test_engine_windows_drain_and_draws_run_out(tree):
    """K in {4, 16} drains to the same completion set and outputs as
    K = 1 (tests/test_serve.py::test_engine_window_same_completion_set on
    the port); a scheduler given too few draws raises rather than drawing
    elsewhere."""
    wl = lambda: [[Request(uid=i * 3 + j, prompt_len=8,  # noqa: E731
                           max_new_tokens=4) for j in range(3)]
                  for i in range(4)]
    runs = []
    for K in (1, 4, 16):
        e = ServeEngine(None, None, EngineConfig(batch_size=4, max_seq=32,
                                                 sched_window=K),
                        device="cpu", tree=tree)
        assert e.run(wl(), max_steps=400)["completed"] == 12
        runs.append(e.outputs)
    assert runs[0] == runs[1] == runs[2]
    s = SmartPQScheduler(batch_size=B, pq_config=_cfgs()[1], device="cpu",
                         tree=tree,
                         draws=draws_from_keys(scheduler_keys(0, 3), S, B, H))
    s.tick_window([[], [], []], [1, 1, 1])
    with pytest.raises(ValueError, match="draws cover 3 ticks"):
        s.tick([], 1)


# ---------------------------------------------------------------------------
# ServeEngine with a model
# ---------------------------------------------------------------------------


def _j_tree(arch):
    """The reference's reduced parameters of `arch`
    (`init_params(jax.random.key(0))`), as numpy."""
    jm = JMR.build_model(j_reduced_config(arch), remat=False)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0))[0])


@pytest.fixture(scope="module")
def model_tree():
    """The reference's reduced llama3.2-3b parameters, as numpy."""
    return _j_tree(MODEL_ARCH)


def _e2e_workload(cls, new_tokens=4):
    """tests/test_serve.py::test_engine_end_to_end's workload: bursts of 3
    requests on 4 ticks."""
    return [[cls(uid=i * 3 + j, prompt_len=8, max_new_tokens=new_tokens)
             for j in range(3)] for i in range(4)]


def _model_runs(tree, model_tree, mp, dtype, new_tokens=4, arch=MODEL_ARCH,
                port=None, **ecfg):
    """The reference engine and the port's on the same weights and
    workload; in f32 both build their model and caches in f32 (their
    `build_model` and `init_caches`, imported at call time, patched).
    `port`: the port's own `EngineConfig` fields, beside `ecfg`."""
    if dtype == "f32":
        mp.setattr(JMR, "build_model", functools.partial(
            JMR.build_model, compute_dtype=jnp.float32))
        mp.setattr(JIO, "init_caches", functools.partial(
            JIO.init_caches, dtype=jnp.float32))
        mp.setattr(TMR, "build_model", functools.partial(
            TMR.build_model, compute_dtype=torch.float32))
        mp.setattr(TIO, "init_caches", functools.partial(
            TIO.init_caches, dtype=torch.float32))
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    ref = JServeEngine(j_reduced_config(arch),
                       jax.tree.map(jnp.asarray, model_tree),
                       JEngineConfig(**ecfg))
    want = ref.run(_e2e_workload(JSM.Request, new_tokens), max_steps=300)
    K = ecfg.get("sched_window", 1)
    cfg = reduced_config(arch)
    eng = ServeEngine(cfg, params_from_numpy(model_tree, cfg, device="cpu",
                                             dtype=td),
                      EngineConfig(**ecfg, **(port or {})), device="cpu",
                      tree=tree, draws=draws_from_keys(scheduler_keys(
                          0, want["steps"] + K), 16, 64, H))
    got = eng.run(_e2e_workload(Request, new_tokens), max_steps=300)
    for name, c in eng.caches.items():
        assert c.dtype == (torch.float32 if "ssm" in name else td), name
    return ref, want, eng, got


def _same_serving(ref, want, eng, got):
    for k in want:
        if k != "wall_s":
            assert got[k] == want[k], k
    assert eng.admit_step == ref.admit_step  # the dispatch stream
    assert eng.done_step == ref.done_step
    assert eng.health() == ref.health()
    assert ({u: len(v) for u, v in eng.outputs.items()}
            == {u: len(v) for u, v in ref.outputs.items()})
    _carry_equal(ref.scheduler.carry, eng.scheduler.carry)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("K", [1, 4])
def test_model_engine_matches_jax(tree, model_tree, dtype, K):
    """tests/test_serve.py's test_engine_end_to_end (K = 1) and
    test_engine_windowed_scheduling_end_to_end (K = 4) against the
    reference engine: every request completes with tokens, with the same
    admissions, completion steps, health and carry; in bf16 with EOS off
    (the logits agree to a tolerance, so a near tie may pick another
    token), and in f32 with the tokens equal too."""
    ecfg = dict(batch_size=4, max_seq=32, sched_window=K)
    if dtype == "bf16":
        ecfg["eos_token"] = -1
    with pytest.MonkeyPatch.context() as mp:
        ref, want, eng, got = _model_runs(tree, model_tree, mp, dtype, **ecfg)
    assert got["completed"] == 12
    assert all(len(v) > 0 for v in eng.outputs.values())
    assert len(got["mode_trace"]) >= got["steps"]
    _same_serving(ref, want, eng, got)
    if dtype == "f32":
        assert eng.outputs == ref.outputs


def test_model_request_runs_into_full_like_jax(tree, model_tree):
    """Requests that want more tokens than the cache holds end on `full`,
    at length max_seq - 1, as the reference's do: the last cache row is
    written and no write falls past it."""
    ecfg = dict(batch_size=4, max_seq=8, eos_token=-1)
    with pytest.MonkeyPatch.context() as mp:
        ref, want, eng, got = _model_runs(tree, model_tree, mp, "bf16",
                                          new_tokens=20, **ecfg)
    _same_serving(ref, want, eng, got)
    assert got["completed"] == 12
    assert all(len(v) == 7 for v in eng.outputs.values())
    assert int(eng.lengths.max()) == 7
    assert bool(eng.caches["k"][:, :, 7].any())


@pytest.mark.parametrize("arch,dtype,K", [
    ("granite-moe-1b-a400m", "bf16", 1), ("granite-moe-1b-a400m", "f32", 4),
    ("mamba2-780m", "bf16", 1), ("mamba2-780m", "f32", 1)])
def test_family_engine_matches_jax(tree, arch, dtype, K):
    """`ServeEngine` with a reduced MoE or SSM model against the reference
    engine on the same weights and draws: every request completes, with
    the same admissions, completion steps, health and carry; in bf16 with
    EOS off, and in f32 with the tokens equal too.  The reference does not
    reset a recycled slot's SSM state, so the port's engine is set to keep
    it too (`reset_ssm_state` off): the port matches the reference there
    as well."""
    ecfg = dict(batch_size=4, max_seq=32, sched_window=K)
    if dtype == "bf16":
        ecfg["eos_token"] = -1
    with pytest.MonkeyPatch.context() as mp:
        ref, want, eng, got = _model_runs(tree, _j_tree(arch), mp, dtype,
                                          arch=arch,
                                          port=dict(reset_ssm_state=False),
                                          **ecfg)
    assert got["completed"] == 12
    assert all(len(v) > 0 for v in eng.outputs.values())
    _same_serving(ref, want, eng, got)
    if dtype == "f32":
        assert eng.outputs == ref.outputs
