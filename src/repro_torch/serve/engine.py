"""Serving engine: continuous batching over SmartPQ, in PyTorch.

Counterpart of src/repro/serve/engine.py with ``cfg=None``: the model-free
synthetic decode (the next token is a pure function of the current one and
never the EOS id, so completion timing is driven by `max_new_tokens`) — the
engine loop the SLO and overload benchmarks drive, without a model.  A
model config (`cfg`) waits for the port of the model path (ROADMAP queue 1
item 8) and raises `NotImplementedError` until then.

With `EngineConfig.durable_dir` set the engine is durable
(`serve/durability.py`): each window's arrivals are written to the
write-ahead log and fsynced before the window runs, a commit record after
it, and every `snapshot_interval` windows `snapshot()` writes the whole
serving state; `run()` starts with `recover()`, which loads the newest
valid snapshot and replays the log's window suffix through `_advance`, the
path the live run takes.

Host loop, one engine tick:

    arrivals  -> scheduler.tick()   (SmartPQ insert/delete on the device)
    new reqs  -> free slots         (one indexed write of their first tokens)
    all slots -> decode             (one token for every slot, on the device)
    finished  -> release slots      (one host read of tokens and lengths)

With `sched_window > 1` the engine batches K scheduler ticks into one
`SmartPQScheduler.tick_window` call and spreads the window's dispatch budget
across its ticks with a slot-availability forecast (`_window_budgets`);
over-admissions park in the engine's admit backlog, so completions never
depend on the forecast.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import Observability
from repro_torch.serve.scheduler import Request, SmartPQScheduler
from repro_torch.utils.hostsync import host_array, resolve_device


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 8  # concurrent decode slots
    max_seq: int = 512
    eos_token: int = 2
    # Read only by the model path (cfg not None, ROADMAP queue 1 item 8),
    # which raises until then; the synthetic decode has no KV cache.
    kv_chunk: int = 2048
    # Scheduler dispatch granularity: >1 batches K ticks into one
    # scheduler.tick_window call instead of K tick() calls.
    sched_window: int = 1
    # Mid-window admission: per-tick dispatch budgets from the slot-
    # availability forecast.  Off -> budgets [free, 0, ..., 0].
    forecast: bool = True
    # Per-step probability an active slot stops early (EOS), folded into
    # the forecast as an expected-completions term.
    eos_hazard: float = 0.0
    # Overload control: per-SLO-class p99 queueing-delay targets (engine
    # steps).  None -> open-loop admission.
    slo_targets: Optional[Tuple[float, ...]] = None
    # Host backlog bound (scheduler arrival backlog eviction cap + engine
    # admit-backlog requeue threshold), enforced with control on.
    backlog_cap: int = 4096
    # Arm the PQ's runtime guard tier (SmartPQConfig.validate).
    validate: bool = False
    # Durability: a directory arms the write-ahead log and the snapshots
    # (serve/durability.py); `recover()` runs at the top of `run()`.  None
    # keeps the engine in memory.  The other three are read only when it is
    # set: fsync the log's appends and commits (off: the benchmark's probe
    # of the disk's share), windows between snapshots, snapshots kept.
    durable_dir: Optional[str] = None
    wal_fsync: bool = True
    snapshot_interval: int = 4
    keep_snapshots: int = 2
    # Observability: the engine always carries a metrics registry;
    # `tracing` arms the window-timeline tracer and `profile_dir` wraps
    # run() in a torch.profiler session writing a Chrome trace there.
    tracing: bool = False
    profile_dir: Optional[str] = None


class ServeEngine:
    """The synthetic-decode serving loop.  Runs on the card unless `device`
    names another; `tree` and `draws` go to the scheduler (its queue's
    decision tree, and its per-tick random draws when the caller supplies
    them instead of the seeded generator)."""

    def __init__(self, cfg, params, engine_cfg: EngineConfig, mesh=None,
                 seed: int = 0, device=None, tree=None, draws=None):
        if cfg is not None:
            raise NotImplementedError(
                "ServeEngine with a model config: the model path is not "
                "ported yet (ROADMAP queue 1 item 8); cfg=None runs the "
                "synthetic decode")
        del mesh
        self.device = resolve_device(device)
        self.ecfg = engine_cfg
        self.params = params
        B = engine_cfg.batch_size
        self.caches = ()
        # One observability bundle for every layer below.
        self.obs = Observability(metrics=True, tracing=engine_cfg.tracing)
        overload = None
        if engine_cfg.slo_targets is not None:
            from repro_torch.serve.overload import (OverloadConfig,
                                                    OverloadController)

            overload = OverloadController(OverloadConfig(
                targets=tuple(engine_cfg.slo_targets),
                backlog_cap=engine_cfg.backlog_cap,
            ), obs=self.obs)
        self.overload = overload
        pq_config = None
        if engine_cfg.validate:
            from repro_torch.core.smartpq import MODE_AWARE, SmartPQConfig

            # The scheduler's default queue geometry, guard tier armed.
            pq_config = SmartPQConfig(
                num_shards=16, capacity=8192, npods=2, decision_interval=4,
                initial_mode=MODE_AWARE, validate=True,
            )
        self.scheduler = SmartPQScheduler(
            batch_size=64, seed=seed, pq_config=pq_config, overload=overload,
            obs=self.obs, device=self.device, tree=tree, draws=draws,
        )
        self.tokens = torch.zeros((B, 1), dtype=torch.int32,
                                  device=self.device)
        self.lengths = torch.zeros((B,), dtype=torch.int32,
                                   device=self.device)
        self.active: List[Optional[Request]] = [None] * B
        self.remaining = np.zeros(B, np.int64)
        self.outputs: Dict[int, List[int]] = {}
        self._backlog: List[Request] = []  # dispatched, awaiting a free slot
        # SLO accounting (engine-step clock): arrival -> admission -> done.
        self.arrival_step: Dict[int, int] = {}
        self.admit_step: Dict[int, int] = {}
        self.done_step: Dict[int, int] = {}
        self.slo: Dict[int, int] = {}  # uid -> SLO class (set at arrival)
        # EMA of observed service times (tokens per completed request): the
        # forecast's slot-recycling horizon.
        self._service_est = 8.0
        self._step = 0
        self.durability = None
        self._recovered = False
        if engine_cfg.durable_dir is not None:
            from repro_torch.serve.durability import (DurabilityConfig,
                                                      DurableStore)

            self.durability = DurableStore(DurabilityConfig(
                dir=engine_cfg.durable_dir,
                fsync=engine_cfg.wal_fsync,
                snapshot_interval=engine_cfg.snapshot_interval,
                keep_snapshots=engine_cfg.keep_snapshots,
            ), obs=self.obs)
            # shed and evict decisions leave records beside the admissions
            self.scheduler.wal_sink = self.durability.log_event

    # -- admission -------------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    def _admit(self, reqs: List[Request]):
        reqs = self._backlog + list(reqs)
        slots = self._free_slots()
        self._backlog = reqs[len(slots):]
        if (
            self.overload is not None
            and len(self._backlog) > self.ecfg.backlog_cap
        ):
            # The admit backlog is not priority-ordered: its overflow goes
            # back to the priority queue instead of being dropped.
            overflow = self._backlog[self.ecfg.backlog_cap:]
            del self._backlog[self.ecfg.backlog_cap:]
            self.scheduler.requeue(overflow)
        admitted = list(zip(slots, reqs))
        for slot, req in admitted:
            self.active[slot] = req
            self.remaining[slot] = req.max_new_tokens
            self.outputs[req.uid] = []
            self.admit_step[req.uid] = self._step
        if admitted:
            # The admitted slots' first (uid-derived) tokens, in one write
            idx, first = torch.as_tensor(np.array(
                [(s, r.uid % 100 + 3) for s, r in admitted], np.int64).T,
                device=self.device)
            self.tokens[idx, 0] = first.to(torch.int32)
            self.lengths[idx] = 0

    def _note_arrivals(self, arrivals: List[Request], step: int):
        """Stamp arrival time on the engine-step clock: the scheduler's
        aging term and the SLO latency records both key off it."""
        for r in arrivals:
            r.arrival_step = step
            self.arrival_step[r.uid] = step
            self.slo[r.uid] = r.slo_class

    # -- slot-availability forecast ---------------------------------------------

    def _window_budgets(self, K: int) -> List[int]:
        """Per-tick dispatch budgets for the next K-tick window.

        budgets[0] is the free-slot count at window start.  With the
        forecast on, budgets[t>0] adds the slots predicted to free at tick
        t: active slots whose `remaining` budget runs out, the accumulated
        and floored expectation of EOS early stops, and slot recycling
        (each predicted admission frees its slot again `_service_est` ticks
        later).  Over-prediction is safe: over-admissions park in the admit
        backlog until a slot actually frees."""
        budgets = [len(self._free_slots())] + [0] * (K - 1)
        if not self.ecfg.forecast:
            return budgets
        rem = [int(self.remaining[i]) for i, r in enumerate(self.active)
               if r is not None]
        frees = [0] * K
        for r in rem:
            if 1 <= r < K:
                frees[r] += 1
        h = self.ecfg.eos_hazard
        if h > 0.0:
            acc, credited = 0.0, 0
            for t in range(1, K):
                acc += h * sum(1 for r in rem if r > t)
                frees[t] += int(acc) - credited
                credited = int(acc)
        est = max(int(round(self._service_est)), 1)
        for t in range(1, K):
            if t - 1 + est < K:
                frees[t - 1 + est] += budgets[t - 1]
            budgets[t] += frees[t]
        return budgets

    # -- stepping ---------------------------------------------------------------

    def step(self, arrivals: List[Request],
             dispatched: Optional[List[Request]] = None) -> List[int]:
        """One engine tick.  Returns uids completed this step.  `dispatched`
        is pre-computed when the run loop batches scheduling through
        `tick_window`; otherwise the scheduler steps inline."""
        if dispatched is None:
            n_free = len(self._free_slots())
            dispatched = self.scheduler.tick(arrivals, n_dispatch=n_free)
        self._admit(dispatched)

        logits, self.caches = _synthetic_decode(
            self.params, self.caches, self.tokens, self.lengths
        )
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        active = np.array([r is not None for r in self.active], np.int32)
        self.lengths = self.lengths + torch.as_tensor(active,
                                                      device=self.device)
        self.tokens = next_tok[:, None]
        # The step's one read: the decoded tokens and the lengths
        tok_h, len_h = host_array(torch.stack([next_tok, self.lengths]))

        done = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            self.outputs[req.uid].append(int(tok_h[i]))
            self.remaining[i] -= 1
            hit_eos = int(tok_h[i]) == self.ecfg.eos_token
            full = int(len_h[i]) >= self.ecfg.max_seq - 1
            if self.remaining[i] <= 0 or hit_eos or full:
                done.append(req.uid)
                self.done_step[req.uid] = self._step
                self._service_est = (
                    0.9 * self._service_est + 0.1 * len(self.outputs[req.uid])
                )
                self.active[i] = None
                self._observe_completion(req.uid)
        self._step += 1
        return done

    def _observe_completion(self, uid: int) -> None:
        """Per-class latency histograms at the completion site."""
        m = self.obs.metrics
        if not m.enabled:
            return
        from repro_torch.obs import LATENCY_STEP_EDGES, PER_TOKEN_EDGES

        c = self.slo.get(uid, 1)
        arrived = self.arrival_step.get(uid, 0)
        queueing = self.admit_step[uid] - arrived
        e2e = self.done_step[uid] - arrived + 1
        tokens = max(len(self.outputs.get(uid, ())), 1)
        m.observe("latency_queue_steps", queueing,
                  edges=LATENCY_STEP_EDGES, slo=c)
        m.observe("latency_e2e_steps", e2e, edges=LATENCY_STEP_EDGES, slo=c)
        m.observe("latency_per_token_steps", e2e / tokens,
                  edges=PER_TOKEN_EDGES, slo=c)
        m.inc("tokens_emitted_total", n=tokens)
        m.inc("requests_completed_total", slo=c)

    def _advance(
        self,
        arrivals_by_tick: List[List[Request]],
        step0: int,
        max_steps: int,
    ) -> Tuple[int, int]:
        """Execute one scheduling window (K ticks, or a single `tick()`
        step when sched_window == 1) starting at engine step `step0`.
        Returns (completions, engine steps advanced)."""
        if self.ecfg.profile_dir is not None:
            from repro_torch.obs.profiling import annotate

            with annotate(f"serve_window@{step0}"):
                return self._advance_impl(arrivals_by_tick, step0, max_steps)
        return self._advance_impl(arrivals_by_tick, step0, max_steps)

    def _advance_impl(
        self,
        arrivals_by_tick: List[List[Request]],
        step0: int,
        max_steps: int,
    ) -> Tuple[int, int]:
        if len(arrivals_by_tick) == 1 and self.ecfg.sched_window <= 1:
            self._note_arrivals(arrivals_by_tick[0], step0)
            return len(self.step(arrivals_by_tick[0])), 1
        for i, a in enumerate(arrivals_by_tick):
            self._note_arrivals(a, step0 + i)
        K = len(arrivals_by_tick)
        completed, step = 0, step0
        for d in self.scheduler.tick_window(
            arrivals_by_tick, self._window_budgets(K)
        ):
            if step >= max_steps:
                # already popped from the device queue: park for admission
                # on a later run() instead of losing them
                self._backlog.extend(d)
                continue
            completed += len(self.step([], dispatched=d))
            step += 1
        return completed, step - step0

    def run(self, workload: List[List[Request]], max_steps: int = 10_000):
        """Drive until the workload drains (or `max_steps`).  Returns
        summary stats.

        A durable engine runs on the global step clock: `recover()` runs
        first, and the workload is indexed by absolute engine step, so a
        restarted process hands `run` the same whole workload and resumes
        where the crash cut it."""
        from repro_torch.obs.profiling import trace_session

        t0 = time.time()
        durable = self.durability is not None
        if durable and not self._recovered:
            self.recover()
        with trace_session(self.ecfg.profile_dir):
            completed, step, start = self._run_loop(workload, max_steps,
                                                    durable)
        sst = self.scheduler.stats
        return {
            "steps": step - start,
            "completed": completed,
            "wall_s": time.time() - t0,
            "mode_trace": sst.mode_trace,
            "pq_transitions": int(self.scheduler.carry.stats.transitions),
            "shed": sst.shed,
            "evicted": sst.evicted,
            "recovered_windows": sst.recovered_windows,
        }

    def _run_loop(self, workload, max_steps, durable):
        completed = 0
        start = self._step if durable else 0
        step = start
        K = max(1, self.ecfg.sched_window)
        while step < max_steps:
            # A durable window never straddles max_steps: its arrivals are
            # logged as a unit, and "engine step == workload ticks consumed"
            # is what a resumed run relies on.
            Kw = min(K, max_steps - step) if durable else K
            arr = [
                workload[step + i] if step + i < len(workload) else []
                for i in range(Kw)
            ]
            if durable:
                self.durability.log_window(step, arr)
            done, nsteps = self._advance(arr, step, max_steps)
            completed += done
            step += nsteps
            if durable:
                # the heartbeat carries the last known counters
                self._sync_registry()
                self.durability.log_commit(
                    self._step, health=self.obs.metrics.compact())
                self.durability.window_committed()
                if self.durability.should_snapshot():
                    self.snapshot()
            if (
                step >= len(workload)
                and self.scheduler.pending == 0
                and not self._backlog
                and all(r is None for r in self.active)
            ):
                break
        if durable:
            # final snapshot: a clean restart replays nothing
            self.snapshot()
        return completed, step, start

    # -- durability: snapshot / recover -----------------------------------------

    def _snapshot_arrays(self) -> Dict[str, object]:
        return {
            "sched": self.scheduler.snapshot_arrays(),
            "tokens": self.tokens,
            "lengths": self.lengths,
            "remaining": np.asarray(self.remaining),
        }

    def _restore_arrays(self, arrays: Dict[str, object]) -> None:
        """`arrays` as `persist.load_tree` places them: `tokens` and
        `lengths` on the engine's device, `remaining` in numpy."""
        self.scheduler.restore_arrays(arrays["sched"])
        self.tokens = arrays["tokens"]
        self.lengths = arrays["lengths"]
        self.remaining = np.asarray(arrays["remaining"], np.int64)

    def _host_state(self) -> Dict[str, object]:
        req = dataclasses.asdict
        return {
            "step": self._step,
            "service_est": self._service_est,
            "active": [None if r is None else req(r) for r in self.active],
            "backlog": [req(r) for r in self._backlog],
            "outputs": {str(u): v for u, v in self.outputs.items()},
            "arrival_step": {
                str(u): s for u, s in self.arrival_step.items()
            },
            "admit_step": {str(u): s for u, s in self.admit_step.items()},
            "done_step": {str(u): s for u, s in self.done_step.items()},
            "slo": {str(u): c for u, c in self.slo.items()},
        }

    def _load_host_state(self, d: Dict[str, object]) -> None:
        self._step = int(d["step"])
        self._service_est = float(d["service_est"])
        self.active = [
            None if rd is None
            else Request(**{k: int(v) for k, v in rd.items()})
            for rd in d["active"]
        ]
        self._backlog = [
            Request(**{k: int(v) for k, v in rd.items()})
            for rd in d["backlog"]
        ]
        self.outputs = {
            int(u): [int(t) for t in v] for u, v in d["outputs"].items()
        }
        self.arrival_step = {
            int(u): int(s) for u, s in d["arrival_step"].items()
        }
        self.admit_step = {
            int(u): int(s) for u, s in d["admit_step"].items()
        }
        self.done_step = {int(u): int(s) for u, s in d["done_step"].items()}
        self.slo = {int(u): int(c) for u, c in d["slo"].items()}

    def snapshot(self):
        """Crash-consistent snapshot of the whole serving state at the
        current window boundary, the carry's fingerprint stamped into the
        manifest.  The device tensors come back in one host read, which
        the fingerprint is computed from too."""
        from repro_torch.core.persist import host_tree
        from repro_torch.core.smartpq import carry_fingerprint

        arrays = host_tree(self._snapshot_arrays())
        host = {
            "engine": self._host_state(),
            "scheduler": self.scheduler.host_state(),
            "carry_crc": carry_fingerprint(arrays["sched"]["carry"]),
        }
        return self.durability.snapshot(self._step, arrays, host)

    def recover(self) -> Dict[str, object]:
        """Restore from the durable store: load the newest valid snapshot
        (damaged ones are skipped with accounting), check the carry's
        fingerprint, then replay the log's window suffix through
        `_advance`, the path the original run took, so completions,
        conservation counters and the carry reconverge with an
        uninterrupted run.  Nothing happens on a fresh directory.  Called
        by `run()`.  Replay runs each logged window whole (the original
        `max_steps` is not re-applied)."""
        from repro_torch.core.errors import SnapshotCorruptError
        from repro_torch.core.persist import host_tree
        from repro_torch.core.smartpq import carry_fingerprint
        from repro_torch.serve.durability import request_from_dict

        d = self.durability
        info: Dict[str, object] = {
            "snapshot_step": None, "replayed_windows": 0, "wal_records": 0,
        }
        loaded = d.load_newest_valid(self._snapshot_arrays())
        base_step = 0
        if loaded is not None:
            snap_step, arrays, host = loaded
            self._restore_arrays(arrays)
            self._load_host_state(host["engine"])
            self.scheduler.load_host_state(host["scheduler"])
            if host.get("carry_crc") is not None:
                got = carry_fingerprint(host_tree(self.scheduler.carry))
                if got != host["carry_crc"]:
                    self.obs.metrics.inc(
                        "errors_total", code="SNAPSHOT_CORRUPT"
                    )
                    raise SnapshotCorruptError(
                        f"carry fingerprint mismatch after restore "
                        f"(manifest {host['carry_crc']:#x}, got {got:#x})",
                        path=str(d.snap_root),
                    )
            base_step = self._step
            info["snapshot_step"] = snap_step
        records = d.read_wal()
        info["wal_records"] = len(records)
        windows = d.window_suffix(base_step)
        d.suppress_events = True
        try:
            for rec in windows:
                arr = [
                    [request_from_dict(x) for x in tick]
                    for tick in rec["arrivals"]
                ]
                self._advance(arr, int(rec["step0"]), 1 << 62)
                d.stats.replayed_windows += 1
                d.stats.replayed_records += 1
        finally:
            d.suppress_events = False
        info["replayed_windows"] = len(windows)
        self._recovered = True
        self.obs.metrics.inc("engine_recoveries_total")
        self.obs.tracer.instant(
            "recovery", cat="durability",
            snapshot_step=info["snapshot_step"],
            replayed_windows=len(windows),
        )
        return info

    # -- structured health -------------------------------------------------------

    def _sync_registry(self) -> None:
        """Mirror every accounting surface into the metrics registry: each
        `SchedulerStats` field becomes a ``sched_<name>`` gauge, each
        `SmartPQStats` field a ``pq_<name>`` gauge (vector fields one
        labeled series per index), plus the engine's own gauges.  The
        carry's stats and size come back in one host read."""
        m = self.obs.metrics
        if not m.enabled:
            return
        from repro_torch.core.smartpq import SmartPQStats

        sst = self.scheduler.stats
        for f in dataclasses.fields(sst):
            v = getattr(sst, f.name)
            if f.name == "mode_trace":
                m.set_gauge("sched_mode_trace_len", len(v))
            else:
                m.set_gauge(f"sched_{f.name}", v)
        carry = self.scheduler.carry
        leaves = list(carry.stats) + [carry.state.total_size]
        flat = host_array(torch.cat([t.reshape(-1) for t in leaves]))
        at = 0
        for name, leaf in zip(SmartPQStats._fields, carry.stats):
            vals = flat[at:at + leaf.numel()]
            at += leaf.numel()
            if leaf.dim() == 0:
                m.set_gauge(f"pq_{name}", float(vals[0]))
            else:
                for i, x in enumerate(vals.tolist()):
                    m.set_gauge(f"pq_{name}", float(x), index=i)
        on_device = int(flat[at])
        m.set_gauge("engine_step", self._step)
        m.set_gauge("engine_completed", len(self.done_step))
        m.set_gauge("engine_active_slots",
                    sum(r is not None for r in self.active))
        m.set_gauge("engine_free_slots", len(self._free_slots()))
        m.set_gauge("engine_admit_backlog", len(self._backlog))
        backlog = len(self.scheduler._arrival_backlog)
        m.set_gauge("sched_arrival_backlog", backlog)
        m.set_gauge("pq_on_device", on_device)
        m.set_gauge("sched_pending", on_device + backlog)
        m.set_gauge("engine_service_est", float(self._service_est))

    def health(self) -> Dict[str, object]:
        """One structured health/accounting surface, read from the metrics
        registry (synced just before).  ``inserted + arrival_backlog + shed
        + evicted`` equals the submitted arrivals, and ``inserted ==
        dispatched + on_device``."""
        self._sync_registry()
        g = self.obs.metrics.value
        return {
            "step": int(g("engine_step")),
            "completed": int(g("engine_completed")),
            "active_slots": int(g("engine_active_slots")),
            "free_slots": int(g("engine_free_slots")),
            "admit_backlog": int(g("engine_admit_backlog")),
            "arrival_backlog": int(g("sched_arrival_backlog")),
            "on_device": int(g("pq_on_device")),
            "pending": int(g("sched_pending")),
            "inserted": int(g("sched_inserted")),
            "dispatched": int(g("sched_dispatched")),
            "shed": int(g("sched_shed")),
            "evicted": int(g("sched_evicted")),
            "rejected": int(g("pq_rejected")),
            "recovered_windows": int(g("sched_recovered_windows")),
            "failed_windows": int(g("sched_failed_windows")),
            "pq_transitions": int(g("pq_transitions")),
            "service_est": float(g("engine_service_est")),
            "overload": (
                self.overload.snapshot() if self.overload is not None
                else None
            ),
            "durability": (
                self.durability.stats.as_dict()
                if self.durability is not None else None
            ),
        }

    # -- SLO accounting ----------------------------------------------------------

    def latency_records(self) -> Dict[str, np.ndarray]:
        """Per-completed-request latency vectors on the engine-step clock:
        queueing delay (arrival -> slot admission), end-to-end latency, and
        per-token latency (end-to-end / tokens emitted)."""
        uids = sorted(self.done_step)
        queueing = np.array(
            [self.admit_step[u] - self.arrival_step.get(u, 0) for u in uids],
            np.float64,
        )
        e2e = np.array(
            [self.done_step[u] - self.arrival_step.get(u, 0) + 1 for u in uids],
            np.float64,
        )
        tokens = np.array(
            [max(len(self.outputs.get(u, ())), 1) for u in uids], np.float64
        )
        return {
            "uids": np.array(uids, np.int64),
            "slo": np.array([self.slo.get(u, 1) for u in uids], np.int64),
            "queueing_steps": queueing,
            "e2e_steps": e2e,
            "per_token_steps": e2e / tokens,
            "tokens": tokens,
        }


def _synthetic_decode(params, caches, tokens, lengths):
    """Model-free decode with the `decode_step` signature, on the tokens'
    device: the next token is a pure function of the current one and never
    the default EOS id (2)."""
    del params, lengths
    nxt = (tokens[:, 0] % 97) + 3
    return torch.nn.functional.one_hot(nxt.long(), 128).to(
        torch.float32), caches
