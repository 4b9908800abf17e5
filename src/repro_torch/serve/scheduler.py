"""Continuous-batching scheduler built on SmartPQ, in PyTorch.

Counterpart of src/repro/serve/scheduler.py, whose docstring gives the
design.  Every pending request lives in the adaptive priority queue keyed by

    priority_key = (slo_class << 27) + max(prompt_len - 4 * age, 0)

(smaller = sooner): SLO-major, shortest-prompt-first within a class, with
linear aging so long prompts cannot starve.  Each scheduler tick is one
`SmartPQ.step`: arrivals insert, up to the tick's dispatch budget deletes.

Two dispatch granularities:
  tick()        one step: the tick's lanes are packed on the host.
  tick_window() K ticks.  Arrivals load once into an admission ring on the
                device, and the (K, B) lanes are built there, priority keys
                included, with the same aging formula `Request.priority_key`
                uses; the window's operation log is sorted in one
                `elim_sort` launch, then K `SmartPQ.step` calls run and their
                outputs are read back in one host read.  The dispatch stream
                is bit-identical to K sequential tick() calls with the same
                per-tick budgets.  Ring overflow waits in the host backlog.

The reference fuses the window into one `lax.scan`; here the host issues
the K steps (each costs the host reads `SmartPQ.step` makes).  How many
arrivals a tick admits depends only on host data (the ring's arrival ticks
and the budgets), so the host computes it and the device reads nothing back
for it.

Randomness.  The reference splits its scheduler key once per tick and hands
the step the subkey.  Here the scheduler takes either ``draws=`` — the
tick's (shard_choice, hi[, choice_b]) tensors with a leading tick axis, as
`SmartPQ.run_window` takes them, consumed through a cursor (one row a
tick, also on ticks that draw nothing, as the reference splits on every
tick) — or draws from a `torch.Generator` seeded from `seed`.  The cursor
and the generator's state belong to a `SchedulerCheckpoint`, so a rolled-
back window replays the same draws.

Overload hardening (opt-in, `overload=` / `SmartPQConfig.validate` or a
`validate_hook`): an `OverloadController` sheds and caps at admission and
votes the device mode; with the guard tier armed every tick/window runs
against a pre-window checkpoint (cloned carry + host mirrors) and a window
that trips validation rolls back and retries once on a conservative
fallback queue (all STRICT_FLAT, elimination off, the main queue's tree);
a second trip restores the checkpoint again and raises
`WindowValidationError`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.errors import InvariantViolation, WindowValidationError
from repro_torch.core.pqueue import local as L
from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT
from repro_torch.core.pqueue.schedules import Schedule
from repro_torch.core.pqueue.state import INF_KEY, invariant_violations
from repro_torch.core.smartpq import (
    MODE_AWARE,
    NUM_MODES,
    SmartPQ,
    SmartPQCarry,
    SmartPQConfig,
)
from repro_torch.obs import NULL, Observability
from repro_torch.serve.overload import OverloadConfig, OverloadController
from repro_torch.utils.hostsync import host_array, host_int, resolve_device

# The active-client count every scheduler step reports to the classifier
# (src/repro/serve/scheduler.py:506-512).
NUM_CLIENTS = 512


@dataclasses.dataclass
class Request:
    uid: int
    prompt_len: int
    max_new_tokens: int
    slo_class: int = 1  # 0 = interactive, 1 = standard, 2 = batch
    arrival_step: int = 0
    tokens_done: int = 0

    def priority_key(self, step: int) -> int:
        # SLO-major, shortest-prompt-first minor with linear aging.  Must
        # stay in lockstep with the device computation in `_window_lanes`.
        age = max(step - self.arrival_step, 0)
        key = (self.slo_class << 27) + max(self.prompt_len - 4 * age, 0)
        return int(min(key, INF_KEY - 1))


@dataclasses.dataclass
class SchedulerStats:
    inserted: int = 0
    dispatched: int = 0
    rejected: int = 0
    shed: int = 0  # refused at admission by the overload controller
    evicted: int = 0  # dropped from the backlog by the cap
    recovered_windows: int = 0  # rolled back + fallback retry succeeded
    failed_windows: int = 0  # rolled back twice -> WindowValidationError
    mode_trace: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SchedulerCheckpoint:
    """Everything a window can mutate, deep enough to restore twice:
    `carry` holds clones of every tensor, and `restore` clones again on the
    way out, so one checkpoint survives rollback -> retry -> rollback."""

    carry: SmartPQCarry
    draw_cursor: int
    generator_state: torch.Tensor
    step: int
    backlog: List[Request]
    requests: Dict[int, Request]
    stats: SchedulerStats
    overload: Optional[OverloadController]
    last_mode: int = -1  # tracer's transition-edge memory (rolls back too)


def clone_carry(carry: SmartPQCarry) -> SmartPQCarry:
    """A copy of every tensor of `carry`."""
    state = carry.state
    return SmartPQCarry(
        dataclasses.replace(state, **{
            f.name: getattr(state, f.name).clone()
            for f in dataclasses.fields(state)}),
        carry.stats._make(t.clone() for t in carry.stats),
    )


class SmartPQScheduler:
    """Host-side continuous batching driver over the device-resident PQ.
    Runs on the card unless `device` names another; `tree` is the queue's
    decision tree (trained from the default training set when None)."""

    def __init__(
        self,
        batch_size: int,
        pq_config: Optional[SmartPQConfig] = None,
        seed: int = 0,
        ring_capacity: int = 1024,
        overload: OverloadController | OverloadConfig | None = None,
        validate_hook: Optional[
            Callable[[object], List[InvariantViolation]]
        ] = None,
        obs: Optional[Observability] = None,
        device=None,
        tree=None,
        draws: Optional[Tuple[torch.Tensor, ...]] = None,
    ):
        self.device = resolve_device(device)
        self.batch = batch_size
        # Admission-ring width: arrivals beyond this per window spill to the
        # host-side backlog (FIFO), so correctness never depends on it.
        self.ring_capacity = ring_capacity
        # Start in the exact (Nuddle) mode: a near-empty queue must respect
        # SLO order strictly.
        # Observability: the engine passes its own bundle; standalone
        # schedulers get the disabled NULL bundle.  The queue traces its
        # steps into the same tracer.
        self.obs = obs if obs is not None else NULL
        self.pq = SmartPQ(pq_config or SmartPQConfig(
            num_shards=16, capacity=8192, npods=2, decision_interval=4,
            initial_mode=MODE_AWARE,
        ), tree=tree, device=self.device, obs=self.obs)
        self.carry = self.pq.init()
        self._clients = torch.tensor(NUM_CLIENTS, dtype=torch.int32,
                                     device=self.device)
        self._draws = (None if draws is None
                       else tuple(d.to(self.device) for d in draws))
        self._cursor = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._requests: Dict[int, Request] = {}
        self._arrival_backlog: List[Request] = []  # submitted, not inserted
        self._step = 0
        self.stats = SchedulerStats()
        # Host mirror of the device mode: the tracer's transition edges.
        self._last_mode = int(self.pq.config.initial_mode)
        if isinstance(overload, OverloadConfig):
            overload = OverloadController(overload)
        self.overload = overload
        if overload is not None and getattr(overload, "obs", None) is None:
            overload.obs = self.obs
        # Extra validation hook (state -> violations); guarded execution is
        # on iff the queue's validate flag or a hook is set.
        self.validate_hook = validate_hook
        self._fb: Optional[SmartPQ] = None  # lazy conservative fallback
        # Write-ahead-log sink (kind, payload) -> None: the durable engine
        # sets it to `DurableStore.log_event`, so every shed and eviction
        # leaves an audit record in the log beside the admissions.
        self.wal_sink: Optional[Callable[[str, Dict], None]] = None

    def submit(self, reqs: List[Request]):
        for r in reqs:
            self._requests[r.uid] = r

    def requeue(self, reqs: List[Request]) -> None:
        """Return dispatched-but-unserved requests to the queue, through the
        FIFO arrival backlog (they keep their arrival step, so aging keeps
        accruing)."""
        self.submit(reqs)
        self._arrival_backlog.extend(reqs)

    def _pack_tick(self, arrivals: List[Request], n_dispatch: int):
        """One tick's (3, B) ops/keys/vals lanes and its arrival count."""
        B = self.batch
        lanes = np.zeros((3, B), np.int32)
        ops, keys, vals = lanes
        ops[:] = OP_DELETE_MIN
        keys[:] = INF_KEY
        na = min(len(arrivals), B)
        for i, r in enumerate(arrivals[:B]):
            ops[i] = OP_INSERT
            keys[i] = r.priority_key(self._step)
            vals[i] = r.uid
        # lanes beyond the dispatch budget become no-op inserts (INF key)
        n_del = min(n_dispatch, B - na)
        ops[na + n_del:] = OP_INSERT
        keys[na + n_del:] = INF_KEY
        return lanes, na

    def _collect(self, out_keys: np.ndarray, out_vals: np.ndarray,
                 n_out: int) -> List[Request]:
        # Dispatched descriptors leave the host map: `_requests` holds
        # in-flight requests only.
        out = []
        for k, v in zip(out_keys[:n_out], out_vals[:n_out]):
            if k < INF_KEY:
                r = self._requests.pop(int(v), None)
                if r is not None:
                    out.append(r)
        return out

    def _next_draws(self):
        """This tick's draws from `draws=` (advancing the cursor), or None
        when the steps draw from the generator."""
        if self._draws is None:
            return None
        if self._cursor >= self._draws[0].shape[0]:
            raise ValueError(
                f"the scheduler's draws cover {self._draws[0].shape[0]} "
                f"ticks; tick {self._cursor} has none")
        t = self._cursor
        self._cursor += 1
        return tuple(d[t] for d in self._draws)

    # -- overload hooks --------------------------------------------------------

    def _admit(self, arrivals: List[Request]) -> List[Request]:
        """Admission filter: SHEDDING classes are rejected here, before the
        requests reach `_requests` — an explicit, counted drop."""
        if self.overload is None:
            return arrivals
        kept, shed = self.overload.admit(arrivals)
        self.stats.shed += len(shed)
        if shed and self.wal_sink is not None:
            self.wal_sink("shed", {
                "step": self._step,
                "uids": [r.uid for r in shed],
                "classes": [r.slo_class for r in shed],
            })
        return kept

    def _enforce_backlog_cap(self) -> None:
        if self.overload is None:
            return
        evicted = self.overload.evict(self._arrival_backlog)
        for r in evicted:
            self._requests.pop(r.uid, None)
        self.stats.evicted += len(evicted)
        if evicted and self.wal_sink is not None:
            self.wal_sink("evict", {
                "step": self._step,
                "uids": [r.uid for r in evicted],
                "classes": [r.slo_class for r in evicted],
            })

    def _mode_override(self) -> int:
        return self.overload.mode_override() if self.overload else -1

    def _observe(
        self, dispatched: List[Tuple[Request, int]], step: int
    ) -> None:
        """Feed the controller completed queueing delays and the censored
        waits of everything still awaiting dispatch (device queue and
        backlog), then run its control law."""
        if self.overload is None:
            return
        for r, at in dispatched:
            self.overload.observe(r.slo_class, at - r.arrival_step)
        for r in self._requests.values():
            self.overload.observe_pending(r.slo_class, step - r.arrival_step)
        self.overload.update()

    # -- guarded execution: checkpoint / validate / rollback -------------------

    @property
    def _guard_active(self) -> bool:
        return self.pq.config.validate or self.validate_hook is not None

    def checkpoint(self) -> SchedulerCheckpoint:
        return SchedulerCheckpoint(
            carry=clone_carry(self.carry),
            draw_cursor=self._cursor,
            generator_state=self._gen.get_state(),
            step=self._step,
            backlog=list(self._arrival_backlog),
            requests=dict(self._requests),
            stats=dataclasses.replace(
                self.stats, mode_trace=list(self.stats.mode_trace)
            ),
            overload=copy.deepcopy(self.overload),
            last_mode=self._last_mode,
        )

    def restore(self, ckpt: SchedulerCheckpoint) -> None:
        # Clone again: the checkpoint must survive a second restore.
        self.carry = clone_carry(ckpt.carry)
        self._cursor = ckpt.draw_cursor
        self._gen.set_state(ckpt.generator_state)
        self._step = ckpt.step
        self._arrival_backlog = list(ckpt.backlog)
        self._requests = dict(ckpt.requests)
        self.stats = dataclasses.replace(
            ckpt.stats, mode_trace=list(ckpt.stats.mode_trace)
        )
        if ckpt.last_mode >= 0:
            self._last_mode = ckpt.last_mode
        if ckpt.overload is not None and self.overload is not None:
            # In place: the engine may hold a reference to the controller.
            self.overload.__dict__.update(
                copy.deepcopy(ckpt.overload).__dict__
            )

    # -- persistence surface (written to disk by the durability layer) ---------

    def snapshot_arrays(self) -> Dict[str, object]:
        """The scheduler's tensor state: the carry, the draw cursor and the
        generator's state (the exact draw stream, which the random modes'
        determinism depends on)."""
        return {
            "carry": self.carry,
            "draw_cursor": torch.tensor(self._cursor, dtype=torch.int64),
            "generator": self._gen.get_state(),
        }

    def restore_arrays(self, arrays: Dict[str, object]) -> None:
        self.carry = arrays["carry"]
        self._cursor = int(arrays["draw_cursor"])
        self._gen.set_state(arrays["generator"])

    def host_state(self) -> Dict[str, object]:
        """JSON-able host-side state: step clock, backlog, in-flight map (in
        insertion order: `_observe` iterates it), stats, overload
        controller."""
        req_dict = dataclasses.asdict
        return {
            "step": self._step,
            "backlog": [req_dict(r) for r in self._arrival_backlog],
            "requests": [req_dict(r) for r in self._requests.values()],
            "stats": {
                **{
                    f.name: getattr(self.stats, f.name)
                    for f in dataclasses.fields(self.stats)
                    if f.name != "mode_trace"
                },
                "mode_trace": list(self.stats.mode_trace),
            },
            "overload": (
                self.overload.state_dict()
                if self.overload is not None else None
            ),
        }

    def load_host_state(self, d: Dict[str, object]) -> None:
        self._step = int(d["step"])
        self._arrival_backlog = [
            Request(**{k: int(v) for k, v in rd.items()})
            for rd in d["backlog"]
        ]
        self._requests = {}
        for rd in d["requests"]:
            r = Request(**{k: int(v) for k, v in rd.items()})
            self._requests[r.uid] = r
        st = dict(d["stats"])
        self.stats = SchedulerStats(
            **{k: v for k, v in st.items() if k != "mode_trace"},
            mode_trace=list(st.get("mode_trace", [])),
        )
        if self.stats.mode_trace:
            self._last_mode = int(self.stats.mode_trace[-1])
        if d.get("overload") is not None and self.overload is not None:
            self.overload.load_state_dict(d["overload"])

    def _validate(self) -> List[InvariantViolation]:
        viols: List[InvariantViolation] = []
        if self.validate_hook is not None:
            viols.extend(self.validate_hook(self.carry.state) or [])
        if self.pq.config.validate:
            viols.extend(invariant_violations(self.carry.state))
        return viols

    def _fallback_pq(self) -> SmartPQ:
        """Conservative retry queue: every mode pinned to the exact STRICT
        schedule, elimination off, on the same state layout and with the
        main queue's tree (no retraining)."""
        if self._fb is None:
            cfg = dataclasses.replace(
                self.pq.config,
                mode_schedules=(Schedule.STRICT_FLAT,) * NUM_MODES,
                eliminate=False,
            )
            self._fb = SmartPQ(cfg, tree=self.pq.tree, device=self.device,
                               obs=self.obs)
        return self._fb

    def _run_guarded(self, run):
        """Execute `run(fallback)` under the window-recovery contract: a
        rolled-back attempt's trace events are truncated away and replaced
        by a `rollback` instant; every violation bumps
        ``errors_total{code=INVARIANT}`` and a double trip bumps
        ``errors_total{code=WINDOW_VALIDATION}`` before the typed error."""
        if not self._guard_active:
            return run(False)
        m, tr = self.obs.metrics, self.obs.tracer
        ckpt = self.checkpoint()
        mark = tr.mark()
        out = run(False)
        viols = self._validate()
        if not viols:
            return out
        m.inc("errors_total", n=len(viols), code="INVARIANT")
        m.inc("sched_window_rollbacks_total")
        tr.truncate(mark)
        tr.instant("rollback", cat="guard", attempt=0,
                   violations=len(viols), step=self._step)
        self.restore(ckpt)
        mark = tr.mark()
        out = run(True)
        retry = self._validate()
        if retry:
            m.inc("errors_total", n=len(retry), code="INVARIANT")
            m.inc("errors_total", code="WINDOW_VALIDATION")
            tr.truncate(mark)
            tr.instant("window_failed", cat="guard",
                       violations=len(retry), step=self._step)
            self.restore(ckpt)
            self.stats.failed_windows += 1
            raise WindowValidationError(viols, retry)
        self.stats.recovered_windows += 1
        m.inc("sched_windows_recovered_total")
        tr.instant("window_recovered", cat="guard", step=self._step)
        return out

    # -- per-step path ---------------------------------------------------------

    def tick(self, arrivals: List[Request], n_dispatch: int) -> List[Request]:
        """One scheduler step: enqueue arrivals, dequeue up to n_dispatch.
        Arrivals beyond the lane width join the FIFO arrival backlog and
        insert on later ticks."""
        arrivals = list(arrivals)
        return self._run_guarded(
            lambda fb: self._tick_impl(arrivals, n_dispatch, fb)
        )

    def _tick_impl(
        self, arrivals: List[Request], n_dispatch: int, fallback: bool
    ) -> List[Request]:
        arrivals = self._admit(arrivals)
        self.submit(arrivals)
        queue = self._arrival_backlog + list(arrivals)
        na = min(len(queue), self.batch)
        self._arrival_backlog = queue[na:]
        self._enforce_backlog_cap()
        lanes, na = self._pack_tick(queue[:na], n_dispatch)
        ov = self._mode_override()
        draws = self._next_draws()
        pq = self._fallback_pq() if fallback else self.pq
        tr = self.obs.tracer
        B = self.batch
        with tr.span("tick", "sched") as span:
            ops, keys, vals = torch.as_tensor(lanes, device=self.device)
            self.carry, res, feats = pq.step(
                self.carry, ops, keys, vals, draws=draws,
                num_clients=self._clients,
                mode_override=None if ov < 0 else ov,
                return_features=True, generator=self._gen,
            )
            self._step += 1
            # the tick's one read: its outputs, mode and features
            out = host_array(torch.cat([
                res.keys, res.vals, res.n_out.view(1).to(torch.int32),
                self.carry.stats.mode.view(1), feats.view(torch.int32)]),
                "sched.tick")
            dispatched = self._collect(out[:B], out[B:2 * B],
                                       int(out[2 * B]))
        self.stats.inserted += na
        self.stats.dispatched += len(dispatched)
        mode = int(out[2 * B + 1])
        self.stats.mode_trace.append(mode)
        self.obs.metrics.inc("sched_ticks_total")
        if span is not None:
            span["args"] = dict(step=self._step, mode=mode, arrivals=na,
                                dispatched=len(dispatched), fallback=fallback)
            if mode != self._last_mode:
                tr.instant(
                    "mode_transition", cat="mode", ts=span["ts"],
                    from_mode=self._last_mode, to_mode=mode,
                    step=self._step,
                    features=out[2 * B + 2:].view(np.float32).tolist(),
                )
        self._last_mode = mode
        self._observe([(r, self._step) for r in dispatched], self._step)
        return dispatched

    # -- windowed admission ----------------------------------------------------

    def _window_lanes(self, ring: torch.Tensor, heads: np.ndarray,
                      n_arr: np.ndarray, n_del: np.ndarray, step0: int):
        """The window's (K, B) ops/keys/vals, built on the device from the
        admission ring: tick t admits ring entries [heads[t], heads[t] +
        n_arr[t]) with their priority keys at step `step0 + t`, then spends
        n_del[t] delete lanes (src/repro/serve/scheduler.py:564-580)."""
        dev = ring.device
        B = self.batch
        R = ring.shape[1]
        K = len(heads)
        lane = torch.arange(B, dtype=torch.int32, device=dev)[None, :]
        per_tick = torch.as_tensor(
            np.stack([heads, n_arr, n_del,
                      step0 + np.arange(K)]).astype(np.int32), device=dev)
        head, na, nd, step = (x[:, None] for x in per_tick)
        idx = torch.clamp(head + lane, max=R - 1).long()
        slo, plen, astep, uid = ring[:, idx]
        is_arr = lane < na
        age = torch.clamp(step - astep, min=0)
        pkey = (slo << 27) + torch.clamp(plen - 4 * age, min=0)
        pkey = torch.clamp(pkey, max=INF_KEY - 1)
        is_del = (lane >= na) & (lane < na + nd)
        ops = torch.where(is_del, OP_DELETE_MIN, OP_INSERT).to(torch.int32)
        keys = torch.where(is_arr, pkey, INF_KEY).to(torch.int32)
        vals = torch.where(is_arr, uid, 0).to(torch.int32)
        return ops, keys, vals

    def _window_plan(self, ring, avail_by_tick, budgets, step0,
                     eliminate: bool):
        """The window's lanes from the admission ring.  `ring` is (4, R)
        int32 rows (slo, prompt_len, arrival_step, uid) on the device.
        Each tick consumes the FIFO prefix of ring entries that have
        arrived by it, up to the lane width; entries already arrived but
        beyond it are counted as deferred, as the reference's scan does.
        Returns ((ops, keys, vals, presorted), entries consumed, entries
        deferred); `presorted` is the operation log's sort, or None without
        elimination."""
        B = self.batch
        K = len(budgets)
        heads = np.zeros(K, np.int64)
        n_arr = np.zeros(K, np.int64)
        n_del = np.zeros(K, np.int64)
        head = deferred = 0
        for t in range(K):
            heads[t] = head
            n_arr[t] = min(max(int(avail_by_tick[t]) - head, 0), B)
            n_del[t] = min(max(int(budgets[t]), 0), B - n_arr[t])
            deferred += max(int(avail_by_tick[t]) - head - int(n_arr[t]), 0)
            head += int(n_arr[t])
        ops, keys, vals = self._window_lanes(ring, heads, n_arr, n_del, step0)
        presorted = None
        if eliminate:
            presorted = L.sort_op_log(torch.where(ops == OP_INSERT, keys,
                                                  INF_KEY))
        return (ops, keys, vals, presorted), head, deferred

    def _window_scan(self, pq, carry, lanes, draws, mode_ov):
        """K scheduler ticks over `SmartPQ.step`, each inside a ``tick``
        span.  Returns (carry, the stacked per-tick outputs (keys, vals,
        n_out, mode, features, eliminated) on the device, the tick spans'
        events, None where the tracer is off)."""
        ops, keys, vals, presorted = lanes
        tr = self.obs.tracer
        outs, spans = [], []
        for t in range(ops.shape[0]):
            with tr.span("tick", "sched") as span:
                carry, res, feats = pq.step(
                    carry, ops[t], keys[t], vals[t], draws=draws[t],
                    num_clients=self._clients,
                    presorted=None if presorted is None else (
                        presorted[0][t], presorted[1][t]),
                    mode_override=None if mode_ov < 0 else mode_ov,
                    return_features=True, generator=self._gen,
                )
            spans.append(span)
            outs.append((res.keys, res.vals, res.n_out.to(torch.int32),
                         carry.stats.mode, feats, carry.stats.eliminated))
        return carry, [torch.stack(x) for x in zip(*outs)], spans

    def tick_window(
        self,
        arrivals: Sequence[List[Request]],
        budgets: Sequence[int],
    ) -> List[List[Request]]:
        """K scheduler ticks, budgeted per tick.

        `arrivals[t]` is the request list arriving at tick t; `budgets[t]`
        caps that tick's dispatches.  Arrivals, prefixed by any backlog from
        earlier windows, load into the device admission ring once and admit
        at their arrival ticks.  Returns the per-tick dispatch lists —
        bit-identical to K sequential `tick(arrivals[t], budgets[t])` calls
        (same lanes, same draws, same mode trace).  Ring overflow stays in
        the host backlog for the next window."""
        K = len(arrivals)
        if K == 0:
            return []
        if len(budgets) != K:
            raise ValueError(
                f"budgets must give one dispatch cap per tick: "
                f"{len(budgets)} budgets for {K} ticks"
            )
        arrivals = [list(reqs) for reqs in arrivals]
        return self._run_guarded(
            lambda fb: self._window_impl(arrivals, budgets, fb)
        )

    def _window_impl(
        self,
        arrivals: List[List[Request]],
        budgets: Sequence[int],
        fallback: bool,
    ) -> List[List[Request]]:
        """One window, traced as a ``sched.window`` span holding
        ``sched.ring`` (admission, the ring's load and the lanes built from
        it), the K ``tick`` spans (one `SmartPQ.step` each), ``sched.read``
        (the window's one host read) and ``sched.collect``."""
        tr = self.obs.tracer
        with tr.span("sched.window", "sched") as window:
            return self._window_body(arrivals, budgets, fallback, tr, window)

    def _window_body(self, arrivals, budgets, fallback, tr, window):
        K = len(arrivals)
        with tr.span("sched.ring", "sched.phase"):
            arrivals = [self._admit(reqs) for reqs in arrivals]
            for reqs in arrivals:
                self.submit(reqs)

            # Load the ring: backlog first (FIFO), available at tick 0; this
            # window's arrivals become available at their own tick.
            # Overflow beyond the fixed capacity returns to the backlog
            # untouched.
            R = self.ring_capacity
            pending = [(r, 0) for r in self._arrival_backlog] + [
                (r, t) for t, reqs in enumerate(arrivals) for r in reqs
            ]
            loaded = pending[:R]
            ring = np.zeros((4, R), np.int32)
            avail_tick = np.zeros(len(loaded), np.int32)
            for i, (r, t) in enumerate(loaded):
                ring[:, i] = (r.slo_class, r.prompt_len, r.arrival_step,
                              r.uid)
                avail_tick[i] = t
            avail_by_tick = np.searchsorted(avail_tick, np.arange(K),
                                            side="right")

            ov = self._mode_override()
            step0 = self._step
            self._step += K  # priority keys age per tick, as in tick()
            draws = [self._next_draws() for _ in range(K)]
            pq = self._fallback_pq() if fallback else self.pq
            lanes, consumed, deferred = self._window_plan(
                torch.as_tensor(ring, device=self.device), avail_by_tick,
                budgets, step0, pq.config.eliminate)
        elim0 = self.carry.stats.eliminated
        self.carry, (dk, dv, dn, dm, df, de), spans = self._window_scan(
            pq, self.carry, lanes, draws, ov)
        if deferred:
            st = self.carry.stats
            self.carry = self.carry._replace(stats=st._replace(
                ring_deferred=st.ring_deferred + deferred))
        self._arrival_backlog = [r for r, _ in pending[consumed:]]
        self._enforce_backlog_cap()

        # The window's one read of its outputs: the dispatches, the modes,
        # the running elimination count (from before the window) and the
        # classifier's features
        B = self.batch
        with tr.span("sched.read", "sched.phase"):
            flat = host_array(torch.cat([
                dk.flatten(), dv.flatten(), dn, dm, elim0.view(1), de,
                df.flatten().view(torch.int32)]), "sched.window")
        out_k = flat[:K * B].reshape(K, B)
        out_v = flat[K * B:2 * K * B].reshape(K, B)
        at = 2 * K * B
        n_out, modes, elim = (flat[at:at + K], flat[at + K:at + 2 * K],
                              flat[at + 2 * K:at + 3 * K + 1])
        feats = flat[at + 3 * K + 1:].view(np.float32).reshape(K, -1)
        dispatched_per_tick = []
        all_dispatched: List[Tuple[Request, int]] = []
        with tr.span("sched.collect", "sched.phase"):
            for t in range(K):
                d = self._collect(out_k[t], out_v[t], int(n_out[t]))
                dispatched_per_tick.append(d)
                all_dispatched.extend((r, step0 + t + 1) for r in d)
                self.stats.dispatched += len(d)
                self.stats.mode_trace.append(int(modes[t]))
            self.stats.inserted += consumed
            self.obs.metrics.inc("sched_windows_total")
            self.obs.metrics.inc("sched_ticks_total", n=K)
        if window is not None:
            self._trace_window(tr, window, spans, step0, consumed, fallback,
                               modes, feats, np.diff(elim),
                               [len(d) for d in dispatched_per_tick])
        self._last_mode = int(modes[-1])
        self._observe(all_dispatched, self._step)
        return dispatched_per_tick

    def _trace_window(self, tr, window, spans, step0, consumed, fallback,
                      modes, feats, eliminated, n_disp) -> None:
        """Give the window's span and its K tick spans their arguments
        (each tick's mode, dispatches and eliminations, from the window's
        read) and emit the mode-transition instants at their ticks."""
        window["args"] = dict(step0=step0, ticks=len(spans),
                              admitted=consumed, dispatched=int(sum(n_disp)),
                              fallback=fallback)
        last = self._last_mode
        for t, span in enumerate(spans):
            mode = int(modes[t])
            span["args"] = dict(step=step0 + t + 1, mode=mode,
                                dispatched=n_disp[t],
                                eliminated=int(eliminated[t]))
            if mode != last:
                tr.instant(
                    "mode_transition", cat="mode", ts=span["ts"],
                    from_mode=last, to_mode=mode, step=step0 + t + 1,
                    features=feats[t].tolist(),
                )
            last = mode

    @property
    def pending(self) -> int:
        """Requests awaiting dispatch: queued on device + arrival backlog."""
        return (host_int(self.carry.state.total_size, "sched.pending")
                + len(self._arrival_backlog))
