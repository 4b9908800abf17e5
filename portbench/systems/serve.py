"""The model-serving cells: `ServeEngine` with a model behind its
`SmartPQScheduler`, decoding every slot each tick, for `--seconds`.

The configuration's `family` names a module under `families/` (found by
the catalog, so a new family is a new file) that gives all that is the
model's: its weights, the program's `ModelConfig`, the float32 reference
and its float8 control, the FLOPs and least bytes of a step, a position's
cache bytes and its attention call, labelled in the traced windows.  The
comparison that decides `correct` is this module's; its limit is the
configuration's `logit_gap_limit`, set from that configuration's readings.

Set-up makes the family's weights on the device from the seed, builds the
engine (its scheduler's queue trains its decision tree), queues the mix's
requests in one window, whose first tick fills every slot, and decodes
the mix's `warm_ticks` more, so that the window sees the backlog's steady
state of contexts and not its cold start.  The timed loop then runs
windows of `sched_window` ticks (`tick_window`, then one decode step a
tick) until the seconds are spent.  Every tick's draws for the
scheduler's queue are made here from the seed.

End to end: `card_us_per_token` is the card's busy time over the window
(the union of its device calls, `harness.CardClock`: the window runs in
chunks of `CHUNK_WINDOWS` under a profiler that records the device alone)
over the tokens the window's ticks emitted.  On the host clock,
`tokens_per_s` is those tokens over the window's seconds and `itl_p95_ms`
the 95th percentile of every gap between two consecutive tokens of one
request, both inside the window (a tick's tokens reach the host at its one
read, when the tick returns); the host's pace sets both, so they are read
from the traced run (per layer), whose window runs without the profiler,
as do its other counters (`mfu`, `occupancy`, `sched_ms_per_tick`); its
trace covers two more scheduling windows after the window has closed.

Once the window has closed, the peak read and the engine's caches freed,
the check runs: a sample drawn from the seed of the requests the window
finished (the longest among them) goes through the family's float32
reference over its first token and its served tokens, and the widest gap
by which a served token's logit lies below the reference's best is held
to the configuration's limit; and the scheduler's dispatches, tick by tick,
are held to `portbench.ref.sched` on the same arrivals, budgets and draws.
The reference's queue steps in the mode the program reports for each
tick, and checks only that a mode changes on a decision tick: which mode
the decision tree picks is not checked.
"""

from __future__ import annotations

import contextlib
import importlib
import math
import time

import numpy as np

from portbench import harness
from portbench.ref import pq as R
from portbench.ref import sched as RS

# At most this many served tokens go through the reference: every request
# the window finished, unless they hold more.
CHECK_TOKENS = 8192
# Scheduling windows a profiled chunk of the end-to-end run's window holds
# (64 ticks at K = 4: some 10^5 device calls at granite-8b's 36 layers).
CHUNK_WINDOWS = 16


def served_gap(logits, served) -> float:
    """The widest gap by which a served token's logit lies below the best
    logit at its position: logits (L, V) at positions 0..L-1, served (L,)
    the token the program emitted after each position."""
    best = logits.max(dim=-1).values
    got = logits.gather(1, served.long()[:, None])[:, 0]
    return float((best - got).max())


def judge(gap: float, bad_ticks: int, mode_faults: int, checked: int,
          gap_limit: float):
    """The numbers compared, as (name, value, limit), and the verdict."""
    checks = [("logit_gap", gap, gap_limit),
              ("dispatch_ticks_mismatched", bad_ticks, 0),
              ("mode_changes_off_decision", mode_faults, 0)]
    correct = (all(v <= lim for _, v, lim in checks) and checked > 0
               and math.isfinite(gap))
    return checks, correct


def sched_draws(sc: dict, seed: int, device):
    """The scheduler's per-tick draws for `draw_ticks` ticks."""
    import torch

    g = torch.Generator(device=device).manual_seed((seed + 1) % 2**63)
    T, S, B = sc["draw_ticks"], sc["num_shards"], sc["lanes"]
    W = min(B + R.head_pad(S), sc["head_width"])

    def ids(shape, hi=S):
        return torch.randint(0, hi, shape, generator=g, device=device,
                             dtype=torch.int32)

    return (ids((T, B)), ids((T, S, W), (1 << 31) // (W + 1) - 1),
            ids((T, B)))


def token_gaps(ticks):
    """Every gap between two consecutive tokens of one request: `ticks` is
    [(host time the tick's tokens were read, uids it decoded)] in order;
    a request decodes once a tick while it holds a slot, so its tokens in
    two consecutive ticks are consecutive."""
    gaps = []
    for (t0, a), (t1, b) in zip(ticks, ticks[1:]):
        gaps += [t1 - t0] * len(set(a) & set(b))
    return gaps


def kv_line(cfg: dict, ticks, row: int) -> str:
    """What the window's contexts fill of the K/V cache the engine holds:
    `ticks` is [(t, [(uid, context)])], `row` a position's cache bytes."""
    ec = cfg["engine"]
    ctx = [c for _, d in ticks for _, c in d]
    mean = float(np.mean(ctx)) if ctx else 0.0
    filled = len(ctx) / max(len(ticks), 1) * mean * row
    held = ec["batch_size"] * ec["max_seq"] * row
    return (f"[portbench] contexts in the window: mean {mean:.1f}, max "
            f"{max(ctx, default=0)} of {ec['max_seq']}; K/V filled "
            f"{filled / 1e9:.3f} GB of {held / 1e9:.3f} GB held")


class Recorder:
    """Harness spans around the engine's calls: each tick's end on the
    host clock and the requests it decoded with their contexts; each
    scheduler window's arrivals, budgets, dispatches and host time."""

    def __init__(self, engine):
        self.engine = engine
        self.ticks = []  # (t_end, [(uid, context)])
        self.windows = []  # (arrivals, budgets, dispatched, modes)
        self.sched_s = 0.0
        self._decoding = None
        self.done = []  # (tick index, uid)

    @contextlib.contextmanager
    def attached(self):
        eng = self.engine
        step, decode = eng.step, eng._decode
        tick_window = eng.scheduler.tick_window

        def rec_decode(*a, **kw):
            self._decoding = [
                (r.uid, len(eng.outputs[r.uid]) + 1)
                for r in eng.active if r is not None]
            return decode(*a, **kw)

        def rec_step(*a, **kw):
            done = step(*a, **kw)
            self.ticks.append((time.perf_counter(), self._decoding))
            self.done += [(len(self.ticks) - 1, u) for u in done]
            return done

        def rec_window(arrivals, budgets):
            sch = eng.scheduler
            n0 = len(sch.stats.mode_trace)
            arr = [[(r.uid, r.prompt_len, r.slo_class, r.arrival_step)
                    for r in reqs] for reqs in arrivals]
            t0 = time.perf_counter()
            out = tick_window(arrivals, budgets)
            self.sched_s += time.perf_counter() - t0
            self.windows.append((arr, list(budgets),
                                 [[r.uid for r in d] for d in out],
                                 sch.stats.mode_trace[n0:]))
            return out

        eng.step, eng._decode = rec_step, rec_decode
        eng.scheduler.tick_window = rec_window
        try:
            yield self
        finally:
            del eng.step, eng.scheduler.tick_window
            eng._decode = decode


def run(run: harness.Run, faults=None, control=None) -> harness.Outcome:
    """One run of a serving cell.  `faults` (tests only) wraps the engine
    to plant a fault under the timed path.  `control` (`portbench/
    control.py`) stands in the program's place once the check has run:
    called with (family, cfg, params, sequences) it gives the tokens it
    puts first at each position of the same sequences, and those go
    through the same comparison as the served ones; its checks and verdict
    are kept under ``record["control"]``.  A family the catalog lacks, or a
    configuration without its `logit_gap_limit`, raises `KeyError` before
    anything is made."""
    import torch
    from torch.profiler import record_function

    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    cfg, mix = run.cell["config_file"], run.cell["mix"]
    fam = run.catalog.module("families", cfg["family"])
    gap_limit = float(cfg["logit_gap_limit"])
    ec, sc = cfg["engine"], cfg["scheduler"]
    dev = run.device
    traffic = run.catalog.module("traffic", mix["kind"])
    params = fam.make_weights(cfg, run.seed, dev)
    draws = sched_draws(sc, run.seed, dev)
    engine = ServeEngine(
        fam.model_config(cfg), params,
        EngineConfig(batch_size=ec["batch_size"], max_seq=ec["max_seq"],
                     kv_chunk=ec["kv_chunk"], sched_window=ec["sched_window"]),
        seed=run.seed % 2**31, device=dev, draws=draws)
    if faults is not None:
        engine = faults(engine)
    reqs = [Request(uid=u, prompt_len=p, max_new_tokens=n, slo_class=c)
            for u, p, n, c in traffic.requests(mix, run.seed)]
    # the first token the engine gives each request (it takes no prompt)
    first_tok = {r.uid: r.uid % 100 + 3 for r in reqs}
    K = ec["sched_window"]
    rec = Recorder(engine)
    big = 1 << 62

    def advance(arrivals):
        engine._advance(arrivals, engine._step, big)

    with rec.attached():
        advance([reqs] + [[]] * (K - 1))
        for _ in range(-(-int(mix.get("warm_ticks", 0)) // K)):
            advance([[]] * K)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        # the end-to-end run times the card over its whole window; the
        # traced run's window runs without the profiler, for its counters
        card = None if run.trace else harness.CardClock(dev)
        n_setup_ticks = len(rec.ticks)
        sched0 = rec.sched_s
        t_first = time.perf_counter()
        setup_s = t_first - run.t0
        done = False
        while not done:
            with card.chunk() if card else contextlib.nullcontext():
                for _ in range(CHUNK_WINDOWS):
                    advance([[]] * K)
                    done = time.perf_counter() - t_first >= run.seconds
                    if done:
                        break
        elapsed = time.perf_counter() - t_first
        sched_s = rec.sched_s - sched0
        n_window_ticks = len(rec.ticks)
        prof = None
        if run.trace:  # two more windows, under the profiler
            prof = harness.new_profiler()
            attn_mod, attn_fn = fam.ATTENTION
            targets = [(engine, "_decode", "serve.decode"),
                       (importlib.import_module(attn_mod), attn_fn,
                        "serve.attention")]
            with harness.labelled(targets), prof:
                with record_function(harness.TRACED):
                    advance([[]] * K)
                    advance([[]] * K)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # -- end-to-end, and the counters of the same window -----------------
    ticks = rec.ticks[n_setup_ticks:n_window_ticks]
    tokens = sum(len(d) for _, d in ticks)
    gaps = token_gaps([(t, [u for u, _ in d]) for t, d in ticks])
    itl_p95 = float(np.percentile(gaps, 95)) * 1e3 if gaps else float("nan")
    flops = sum(fam.token_flops(cfg, c)
                for _, d in ticks for _, c in d)
    record = {
        "ticks": len(ticks), "window_s": elapsed, "tokens": tokens,
        "sched_ms_per_tick": sched_s * 1e3 / max(len(ticks), 1),
        "occupancy": 100.0 * tokens / max(len(ticks) * ec["batch_size"], 1),
        "mfu": 100.0 * flops / elapsed / harness.PEAK_BF16_FLOPS,
        "itl_p95_ms": itl_p95,
    }
    card_us = float("nan")
    if card is not None:
        busy_s, calls = card.busy()
        record.update(card_busy_s=busy_s, card_calls=calls)
        if calls and tokens:
            card_us = busy_s * 1e6 / tokens
    print(kv_line(cfg, ticks, fam.state_row_bytes(cfg)), flush=True)

    # -- the check, once the window has closed ---------------------------
    finished = sorted(u for i, u in rec.done if i >= n_setup_ticks)
    outputs = {u: list(engine.outputs[u]) for u in finished}
    inflight = [r.uid for r in engine.active if r is not None]
    if not finished:  # nothing finished: judge the served prefixes
        outputs = {u: list(engine.outputs[u]) for u in inflight}
    sample = sorted(outputs)
    if sample:  # the longest, then others drawn from the seed, to a cap
        longest = max(sample, key=lambda u: (len(outputs[u]), -u))
        rng = np.random.default_rng([run.seed % 2**63, 0xC4EC])
        rest = [u for u in sample if u != longest]
        sample, n = [longest], len(outputs[longest])
        for i in rng.permutation(len(rest)):
            if n + len(outputs[rest[i]]) > CHECK_TOKENS:
                continue
            sample.append(rest[i])
            n += len(outputs[rest[i]])
    windows = rec.windows
    engine.caches = None
    engine.model = None
    engine._decode = None
    del engine
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    gap = 0.0
    checked = 0
    seqs, served = [], []
    for u in sample:
        out = outputs[u]
        seqs.append(torch.tensor([first_tok[u]] + out[:-1], device=dev))
        served.append(torch.tensor(out, device=dev))
        checked += len(out)
    if seqs:
        logits = fam.forward(cfg, params, seqs)
        gap = max(served_gap(lg, sv) for lg, sv in zip(logits, served))
        if control is not None:
            firsts = control(fam, cfg, params, seqs)
            ctrl_gap = max(served_gap(lg, tok)
                           for lg, tok in zip(logits, firsts))
        del logits

    ref = RS.RefScheduler(sc)
    host_draws = [d.cpu().numpy() for d in draws]
    cursor, bad_ticks = 0, 0
    for arr, budgets, got, modes in windows:
        Kw = len(arr)
        want = ref.window(arr, budgets, modes,
                          [tuple(d[cursor + t] for d in host_draws)
                           for t in range(Kw)])
        cursor += Kw
        bad_ticks += sum(a != b for a, b in zip(want, got))
    checks, correct = judge(gap, bad_ticks, len(ref.pq.faults), checked,
                            gap_limit)
    record["checked_tokens"] = checked
    if control is not None and seqs:
        c_checks, c_correct = judge(ctrl_gap, bad_ticks, len(ref.pq.faults),
                                    checked, gap_limit)
        record["control"] = {"checks": c_checks, "correct": c_correct}

    if prof is not None:
        traced_ctx = [[c for _, c in d]
                      for _, d in rec.ticks[n_window_ticks:]]
        record.update(
            trace=harness.reduce_trace(harness.trace_events(prof)),
            traced_ticks=len(traced_ctx),
            traced_min_bytes=sum(fam.step_bytes(cfg, c, len(c))
                                 for c in traced_ctx))
    return harness.Outcome(
        correct=correct, attempted=len({u for _, d in ticks for u, _ in d}),
        failed=0,
        e2e={"card_us_per_token": card_us, "tokens_per_s": tokens / elapsed,
             "itl_p95_ms": itl_p95, "setup_s": setup_s},
        record=record, checks=checks, peak_bytes=peak)
