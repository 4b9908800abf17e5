"""A serving run without the look for a card, on a granite-8b cut to a size
a test can hold on the CPU (12 layers, d 256, 8 slots of 64 positions, KV
chunks of 32 so the chunked attention runs): sound, it comes out correct;
with the timed path broken underneath `correct` comes out false; and the
float8 control, put through the same comparison at the committed limits,
comes out false too.  (One card: no exchange between chips to leave
out.)"""

import time

import pytest
import torch

from portbench import control, harness

CAT = harness.Catalog()
serve = CAT.module("systems", "serve")


def small():
    cell = CAT.cell("g8b-decode-4k")
    cfg = cell["config_file"]
    # A narrow, shallow model carries a rounding less far through its
    # layers than granite-8b's 36 at d 4,096.  Six times the init_std
    # (over the four, sqrt(4096 / 256), that keeps the full width's scale
    # of each pre-activation) and 12 layers bring the float8 control to
    # 1.40-2.10 here (the program 0.08-0.11), as it reads 2.67-3.42 on the
    # card at full size, so both sides meet the committed limit.
    cfg.update(n_layers=12, d_model=256, n_heads=4, n_kv_heads=2,
               head_dim=64, d_ff=896, vocab=4096, init_std=0.12)
    cfg["engine"] = dict(batch_size=8, max_seq=64, kv_chunk=32,
                         sched_window=4)
    # short requests, so that many finish in the window however busy the
    # machine is
    cell["mix"].update(requests=64, max_new_tokens=dict(mean=6, max=12),
                       warm_ticks=8)
    return cell


def run_cell(faults=None, control=None, seed=2**31 + 3, trace=False,
             seconds=2.0):
    run = harness.Run(cell=small(), seed=seed, seconds=seconds, trace=trace,
                      device=torch.device("cpu"), t0=time.perf_counter(),
                      catalog=CAT)
    return serve.run(run, faults=faults, control=control)


def state_unchanged(engine):
    inner = engine._decode

    def decode(params, caches, tokens, lengths):
        saved = {k: v.clone() for k, v in caches.items()}
        logits, caches = inner(params, caches, tokens, lengths)
        for k, v in saved.items():
            caches[k].copy_(v)
        return logits, caches

    engine._decode = decode
    return engine


def half_batch(engine):
    inner = engine._decode

    def decode(params, caches, tokens, lengths):
        logits, caches = inner(params, caches, tokens, lengths)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:h]]), caches

    engine._decode = decode
    return engine


def token_altered(engine):
    inner = engine._greedy

    def greedy(logits):
        tok = inner(logits).clone()
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok

    engine._greedy = greedy
    return engine


def dispatch_altered(engine):
    inner = engine.scheduler.tick_window

    def tick_window(arrivals, budgets):
        return [d[::-1] for d in inner(arrivals, budgets)]

    engine.scheduler.tick_window = tick_window
    return engine


def test_a_sound_run_is_correct():
    out = run_cell()
    assert out.correct, out.checks
    assert out.record["checked_tokens"] > 20
    assert out.e2e["tokens_per_s"] > 0 and out.e2e["itl_p95_ms"] > 0
    # the end-to-end run's window ran in profiled chunks (on the CPU its
    # own ops stand in for the card's calls)
    assert out.record["card_calls"] > 0
    assert 0 < out.record["card_busy_s"] < out.record["window_s"]
    assert out.e2e["card_us_per_token"] == (
        out.record["card_busy_s"] * 1e6 / out.record["tokens"])


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered, dispatch_altered])
def test_a_broken_timed_path_is_not_correct(fault):
    out = run_cell(faults=fault)
    assert not out.correct, out.checks


def test_the_float8_control_is_not_correct():
    out = run_cell(control=control.fp8_control)
    assert out.correct, out.checks
    ctrl = out.record["control"]
    assert not ctrl["correct"], ctrl["checks"]
    (name, gap, limit), = [c for c in ctrl["checks"] if c[0] == "logit_gap"]
    assert limit == small()["config_file"]["logit_gap_limit"] == 1.1
    assert gap > limit > out.checks[0][1]


def test_the_host_clock_counters_leave_the_traced_ticks_out():
    out = run_cell(trace=True)
    rec = out.record
    assert out.correct, out.checks
    assert rec["traced_ticks"] == 8  # two scheduling windows of 4
    # the counters read the window the end-to-end metrics read
    assert rec["tokens"] / rec["window_s"] == out.e2e["tokens_per_s"]
    assert 0 < rec["occupancy"] <= 100 and rec["sched_ms_per_tick"] > 0
    assert rec["mfu"] > 0 and rec["trace"]["window_s"] > 0
