"""The join of the program's spans to the profiler's trace (`portbench.
spans`) on a hand trace, the host-read rates from two readings of the
counters, and the probe's hooks over a serving run on the CPU."""

import json
import time

import pytest
import torch

from portbench import harness, span_probe, spans
from portbench.test_portbench_faults_serve import small

CAT = harness.Catalog()


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _trace():
    """A traced region of 1,000 us: the harness's ranges around the decode
    step and the attention, five device calls, and the program's spans of
    an engine step (its decode step and attention inside) and of a
    scheduler window."""
    return [
        _ev("user_annotation", harness.TRACED, 0, 1000),
        _ev("user_annotation", "serve.decode", 100, 500),
        _ev("user_annotation", "serve.attention", 140, 260),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        _ev("kernel", "attn1", 200, 100, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=2),
        _ev("kernel", "attn2", 250, 100, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 450, 5, correlation=3),
        _ev("kernel", "mlp", 500, 50, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 690, 5, correlation=4),
        _ev("kernel", "argmax", 700, 50, correlation=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 850, 5, correlation=5),
        _ev("kernel", "pq", 880, 20, correlation=5),
    ]


PROGRAM = [
    _ev("engine", "engine.window", 20, 970),
    _ev("engine", "engine.step", 50, 650),
    _ev("model", "model.decode_step", 110, 480),
    _ev("model", "model.attend", 145, 250),
    _ev("sched", "sched.window", 800, 140),
]


def test_idle_splits_into_the_layers_and_the_rest():
    # busy [200, 350], [500, 550], [700, 750], [880, 900]: 270 of 1,000.
    # Gaps by middle: 100 and 625 in the engine step outside the decode
    # step (350 us), 425 in the decode step (150), 815 in the scheduler's
    # window (130), 950 in the engine's window alone (100).
    red = spans.reduce_spans(_trace(), PROGRAM)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["idle_s"] == pytest.approx(
        {"engine": 350e-6, "decode": 150e-6, "sched": 130e-6,
         "other": 100e-6})
    assert red["idle_by_span"] == pytest.approx(
        {"engine.step": 350e-6, "model.decode_step": 150e-6,
         "sched.window": 130e-6, "engine.window": 100e-6})
    got = spans.span_metrics(red)
    idle = CAT.module("metrics", "idle.serve").read(
        {"trace": harness.reduce_trace(_trace())})
    assert idle == pytest.approx(73.0)
    assert (got["idle_sched.serve"] + got["idle_decode.serve"]
            + got["idle_engine.serve"]
            + 100 * red["idle_s"]["other"] / red["window_s"]) \
        == pytest.approx(idle)
    assert spans.reduce_spans(_trace()[1:], PROGRAM) is None
    line = spans.idle_line(red)
    assert "engine.step 0.350" in line and "of 1.000" in line


def test_attention_share_by_span_equals_the_harness_ranges():
    # attend launches at 150 and 160 (200 us on the device), the decode
    # step's other launch at 450 (50 us): 80 % either way
    red = spans.reduce_spans(_trace(), PROGRAM)
    assert red["attend_dev_s"] == pytest.approx(200e-6)
    assert red["decode_dev_s"] == pytest.approx(250e-6)
    share = CAT.module("metrics", "attn_share.serve").read(
        {"trace": harness.reduce_trace(_trace())})
    assert spans.span_metrics(red)["attn_share_span.serve"] \
        == pytest.approx(share) == pytest.approx(80.0)
    no_step = [s for s in PROGRAM if s["name"] != "model.decode_step"]
    assert "attn_share_span.serve" not in spans.span_metrics(
        spans.reduce_spans(_trace(), no_step))


def test_sync_rates_from_two_readings_of_the_counters():
    before = {"engine.step": [10, 0.5], "smartpq.mode": [10, 0.01]}
    after = {"engine.step": [14, 0.9], "smartpq.mode": [14, 0.03],
             "sched.window": [1, 0.002]}
    got = spans.sync_metrics(before, after, 4)
    assert got["syncs_per_tick.serve"] == pytest.approx(9 / 4)
    assert got["sched_sync_ms_per_tick.serve"] == pytest.approx(
        1e3 * (0.02 + 0.002) / 4)


def test_the_probe_reads_a_traced_run_and_its_replay_agrees():
    """The probe over a traced serving run of the cut-down cell on the
    CPU: the run is correct, every traced span is placed on the profiler's
    clock, the timed window reads one engine read and one mode read a
    tick, and the CPU replay of the scheduler's windows reads what the run
    read at every scheduler site."""
    run = harness.Run(cell=small(), seed=2**31 + 11, seconds=2.0, trace=True,
                      device=torch.device("cpu"), t0=time.perf_counter(),
                      catalog=CAT)
    bench = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
    got = span_probe.probe_run(run, "traced", bench)
    assert got["correct"] and got["replay_matches"]
    assert got["reads_by_site"]["engine.step"] == 1.0
    assert got["reads_by_site"]["smartpq.mode"] == 1.0
    assert got["syncs_per_tick.serve"] >= 4.0
    assert got["spans"] > 0 and got["clock_bound_us"] >= 0
    assert got["per_layer"]["idle.serve"] == pytest.approx(
        got["idle_sched.serve"] + got["idle_decode.serve"]
        + got["idle_engine.serve"] + got["idle_other.serve"])
    assert harness.new_profiler is span_probe._new_profiler
