"""The metric arithmetic on fixed inputs: whole-window rates, the tail over
every gap, FLOPs and bytes from the configuration's sizes, the trace's
busy time, idle gaps and device time by range, and each reader."""

import math

import numpy as np
import pytest

from portbench import costs, harness
from portbench.systems import serve

CAT = harness.Catalog()
G8B = CAT.cell("g8b-decode-4k")["config_file"]
dense = CAT.module("families", "dense")


def test_p95_is_over_every_gap_of_every_request():
    # three ticks; uid 1 decodes in all, uid 2 in the last two, uid 3 once
    ticks = [(0.0, [1, 3]), (0.1, [1, 2]), (0.35, [1, 2])]
    gaps = serve.token_gaps(ticks)
    assert sorted(gaps) == pytest.approx([0.1, 0.25, 0.25])
    # numpy's percentile, linear between closest ranks, over every gap
    assert np.percentile(gaps, 95) == pytest.approx(0.25)
    assert np.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert serve.token_gaps([(0.0, [1])]) == []


def test_dense_flops_and_bytes_from_the_sizes():
    per_layer = 4096 * 128 * (2 * 32 + 2 * 8) + 3 * 4096 * 14336
    assert per_layer == 218_103_808
    weights = 36 * per_layer + 4096 * 49152
    assert costs.dense_token_flops(G8B, 1000) == 2 * weights \
        + 4 * 36 * 32 * 128 * 1000
    assert costs.dense_token_flops(G8B, 1000) == 16_695_951_360
    assert costs.dense_weight_bytes(G8B) == 2 * (
        36 * (per_layer + 2 * 4096) + 4096 * 49152 + 4096)
    kv_row = 2 * 36 * 8 * 128 * 2  # 147,456 bytes a token
    assert kv_row == costs.kv_row_bytes(G8B) == 147_456
    got = costs.dense_step_bytes(G8B, [1, 11], 2)
    assert got == costs.dense_weight_bytes(G8B) + 10 * kv_row \
        + 2 * kv_row + 2 * 4096 * 2 + 2 * 49152 * 2


def _trace():
    ev = lambda cat, name, ts, dur, **a: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
        "args": a}
    return [
        ev("user_annotation", harness.TRACED, 0, 1000),
        ev("user_annotation", "serve.decode", 100, 500),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        ev("kernel", "k1", 200, 100, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 160, 5, correlation=3),
        ev("kernel", "k1", 250, 100, correlation=3),
        ev("cuda_runtime", "cudaLaunchKernel", 690, 5, correlation=2),
        ev("kernel", "k2", 700, 50, correlation=2),
        ev("cpu_op", "aten::item", 400, 300),
        ev("kernel", "outside", 2000, 10, correlation=9),
    ]


def test_trace_reduction_on_a_hand_trace():
    tr = harness.reduce_trace(_trace())
    assert tr["window_s"] == pytest.approx(1e-3)
    assert tr["busy_s"] == pytest.approx(200e-6)  # [200, 350] + [700, 750]
    assert tr["device_calls"] == 3
    assert tr["device_s_by_label"] == pytest.approx(
        {"serve.decode": 200e-6, "other": 50e-6})
    assert tr["breakdown"]["device_ops"] == [["k1", pytest.approx(2e-4)],
                                             ["k2", pytest.approx(5e-5)]]
    idle = dict(tr["breakdown"]["idle_gaps"])
    assert idle == pytest.approx({"serve.decode / aten::item": 350e-6,
                                  "host outside ops": 250e-6,
                                  "serve.decode": 200e-6})
    assert harness.reduce_trace(_trace()[1:]) is None


def test_readers_on_fixed_records():
    tr = harness.reduce_trace(_trace())
    read = lambda n, rec: CAT.module("metrics", n).read(rec)  # noqa: E731
    sv = {"ticks": 300, "tokens": 19_000, "sched_ms_per_tick": 7.5,
          "occupancy": 98.9, "mfu": 1.1, "trace": tr, "traced_ticks": 2,
          "traced_min_bytes": 36e9}
    assert read("sched_ms_per_tick.serve", sv) == 7.5
    assert read("occupancy.serve", sv) == 98.9
    assert read("mfu.serve", sv) == 1.1
    assert read("decode_dev_ms.serve", sv) == pytest.approx(0.1)
    assert read("attn_share.serve", sv) is None  # no attention range
    assert read("decode_roofline.serve", sv) == pytest.approx(
        100 * 36e9 / 3.35e12 / 200e-6)
    assert read("idle.serve", sv) == pytest.approx(80.0)
    tr2 = dict(tr, device_s_by_label={"serve.decode": 1e-3,
                                      "serve.attention": 3e-3})
    assert read("attn_share.serve", dict(sv, trace=tr2)) == 75.0
    assert math.isfinite(read("decode_dev_ms.serve", dict(sv, trace=tr2)))


def test_host_clock_readers_read_the_window():
    read = lambda n, rec: CAT.module("metrics", n).read(rec)  # noqa: E731
    sv = {"ticks": 300, "tokens": 19_000, "window_s": 20.0,
          "itl_p95_ms": 61.5}
    assert read("tokens_per_s.serve", sv) == 950.0
    assert read("itl_p95_ms.serve", sv) == 61.5
    assert read("tokens_per_s.serve", dict(sv, tokens=0)) is None
    assert read("itl_p95_ms.serve", dict(sv, itl_p95_ms=float("nan"))) is None


class _Ev:
    def __init__(self, device, annotation, start, dur):
        self.device, self.annotation = device, annotation
        self.start, self.dur = start, dur

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur


def test_device_busy_is_the_union_of_the_device_calls():
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_Ev(cuda, False, 100, 50), _Ev(cuda, False, 120, 60),  # 80
              _Ev(cuda, False, 300, 10), _Ev(cuda, False, 305, 10),  # 15
              _Ev(cuda, True, 0, 1000),  # a host range shown on the card
              _Ev(cpu, False, 0, 1000), _Ev(cpu, True, 90, 20)]
    busy, calls = harness.device_busy(events, cuda)
    assert calls == 4
    assert busy == pytest.approx((80 + 15) / 1e9)
    assert harness.device_busy([], cuda) == (0.0, 0)


def test_the_card_clock_sums_every_chunk():
    import torch

    # on the CPU the host's ops stand in for the device's calls
    x = torch.ones(8)

    def calls(chunks):
        clock = harness.CardClock(torch.device("cpu"))
        for n in chunks:
            with clock.chunk():
                for _ in range(n):
                    x.add_(1)
        busy, k = clock.busy()
        assert busy > 0 and clock.busy() == (0.0, 0)
        return k

    assert 0 < calls([3]) < calls([5])
    assert calls([3, 5]) == calls([3]) + calls([5])


def test_kv_line_counts_what_the_contexts_fill():
    # two ticks of two active slots at contexts 10 and 30: mean 20
    ticks = [(0.0, [(1, 10), (2, 30)]), (0.2, [(1, 11), (2, 29)])]
    line = serve.kv_line(G8B, ticks, dense.state_row_bytes(G8B))
    filled = 2 * 20 * 147_456 / 1e9
    held = 64 * 4096 * 147_456 / 1e9
    assert "mean 20.0, max 30 of 4096" in line
    assert f"filled {filled:.3f} GB of {held:.3f} GB held" in line


def test_innermost_range_holding_each_point():
    spans = [(0, 100, "outer"), (10, 20, "a"), (30, 60, "b"),
             (35, 40, "c"), (120, 130, "d")]
    points = [5, 15, 20, 37, 50, 110, 125, -1, 99]
    assert harness.innermost(spans, points) == [
        "outer", "a", "a", "c", "b", None, "d", None, "outer"]
