"""Traffic and weights made from the seed: the same seed gives the same
inputs, another seed others, and the mix keeps the shape it states."""

import json
from pathlib import Path

import numpy as np

from portbench import harness

CAT = harness.Catalog()
dense = CAT.module("families", "dense")
HERE = Path(__file__).resolve().parent
SEED = 2**31 + 12345  # above 32 signed bits, as the driver's seeds are


def test_backlog_repeats_from_the_seed_and_keeps_its_ranges():
    cell = CAT.cell("g8b-decode-4k")
    mix = cell["mix"]
    gen = CAT.module("traffic", "offline_backlog")
    a = gen.requests(mix, SEED)
    b = gen.requests(mix, SEED + 1)
    assert a == gen.requests(mix, SEED) and a != b
    uid, plen, new, slo = map(np.array, zip(*a))
    n = mix["requests"]
    assert n == 6144 and len(a) == n and (uid == np.arange(n)).all()
    # the trace's means, geometric lengths from 1
    assert abs(new.mean() - 58.45) < 0.5 and abs(plen.mean() - 19.31) < 0.5
    assert new.min() == 1 and plen.min() == 1 and new.max() <= 4000
    assert np.median(new) == 41  # a geometric's median, not its mean
    # every seed the same set of lengths and classes, in its own order
    for x, y in zip(zip(*a), zip(*b)):
        assert sorted(x) == sorted(y)
    assert np.bincount(slo).tolist() == [2048, 2048, 2048]
    assert mix["warm_ticks"] >= 4 * mix["max_new_tokens"]["mean"]
    # the backlog outlasts the warm ticks and a window of `run_seconds` at
    # every slot busy and a 13 ms step: the window never drains it
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    slots = cell["config_file"]["engine"]["batch_size"]
    assert new.sum() > slots * (mix["warm_ticks"] + 4
                                + bench["run_seconds"] / 0.013)


def test_weights_repeat_from_the_seed():
    import torch

    small = dict(CAT.cell("g8b-decode-4k")["config_file"], n_layers=2,
                 d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                 vocab=128)
    p1 = dense.make_weights(small, SEED, torch.device("cpu"))
    p2 = dense.make_weights(small, SEED, torch.device("cpu"))
    p3 = dense.make_weights(small, SEED + 1, torch.device("cpu"))
    assert p1["attn"]["wq"].shape == (2, 64, 64)
    assert p1["mlp"]["w_down"].shape == (2, 96, 64)
    assert p1["head"].dtype == torch.bfloat16
    assert torch.equal(p1["mlp"]["w_up"], p2["mlp"]["w_up"])
    assert not torch.equal(p1["mlp"]["w_up"], p3["mlp"]["w_up"])
