"""Traffic and weights made from the seed: the same seed gives the same
inputs, another seed others, and the mix keeps the shape it states."""

import numpy as np

from portbench import harness

CAT = harness.Catalog()
serve = CAT.module("systems", "serve")
SEED = 2**31 + 12345  # above 32 signed bits, as the driver's seeds are


def test_backlog_repeats_from_the_seed_and_keeps_its_ranges():
    cell = CAT.cell("g8b-decode-4k")
    mix = cell["mix"]
    gen = CAT.module("traffic", "offline_backlog")
    a = gen.requests(mix, SEED)
    b = gen.requests(mix, SEED + 1)
    assert a == gen.requests(mix, SEED) and a != b
    uid, plen, new, slo = map(np.array, zip(*a))
    assert len(a) == 1024 and (uid == np.arange(1024)).all()
    # the trace's means, geometric lengths from 1
    assert abs(new.mean() - 58.45) < 0.5 and abs(plen.mean() - 19.31) < 0.5
    assert new.min() == 1 and plen.min() == 1 and new.max() <= 4000
    assert np.median(new) == 41  # a geometric's median, not its mean
    # every seed the same set of lengths and classes, in its own order
    for x, y in zip(zip(*a), zip(*b)):
        assert sorted(x) == sorted(y)
    assert np.bincount(slo).tolist() == [342, 341, 341]
    assert mix["warm_ticks"] >= 4 * mix["max_new_tokens"]["mean"]


def test_weights_repeat_from_the_seed():
    import torch

    small = dict(CAT.cell("g8b-decode-4k")["config_file"], n_layers=2,
                 d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                 vocab=128)
    p1 = serve.make_weights(small, SEED, torch.device("cpu"))
    p2 = serve.make_weights(small, SEED, torch.device("cpu"))
    p3 = serve.make_weights(small, SEED + 1, torch.device("cpu"))
    assert p1["attn"]["wq"].shape == (2, 64, 64)
    assert p1["mlp"]["w_down"].shape == (2, 96, 64)
    assert p1["head"].dtype == torch.bfloat16
    assert torch.equal(p1["mlp"]["w_up"], p2["mlp"]["w_up"])
    assert not torch.equal(p1["mlp"]["w_up"], p3["mlp"]["w_up"])
