"""The plain references on small hand cases, and held to the program where
the two must agree exactly (the shard hash; a float32 decode)."""

import numpy as np
import torch

from portbench import harness
from portbench.ref import dense as RD
from portbench.ref import pq as R

INF = R.INF_KEY
dense = harness.Catalog().module("families", "dense")
SERVE = harness.Catalog().module("systems", "serve")


def _mix32(x: int) -> int:
    m = 0xFFFFFFFF
    h = x & m
    h ^= h >> 16
    h = (h * 0x9E3779B1) & m
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & m
    return h ^ (h >> 16)


def test_shard_hash_is_the_finalizer_and_the_programs():
    from repro_torch.utils.hashing import shard_of_key

    keys = np.array([0, 1, 2, 77, 2**21 - 1, 2**31 - 2, -5, -(2**31)],
                    np.int64)
    want = [_mix32(int(k)) % 16 for k in keys]
    assert R.shard_of_key(keys, 16).tolist() == want
    assert shard_of_key(torch.as_tensor(keys.astype(np.int32)),
                        16).tolist() == want


def _queue(keys, lanes=4, S=2, H=8, C=16, schedules=("SPRAY_HERLIHY",
                                                      "MULTIQ", "HIER")):
    q = R.RefSmartPQ(S, C, H, lanes, 1, 1, schedules, True, 2)
    q.prefill(np.array(keys), np.arange(len(keys)) + 100, batch=4)
    return q


def _lanes(ops, keys, vals=None):
    n = len(ops)
    return (np.array(ops), np.array(keys),
            np.array(vals if vals is not None else [0] * n))


def test_exact_deletemin_returns_the_smallest_in_order():
    q = _queue([5, 3, 9, 1, 7, 3])
    k, v, n = q.step(*_lanes([1, 1, 1, 1], [INF] * 4), mode=2)
    assert n == 4 and k.tolist() == [1, 3, 3, 5]
    # equal keys: the one inserted first (lane 1 of the batch) leaves first
    assert v.tolist() == [103, 101, 105, 100]
    assert q.size() == 2 and q.stats["mode_steps"] == [0, 0, 1]
    k, v, n = q.step(*_lanes([1, 1, 1, 2], [INF] * 4), mode=2)
    assert n == 2 and k.tolist() == [7, 9, INF, INF]
    assert q.size() == 0 and q.stats["n_delete"] == 0  # decided every step


def test_elimination_serves_inserts_below_the_minimum():
    q = _queue([10, 20, 30])
    k, v, n = q.step(*_lanes([0, 0, 1, 1], [2, 50, INF, INF],
                             [7, 8, 0, 0]), mode=2)
    assert n == 2 and k.tolist() == [2, 10, INF, INF]
    assert v.tolist() == [7, 100, 0, 0]
    assert q.stats["eliminated"] == 1 and q.size() == 3  # 20, 30, 50


def test_multiq_ties_go_to_the_lower_shard():
    keys = [k for k in range(200) if R.shard_of_key([k], 2)[0] == 0][:3] \
        + [k for k in range(200) if R.shard_of_key([k], 2)[0] == 1][:3]
    q = _queue(keys)
    mins = [q.contents(s)[0][0] for s in range(2)]
    # two deleters both draw (shard 1, shard 0): the smaller minimum wins
    draws = (np.array([1, 1, 0, 0]), None, np.array([0, 0, 1, 1]))
    k, _, n = q.step(*_lanes([1, 1, 0, 0], [INF, INF, 500, 501]),
                     mode=1, draws=draws)
    s = int(np.argmin(mins))
    assert n == 2 and k[:2].tolist() == q_first_two(keys, s)


def q_first_two(keys, s):
    return sorted(k for k in keys if R.shard_of_key([k], 2)[0] == s)[:2]


def test_spray_pops_the_slots_with_the_smallest_scores():
    keys = [k for k in range(400) if R.shard_of_key([k], 2)[0] == 0][:6]
    q = _queue(keys)
    W = q.W
    hi = np.zeros((2, W), np.int64)
    hi[0, :] = np.arange(W)[::-1]  # the last slots of the window score low
    draws = (np.array([0, 0, 1, 1]), hi, None)
    k, _, n = q.step(*_lanes([1, 1, 2, 2], [INF] * 4), mode=0, draws=draws)
    # 2 deleters on shard 0, window = min(2 + pad, 6 keys): its last two
    assert n == 2 and k[:2].tolist() == sorted(keys)[4:6]


def test_mode_changes_only_on_decision_steps():
    q = R.RefSmartPQ(2, 16, 8, 4, 1, 4, ("SPRAY_HERLIHY", "MULTIQ", "HIER"),
                     True, 2)
    q.prefill(np.arange(8), np.arange(8), 4)
    for mode in [0, 0, 2, 0, 0]:
        q.step(*_lanes([2, 2, 2, 2], [INF] * 4), mode=mode)
    assert len(q.faults) == 2  # steps 2 and 3 are not decision steps
    assert q.stats["transitions"] == 3


SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=96, vocab=128)


def test_dense_reference_is_causal_and_ropes_from_position_zero():
    cfg = dict(harness.Catalog().cell("g8b-decode-4k")["config_file"], **SMALL)
    p = dense.make_weights(cfg, 3, torch.device("cpu"), torch.float32)
    seq = torch.tensor([5, 9, 1, 77, 3, 3, 120])
    full, = RD.forward(cfg, p, [seq])
    part, = RD.forward(cfg, p, [seq[:4]])
    torch.testing.assert_close(full[:4], part, rtol=1e-5, atol=1e-5)
    x = torch.randn(3, 2, 16)
    r = RD.rope(x, 1e4)
    torch.testing.assert_close(r[0], x[0])
    torch.testing.assert_close(r.norm(dim=-1), x.norm(dim=-1))
    assert SERVE.served_gap(full, full.argmax(-1)) == 0.0
    w = torch.randn(64, 32)
    q = RD.quantize_fp8(w)
    assert (q - w).abs().max() <= w.abs().max(0).values.max() / 8


def test_dense_reference_matches_the_programs_float32_decode():
    from repro_torch.models.io import init_caches
    from repro_torch.models.registry import build_model

    cfg = dict(harness.Catalog().cell("g8b-decode-4k")["config_file"], **SMALL)
    p = dense.make_weights(cfg, 4, torch.device("cpu"), torch.float32)
    mcfg = dense.model_config(cfg)
    model = build_model(mcfg, compute_dtype=torch.float32, kv_chunk=8,
                        device="cpu")
    caches = init_caches(mcfg, 2, 16, dtype=torch.float32, device="cpu")
    seqs = torch.tensor([[5, 9, 1, 77, 3, 3, 120, 8, 8, 0, 44],
                         [7, 7, 2, 100, 6, 51, 9, 9, 1, 2, 3]])
    got = []
    with torch.no_grad():
        for t in range(seqs.shape[1]):
            at = torch.full((2,), t, dtype=torch.int32)
            lg, caches = model.decode_step(p, caches, seqs[:, t:t + 1], at)
            got.append(lg)
    got = torch.stack(got, 1)
    want = RD.forward(cfg, p, list(seqs))
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], rtol=2e-4, atol=2e-4)
