"""Parity of the port's PQ modules with the JAX package, on the CPU.

The same seeded numpy inputs go through both packages, op by op, and every
output and every `PQState` leaf (dtype included) must be bit-identical.  The
spray and MULTIQ schedules take the reference's `jax.random` draws as
tensors, computed here from the same per-step keys.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pqueue.local as JL
from repro.core.pqueue import ops as JO
from repro.core.pqueue import partition as JP
from repro.core.pqueue.schedules import Schedule as JS
from repro.core.pqueue.state import invariant_violations as j_viol
from repro.core.pqueue.state import make_state as j_make_state
from repro.core.pqueue.state import state_fingerprint as j_fingerprint
from repro.utils.hashing import shard_of_key as j_shard_of_key
import repro_torch.core.pqueue.local as TL
from repro_torch import convert
from repro_torch.core.pqueue import ops as TO
from repro_torch.core.pqueue import partition as TP
from repro_torch.core.pqueue.schedules import Schedule as TS
from repro_torch.core.pqueue.state import invariant_violations as t_viol
from repro_torch.core.pqueue.state import make_state as t_make_state
from repro_torch.core.pqueue.state import state_fingerprint as t_fingerprint
from repro_torch.utils.hashing import shard_of_key as t_shard_of_key

# The tensors here are small: one intra-op thread per test process keeps
# torch from contending for the cores with the suite's other workers.
torch.set_num_threads(1)

INF_KEY = 2**31 - 1
PORTED = ["STRICT_FLAT", "SPRAY_HERLIHY", "HIER", "FFWD", "LOCAL",
          "SPRAY_FRASER", "MULTIQ"]


def t(a):
    return torch.as_tensor(np.array(a))


def to_port(st):
    return convert.state_from_numpy(
        {f.name: np.asarray(getattr(st, f.name))
         for f in dataclasses.fields(st)}, device="cpu")


def assert_state_equal(jst, tst, where=""):
    for f in dataclasses.fields(jst):
        a = np.asarray(getattr(jst, f.name))
        b = getattr(tst, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {f.name}")
    assert j_fingerprint(jst) == t_fingerprint(tst), where


def assert_out_equal(a, b, where=""):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=where)


def jit(fn, **static):
    """A fresh jitted JAX function (own compile cache, so a monkeypatched
    module constant is traced anew), static arguments bound."""
    return jax.jit(functools.partial(fn, **static))


def spray_draws(key, m, S, H):
    """The reference spray core's two draws (schedules.py:252-256,275-276)
    from one step key, as numpy."""
    pad = (max(int(S - 1).bit_length(), 1) + 1) ** 2
    W = min(m + pad, H)
    k_shard, k_pos = jax.random.split(key)
    sc = jax.random.randint(k_shard, (m,), 0, S)
    hi = jax.random.randint(k_pos, (S, W), 0, (1 << 31) // (W + 1) - 1,
                            dtype=jnp.int32)
    return np.asarray(sc), np.asarray(hi)


def multiq_draws(key, m, S):
    """The reference MULTIQ core's two draws (schedules.py:323-328)."""
    k_a, k_b = jax.random.split(key)
    return (np.asarray(jax.random.randint(k_a, (m,), 0, S)),
            np.asarray(jax.random.randint(k_b, (m,), 0, S)))


# ---------------------------------------------------------------------------
# hashing and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [1, 3, 8, 16, 64])
def test_shard_of_key_int32_edges(num_shards):
    rng = np.random.default_rng(num_shards)
    keys = np.concatenate([
        np.array([-(2**31), -(2**31) + 1, -65536, -1, 0, 1, 65535, 65536,
                  2**31 - 2, 2**31 - 1], np.int32),
        rng.integers(-(2**31), 2**31 - 1, 500).astype(np.int32),
    ])
    assert_out_equal(j_shard_of_key(jnp.asarray(keys), num_shards),
                     t_shard_of_key(t(keys), num_shards))


def test_route_dense_and_capped():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 40, 64).astype(np.int32)  # heavy ties
    vals = np.arange(64, dtype=np.int32)
    mask = rng.random(64) < 0.8
    for a, b in zip(JP.route_dense(keys, vals, mask, 8),
                    TP.route_dense(t(keys), t(vals), t(mask), 8)):
        assert_out_equal(a, b, "route_dense")
    for a, b in zip(JP.route_capped(keys, vals, mask, 8, 1.5),
                    TP.route_capped(t(keys), t(vals), t(mask), 8, 1.5)):
        assert_out_equal(a, b, "route_capped")


# ---------------------------------------------------------------------------
# insert / deleteMin, op by op, every ported schedule
# ---------------------------------------------------------------------------


def _step_both(japply, jst, tst, ops, keys, vals, schedule, step,
               eliminate, npods=2):
    """One op batch through both packages; `japply` caches the JAX side's
    jitted `apply_op_batch` per elimination flag."""
    S, H = tst.num_shards, tst.head_width
    key = jax.random.key(step)
    B = ops.shape[0]
    if eliminate not in japply:
        japply[eliminate] = jit(JO.apply_op_batch, schedule=JS[schedule],
                                npods=npods, eliminate=eliminate)
    jr = japply[eliminate](jst, jnp.asarray(ops), jnp.asarray(keys),
                           jnp.asarray(vals), rng=key)
    draws = (multiq_draws(key, B, S) if schedule == "MULTIQ"
             else spray_draws(key, B, S, H))
    tr = TO.apply_op_batch(tst, t(ops), t(keys), t(vals),
                           schedule=TS[schedule],
                           draws=tuple(t(d) for d in draws),
                           npods=npods, eliminate=eliminate)
    where = f"{schedule} step {step}"
    for f in ("deleted_keys", "deleted_vals", "n_deleted", "dropped"):
        assert_out_equal(getattr(jr, f), getattr(tr, f), f"{where} {f}")
    assert_state_equal(jr.state, tr.state, where)
    return jr.state, tr.state


@pytest.mark.parametrize("schedule", PORTED)
def test_op_batches_bitmatch(schedule):
    rng = np.random.default_rng(7)
    jst = j_make_state(4, 64, head_width=16)
    tst = t_make_state(4, 64, head_width=16, device="cpu")
    japply = {}
    for step in range(14):
        ins_frac = 0.7 if step < 7 else 0.3
        ops = (rng.random(16) > ins_frac).astype(np.int32)
        keys = rng.integers(0, 60, 16).astype(np.int32)
        vals = rng.integers(0, 99, 16).astype(np.int32)
        jst, tst = _step_both(japply, jst, tst, ops, keys, vals, schedule,
                              step, eliminate=bool(step % 2))
        assert not t_viol(tst) and not j_viol(jst)


def test_insert_with_no_live_lane_leaves_state():
    tst = t_make_state(4, 64, head_width=16, device="cpu")
    keys = t(np.full(8, INF_KEY, np.int32))
    st2, dropped = TO.insert(tst, keys, t(np.zeros(8, np.int32)))
    assert st2 is tst and dropped.dtype == torch.int32


def test_peek_min_and_capped_insert():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 300, 96).astype(np.int32)
    vals = (keys % 97).astype(np.int32)
    jst, jd = jit(JO.insert, capacity_factor=2.0)(
        j_make_state(4, 64, head_width=8), keys, vals)
    tst, td = TO.insert(t_make_state(4, 64, head_width=8, device="cpu"),
                        t(keys), t(vals), capacity_factor=2.0)
    assert_out_equal(jd, td)
    assert_state_equal(jst, tst)
    for a, b in zip(jit(JO.peek_min, m=8)(jst), TO.peek_min(tst, 8)):
        assert_out_equal(a, b, "peek_min")


# ---------------------------------------------------------------------------
# the tiered state's rebalances
# ---------------------------------------------------------------------------


def _filled(seed, n=120, S=4, C=64, H=8):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 500, n).astype(np.int32)
    vals = (keys % 97).astype(np.int32)
    jst, _ = jit(JO.insert)(j_make_state(S, C, head_width=H), keys, vals)
    tst, _ = TO.insert(t_make_state(S, C, head_width=H, device="cpu"),
                       t(keys), t(vals))
    return jst, tst, rng


def test_refill_head_and_compact_tail_bitmatch():
    jst, tst, rng = _filled(5)
    j_delete = jit(JO.delete_min, m=8, schedule=JS.STRICT_FLAT, active=8)
    j_insert, j_refill, j_compact = (jit(JO.insert), jit(JL.refill_head),
                                     jit(JL.compact_tail))
    for r in range(6):
        # drain the heads, append behind the boundary, then rebalance
        d = j_delete(jst)
        e = TO.delete_min(tst, 8, schedule=TS.STRICT_FLAT, active=8)
        assert_state_equal(d.state, e.state, f"round {r} delete")
        more = rng.integers(0, 500, 12).astype(np.int32)
        jst, _ = j_insert(d.state, more, more % 97)
        tst, _ = TO.insert(e.state, t(more), t(more % 97))
        assert_state_equal(jst, tst, f"round {r} insert")
        jst, tst = j_refill(jst), TL.refill_head(tst)
        assert_state_equal(jst, tst, f"round {r} refill")
        jst, tst = j_compact(jst), TL.compact_tail(tst)
        assert_state_equal(jst, tst, f"round {r} compact")
        assert not t_viol(tst)


@pytest.mark.parametrize("bucket_width", [4, 16])
def test_bucketed_tail_compaction_bitmatch(monkeypatch, bucket_width):
    """bucket_width=16 keeps every compaction on the bucket merge,
    bucket_width=4 forces the over-wide full-sort fallback
    (tests/test_fused_window.py:292)."""
    monkeypatch.setattr(JL, "TAIL_BUCKET_WIDTH", bucket_width)
    monkeypatch.setattr(TL, "TAIL_BUCKET_WIDTH", bucket_width)
    rng = np.random.default_rng(100 + bucket_width)
    jst = j_make_state(4, 64, head_width=8)
    tst = t_make_state(4, 64, head_width=8, device="cpu")
    compacted = False
    japply = {}
    for step in range(25):
        ops = (rng.random(8) > 0.7).astype(np.int32)
        keys = rng.integers(0, 300, 8).astype(np.int32)
        vals = rng.integers(0, 99, 8).astype(np.int32)
        jst, tst = _step_both(japply, jst, tst, ops, keys, vals,
                              "STRICT_FLAT", step, eliminate=bool(step % 2),
                              npods=1)
        compacted |= bool(torch.any(tst.tail_sorted > 0))
    assert compacted, "workload never produced a sorted tail run"


def test_seq_renumber_on_near_wrap_bitmatch():
    jst, tst, rng = _filled(11, n=80)
    off = JL.SEQ_RENUMBER_THRESHOLD
    assert off == TL.SEQ_RENUMBER_THRESHOLD
    jst = dataclasses.replace(jst, head_seq=jst.head_seq + off,
                              tail_seq=jst.tail_seq + off,
                              next_seq=jst.next_seq + off)
    tst = to_port(jst)
    more = rng.integers(0, 500, 16).astype(np.int32)
    jst, _ = jit(JO.insert)(jst, more, more % 97)
    tst, _ = TO.insert(tst, t(more), t(more % 97))
    assert_state_equal(jst, tst)
    assert int(tst.next_seq.max()) <= int(tst.total_size) + 1


def test_invariant_violations_agree_on_corrupt_states():
    jst, tst, _ = _filled(3)
    hk = np.asarray(jst.head_keys).copy()
    hk[1, [0, 1]] = hk[1, [1, 0]] + np.array([5, 0], np.int32)  # I1
    ts = np.asarray(jst.tail_start).copy()
    ts[2] = 60  # window off the arena (I5)
    for corrupt in (dict(head_keys=jnp.asarray(hk)),
                    dict(tail_start=jnp.asarray(ts))):
        bad = dataclasses.replace(jst, **corrupt)
        want = [(v.invariant, v.shard, v.detail)
                for v in j_viol(bad, first_only=False)]
        got = [(v.invariant, v.shard, v.detail)
               for v in t_viol(to_port(bad), first_only=False)]
        assert want and got == want
