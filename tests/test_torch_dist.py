"""Parity of the port's distributed PQ (`repro_torch.core.pqueue.dist`) and
of Nuddle's `delegate_dist` with the JAX package, on the CPU.

Eight gloo ranks, one process each (`repro_torch.distributed.spawn`, rank
code in tests/torch_dist_ranks.py, which loads no jax), run every case on a
(pod=2, shard=4) mesh and on a one-axis ("dev",) mesh of the same 8 ranks.
The reference runs in this process:

  - `insert_dist` and `delete_flat_dist` under `jax.vmap(..., axis_name=
    "dev")` with `AxisCfg(("dev",), None)`, the one form of the reference's
    distributed code that runs on this container (its 8-device shard_map
    scripts fail under jax 0.9.0); every state leaf, `dropped`, `rejected`
    and the outputs bit-equal;
  - HIER and FFWD, which need two named axes or a partial ppermute, against
    the port's flat schedule (bit-equal, every leaf) and the reference's
    single-controller `delete_min(STRICT_FLAT)`, as tests/device_scripts/
    dist_pq_check.py:72-84 holds them;
  - spray and MULTIQ against the reference's `delete_spray_herlihy` and
    `delete_multiq` at npods=1 on each rank's slice, with the draws of the
    rank's `fold_in(key(7), rank)` key (multiq_8dev.py:49), and no
    collective on their delete path;
  - `delegate_dist`'s verdict against `delegate_single_controller`.

The cases hold duplicate keys; the second keeps a tail tier (H = 16 of
C = 64), masks lanes and has `capacity_factor` reject lanes; the third
fills the shards by hand so that copies of one key sit on every rank and
the cutoff of the winners ties across ranks (hash placement keeps all
copies of a key on one shard).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.nuddle import delegate_single_controller, pq_tournament_ops
from repro.core.pqueue import dist as JD
from repro.core.pqueue import ops as JO
from repro.core.pqueue import schedules as JSCH
from repro.core.pqueue.schedules import Schedule as JS
from repro.core.pqueue.state import INF_KEY
from repro.core.pqueue.state import make_state as j_make_state
from repro_torch.distributed import spawn
from torch_dist_ranks import dist_pq
from torch_draws import draws_from_keys

N_DEV, S_LOC = 8, 2
CASES = {
    # tests/device_scripts/dist_pq_check.py's case (seed 3, 200 keys)
    "dist_pq_check": dict(seed=3, C=64, H=None, n_keys=200, key_hi=5000,
                          B=8, mask_p=1.0, capacity_factor=8.0, m=8,
                          active=5, m_loc=8, active_loc=8, nuddle_n=4),
    # a tail tier, heavy duplicates, masked lanes, cap = 1 rejects lanes
    "tiered_rejects": dict(seed=11, C=64, H=16, n_keys=300, key_hi=60,
                           B=8, mask_p=0.8, capacity_factor=1.0, m=8,
                           active=8, m_loc=4, active_loc=3, nuddle_n=8),
    # hash placement puts every copy of a key on one shard; rows filled by
    # hand put copies of each key on every rank, so the winners' cutoff
    # ties across ranks and the tie slots go by rank
    "cross_rank_ties": dict(seed=5, C=64, H=None, n_keys=0, key_hi=12,
                            row_fill=20, B=8, mask_p=0.9,
                            capacity_factor=2.0, m=8, active=7, m_loc=8,
                            active_loc=6, nuddle_n=7),
}
LEAVES = ("head_keys", "head_vals", "head_seq", "tail_keys", "tail_vals",
          "tail_seq", "head_size", "tail_size", "tail_start", "tail_sorted",
          "next_seq")


def _filled_by_hand(st, rng, c):
    """Each shard's head holds `row_fill` sorted keys from [0, key_hi)."""
    S, H = st.head_keys.shape
    n = c["row_fill"]
    keys = np.full((S, H), INF_KEY, np.int32)
    keys[:, :n] = np.sort(rng.integers(0, c["key_hi"], (S, n)), axis=1)
    seq = np.where(np.arange(H) < n, np.arange(H), 0).astype(np.int32)
    vals = np.where(keys < INF_KEY, rng.integers(0, 99, (S, H)), 0)
    size = np.full(S, n, np.int32)
    return dataclasses.replace(
        st, head_keys=jnp.asarray(keys), head_vals=jnp.asarray(vals, jnp.int32),
        head_seq=jnp.asarray(np.tile(seq, (S, 1))),
        head_size=jnp.asarray(size), next_seq=jnp.asarray(size))


def _case_inputs(c):
    rng = np.random.default_rng(c["seed"])
    st = j_make_state(N_DEV * S_LOC, c["C"], head_width=c["H"])
    if c["n_keys"]:
        st, _ = jax.jit(JO.insert)(
            st, jnp.asarray(rng.integers(0, c["key_hi"], c["n_keys"]),
                            jnp.int32),
            jnp.asarray(rng.integers(0, 99, c["n_keys"]), jnp.int32))
    else:
        st = _filled_by_hand(st, rng, c)
    ins_k = rng.integers(0, c["key_hi"], (N_DEV, c["B"])).astype(np.int32)
    ins_v = rng.integers(0, 99, (N_DEV, c["B"])).astype(np.int32)
    ins_mask = rng.random((N_DEV, c["B"])) < c["mask_p"]
    rngs = jnp.stack([jax.random.fold_in(jax.random.key(7), d)
                      for d in range(N_DEV)])
    return st, ins_k, ins_v, ins_mask, rngs


@functools.lru_cache(maxsize=None)
def _jax_step(m, active, capacity_factor, m_loc, active_loc):
    cfg = JD.AxisCfg(shard_axes=("dev",), pod_axis=None)

    def one(st, k, v, mask, rng):
        st1, dropped, rejected = JD.insert_dist(st, k, v, mask, cfg,
                                                capacity_factor)
        flat = JD.delete_flat_dist(st1, m, jnp.int32(active), rng, cfg)
        spray = JSCH.delete_spray_herlihy(st1, m_loc, jnp.int32(active_loc),
                                          rng, npods=1)
        multiq = JSCH.delete_multiq(st1, m_loc, jnp.int32(active_loc), rng,
                                    npods=1)
        return (st1, dropped, rejected), flat, tuple(spray), tuple(multiq)

    return jax.jit(jax.vmap(one, axis_name="dev"))


def _reference(c, st, ins_k, ins_v, ins_mask, rngs):
    split = jax.tree.map(lambda a: a.reshape(N_DEV, S_LOC, *a.shape[1:]), st)
    (st1, dropped, rejected), flat, spray, multiq = _jax_step(
        c["m"], c["active"], c["capacity_factor"], c["m_loc"],
        c["active_loc"])(split, jnp.asarray(ins_k), jnp.asarray(ins_v),
                         jnp.asarray(ins_mask), rngs)
    # The single-controller run of the same batch: the lanes the frames
    # kept, in device order.
    kept = (ins_mask & ~np.asarray(rejected)).reshape(-1)
    st_sc, _ = jax.jit(JO.insert)(st, jnp.asarray(ins_k.reshape(-1)),
                                  jnp.asarray(ins_v.reshape(-1)),
                                  jnp.asarray(kept))
    sc = JO.delete_min(st_sc, c["m"], schedule=JS.STRICT_FLAT,
                       active=c["active"])
    _, verdict = delegate_single_controller(
        pq_tournament_ops(), {"keys": st.keys, "vals": st.vals}, c["m"],
        npods=2, ctx={"n": jnp.int32(c["nuddle_n"])})
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {
        "insert": {"state": {f: np.asarray(getattr(st1, f)) for f in LEAVES},
                   "dropped": np.asarray(dropped),
                   "rejected": np.asarray(rejected)},
        "flat": np_(flat), "spray": np_(spray), "multiq": np_(multiq),
        "sc_keys": np.asarray(sc.keys), "sc_vals": np.asarray(sc.vals),
        "sc_remaining": np.sort(np.asarray(
            sc.state.keys[sc.state.keys < INF_KEY])),
        "nuddle_k": np.asarray(verdict["k"]),
    }


@pytest.fixture(scope="module")
def runs():
    """{case: (reference, [port result of each rank])}: the 8 ranks run in
    the background while this process computes the reference."""
    inputs, port_cases = {}, []
    for name, c in CASES.items():
        st, ins_k, ins_v, ins_mask, rngs = inputs[name] = _case_inputs(c)
        H = st.head_keys.shape[1]
        sc, hi, cb = (x.numpy() for x in draws_from_keys(rngs, S_LOC,
                                                         c["m_loc"], H))
        port_cases.append(dict(
            S_loc=S_LOC, state={f: np.asarray(getattr(st, f))
                                for f in LEAVES},
            ins_k=ins_k, ins_v=ins_v, ins_mask=ins_mask,
            draws={"sc": sc, "hi": hi, "cb": cb},
            **{k: c[k] for k in ("capacity_factor", "m", "active", "m_loc",
                                 "active_loc", "nuddle_n")}))
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(spawn, dist_pq, (2, 4), ("pod", "shard"),
                         device="cpu", args=(port_cases,), timeout=300)
        refs = {name: _reference(CASES[name], *inputs[name])
                for name in CASES}
        ranks = port.result()
    return {name: (refs[name], [r[i] for r in ranks])
            for i, name in enumerate(CASES)}


def _eq(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    np.testing.assert_array_equal(a, b, err_msg=where)


def _eq_state(ref_leaves, port_state, where):
    for f in LEAVES:
        _eq(ref_leaves[f], port_state[f], f"{where} {f}")


@pytest.mark.parametrize("case", list(CASES))
def test_insert_dist_bitmatches_jax_one_axis_vmap(runs, case):
    ref, ranks = runs[case]
    ri = ref["insert"]
    for r, res in enumerate(ranks):
        for key in ("insert_1axis", "insert"):  # ("dev",) and (pod, shard)
            got = res[key]
            _eq_state({f: ri["state"][f][r] for f in LEAVES}, got["state"],
                      f"{case} rank {r} {key}")
            _eq(ri["dropped"][r], got["dropped"], f"{case} {r} dropped")
            _eq(ri["rejected"][r], got["rejected"], f"{case} {r} rejected")
    if case == "tiered_rejects":
        assert ri["rejected"].sum() > 0  # the frames overflowed
        keys = CASES[case]
        assert keys["n_keys"] > keys["key_hi"]  # duplicates across ranks


@pytest.mark.parametrize("case", list(CASES))
def test_delete_flat_dist_bitmatches_jax_one_axis_vmap(runs, case):
    ref, ranks = runs[case]
    f_state, f_k, f_v, f_n = ref["flat"]
    for r, res in enumerate(ranks):
        for key in ("flat_1axis", "flat"):
            got = res[key]
            _eq_state({f: getattr(f_state, f)[r] for f in LEAVES},
                      got["state"], f"{case} rank {r} {key}")
            for name, want in (("keys", f_k), ("vals", f_v), ("n", f_n)):
                _eq(want[r], got[name], f"{case} rank {r} {key} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_hier_and_ffwd_equal_flat_and_single_controller(runs, case):
    ref, ranks = runs[case]
    for r, res in enumerate(ranks):
        for name in ("hier", "ffwd"):
            _eq_state(res["flat"]["state"], res[name]["state"],
                      f"{case} rank {r} {name}")
            for out in ("keys", "vals", "n"):
                _eq(res["flat"][out], res[name][out],
                    f"{case} rank {r} {name} {out}")
        _eq(ref["sc_keys"], res["hier"]["keys"], f"{case} {r} vs STRICT")
        _eq(ref["sc_vals"], res["hier"]["vals"], f"{case} {r} vs STRICT")
    remaining = np.concatenate([
        np.concatenate([res["hier"]["state"]["head_keys"].ravel(),
                        _tail_window(res["hier"]["state"])])
        for res in ranks])
    _eq(ref["sc_remaining"], np.sort(remaining[remaining < INF_KEY]),
        f"{case} remaining multiset")


def _tail_window(st):
    col = np.arange(st["tail_keys"].shape[1])[None, :]
    lo = st["tail_start"][:, None]
    win = (col >= lo) & (col < lo + st["tail_size"][:, None])
    return np.where(win, st["tail_keys"], INF_KEY).ravel()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("schedule", ["spray", "multiq"])
def test_spray_and_multiq_match_each_ranks_single_controller(runs, case,
                                                             schedule):
    ref, ranks = runs[case]
    st, k, v, n = ref[schedule]
    for r, res in enumerate(ranks):
        got = res[schedule]
        _eq_state({f: getattr(st, f)[r] for f in LEAVES}, got["state"],
                  f"{case} rank {r} {schedule}")
        for name, want in (("keys", k), ("vals", v), ("n", n)):
            _eq(want[r], got[name], f"{case} rank {r} {schedule} {name}")
        assert got["counts"] == {}, got["counts"]
    assert sum(int(n[r]) for r in range(N_DEV)) > 0


def test_collectives_of_each_schedule(runs):
    """What each path issues, by (kind, axes), per rank: the HLO claims of
    dist_pq_check.py and multiq_8dev.py, and HIER's only frames across the
    pod axis are the compact (m,) pod-winner runs."""
    all_axes = ("pod", "shard")
    want = {
        "insert": {("all_to_all", all_axes): 2},
        "flat": {("all_gather", all_axes): 2, ("psum", all_axes): 1},
        "hier": {("all_gather", ("shard",)): 2, ("all_gather", ("pod",)): 2,
                 ("psum", all_axes): 2, ("all_gather", all_axes): 1},
        "ffwd": {("ppermute", all_axes): 12, ("psum", all_axes): 2,
                 ("all_gather", all_axes): 1},
        "spray": {}, "multiq": {},
    }
    for _, ranks in runs.values():
        for res in ranks:
            for name, counts in want.items():
                assert res[name]["counts"] == counts, (name,
                                                       res[name]["counts"])


@pytest.mark.parametrize("case", list(CASES))
def test_delegate_dist_verdict_matches_jax(runs, case):
    ref, ranks = runs[case]
    for r, res in enumerate(ranks):
        _eq(ref["nuddle_k"], res["nuddle"]["k"], f"{case} rank {r}")
