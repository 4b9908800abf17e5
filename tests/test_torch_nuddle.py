"""Parity of the port's Nuddle delegation engine (`repro_torch.core.nuddle`)
with the JAX package's, on the CPU: the analogues of tests/test_nuddle.py,
held against the reference's outputs.

Both plugins run through `delegate_single_controller` at npods 1, 2, 4 and
8, and `delegate_window` against the reference's `lax.scan` window and
against K sequential calls.  Verdicts and states are bit-equal, on a queue
of distinct-ish keys (tests/test_nuddle.py's) and on one full of
duplicates, where the combine tree's order decides which payloads win.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nuddle as JN
from repro.core.pqueue import ops as JO
from repro.core.pqueue.state import make_state as j_make_state
from repro_torch.core import nuddle as TN
from repro_torch.core.pqueue import ops as TO
from repro_torch.convert import state_from_numpy

torch.set_num_threads(1)

NPODS = [1, 2, 4, 8]
QUEUES = {"test_nuddle": (3, 150, 5000), "duplicates": (5, 200, 40)}


def _filled(queue):
    """tests/test_nuddle.py's 8 x 64 queue (or one with heavy duplicates),
    as the reference's local states and the port's."""
    seed, n, hi = QUEUES[queue]
    rng = np.random.default_rng(seed)
    st, _ = JO.insert(j_make_state(8, 64),
                      jnp.asarray(rng.integers(0, hi, n), jnp.int32),
                      jnp.asarray(rng.integers(0, 99, n), jnp.int32))
    ls = {"keys": st.keys, "vals": st.vals}
    return st, ls, {k: torch.as_tensor(np.array(v)) for k, v in ls.items()}


def _eq(a, b, where=""):
    a, b = np.asarray(a), b.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=where)


def _eq_tree(a, b, where=""):
    for k in a:
        _eq(a[k], b[k], f"{where} {k}")


@pytest.mark.parametrize("queue", list(QUEUES))
@pytest.mark.parametrize("npods", NPODS)
def test_pq_plugin_matches_jax(queue, npods):
    _, jls, tls = _filled(queue)
    jdelegate = jax.jit(lambda s, n: JN.delegate_single_controller(
        JN.pq_tournament_ops(), s, 8, npods, ctx={"n": n}))
    for n in (0, 5, 8):
        js, jv = jdelegate(jls, jnp.int32(n))
        ts, tv = TN.delegate_single_controller(
            TN.pq_tournament_ops(), tls, 8, npods, ctx={"n": n})
        _eq_tree(jv, tv, f"verdict n={n}")
        _eq_tree(js, ts, f"states n={n}")


def test_pq_plugin_matches_peek_and_removes_prefixes():
    st, _, tls = _filled("test_nuddle")
    tst = state_from_numpy({f: np.asarray(getattr(st, f)) for f in (
        "head_keys", "head_vals", "head_seq", "tail_keys", "tail_vals",
        "tail_seq", "head_size", "tail_size", "tail_start", "tail_sorted",
        "next_seq")}, device="cpu")
    new_states, verdict = TN.delegate_single_controller(
        TN.pq_tournament_ops(), tls, 8, npods=2, ctx={"n": 5})
    exp_k, exp_v = TO.peek_min(tst, 8)
    _eq(exp_k.numpy(), verdict["k"])
    _eq(exp_v.numpy(), verdict["v"])
    cutoff = int(verdict["k"][4])
    for s in range(8):
        before = tls["keys"][s].numpy()
        removed = int(np.sum(before < cutoff))
        np.testing.assert_array_equal(
            new_states["keys"][s].numpy()[: 64 - removed], before[removed:])


@pytest.mark.parametrize("npods", NPODS)
def test_sorted_set_plugin_matches_jax(npods):
    st, jls, tls = _filled("test_nuddle")
    present = int(st.keys[0, 0])
    query = np.array([present, 999_999, int(st.keys[5, 3]), -1], np.int32)
    js, jv = JN.delegate_single_controller(
        JN.sorted_set_ops(jnp.asarray(query)), jls, 0, npods)
    ts, tv = TN.delegate_single_controller(
        TN.sorted_set_ops(torch.as_tensor(query)), tls, 0, npods)
    _eq_tree(jv, tv)
    _eq_tree(js, ts)
    assert tv["hit"].tolist() == [True, False, True, False]


@pytest.mark.parametrize("queue", list(QUEUES))
def test_delegate_window_matches_jax_and_k_rounds(queue):
    """K rounds in one window == the reference's scan == K sequential
    calls, bit for bit (states and every round's verdict)."""
    _, jls, tls = _filled(queue)
    ctxs = np.array([5, 3, 8, 1, 0, 8], np.int32)
    jw_states, jw_verdicts = jax.jit(
        lambda s, c: JN.delegate_window(JN.pq_tournament_ops(), s, 8, 2, c)
    )(jls, {"n": jnp.asarray(ctxs)})
    tw_states, tw_verdicts = TN.delegate_window(
        TN.pq_tournament_ops(), tls, 8, 2, {"n": torch.as_tensor(ctxs)})
    _eq_tree(jw_states, tw_states, "window states")
    _eq_tree(jw_verdicts, tw_verdicts, "window verdicts")

    seq = tls
    for t, n in enumerate(ctxs):
        seq, v = TN.delegate_single_controller(
            TN.pq_tournament_ops(), seq, 8, 2, ctx={"n": int(n)})
        for k in v:
            assert torch.equal(tw_verdicts[k][t], v[k]), (t, k)
    for k in seq:
        assert torch.equal(tw_states[k], seq[k]), k


def test_npods_invariance():
    """The two-phase combine gives the same verdict keys for any pod split:
    delegation is associative."""
    _, _, tls = _filled("duplicates")
    verdicts = [TN.delegate_single_controller(
        TN.pq_tournament_ops(), tls, 8, npods, ctx={"n": 8})[1]["k"]
        for npods in NPODS]
    for v in verdicts[1:]:
        assert torch.equal(verdicts[0], v)


def test_refusals_match_jax():
    _, jls, tls = _filled("test_nuddle")
    with pytest.raises(AssertionError):
        JN.delegate_single_controller(JN.pq_tournament_ops(), jls, 8, 3,
                                      ctx={"n": jnp.int32(1)})
    with pytest.raises(ValueError, match="do not split over 3 pods"):
        TN.delegate_single_controller(TN.pq_tournament_ops(), tls, 8, 3,
                                      ctx={"n": 1})
    with pytest.raises(ValueError, match="ctxs or a length"):
        TN.delegate_window(TN.pq_tournament_ops(), tls, 8, 2)
