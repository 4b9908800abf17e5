"""Parity of the port's mesh collectives and pod-aware collectives
(`repro_torch.distributed`) with the JAX package, on the CPU.

`int8_quantize` and `int8_dequantize` are bit-equal to the reference's
(both round half to even).  The collectives run on 8 gloo ranks, one
process each, over a (pod=2, data=4) mesh (rank code in
tests/torch_dist_ranks.py), and follow tests/device_scripts/
collectives_check.py: the hierarchical psum equals the flat one, the
reduce-scatter + all-gather equals the psum over data, and the compressed
cross-pod psum's error feedback drifts less than 0.02 over 8 steps.  The
reference runs the same functions under nested `jax.vmap` (axis names
"pod" and "data"), which this container runs: float sums agree to rtol
1e-5, atol 1e-6 (collectives_check.py's tolerance; the two packages add
in another order), and a compressed sum to one int8 quantum a pod.  The
mesh's own collectives are held to JAX's result layout, exactly, for axis
tuples in and out of the mesh's order.
"""

import itertools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro_torch.distributed import collectives as TC
from repro_torch.distributed import spawn
from torch_dist_ranks import collectives

STEPS = 8
RTOL, ATOL = 1e-5, 1e-6


def _x():
    return np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)


def _vmapped(fn):
    """fn over a (pod=2, data=4) grid of rows, as nested vmaps."""
    return jax.jit(jax.vmap(jax.vmap(fn, axis_name="data"), axis_name="pod"))


def _reference(x):
    g = jnp.asarray(x.reshape(2, 4, -1))
    flat = _vmapped(lambda v: jax.lax.psum(v, ("pod", "data")))(g)
    hier = _vmapped(lambda v: JC.hierarchical_psum(v, ("data",), "pod"))(g)
    rsag = _vmapped(lambda v: JC.reduce_scatter_then_allgather(v, "data"))(g)
    step = _vmapped(lambda v, e: JC.compressed_cross_pod_psum(
        v, ("data",), "pod", e))
    err, comp = jnp.zeros_like(g), []
    for _ in range(STEPS):
        out, err = step(g, err)
        comp.append(np.asarray(out).reshape(8, -1))
    return {"flat": np.asarray(flat).reshape(8, -1),
            "hier": np.asarray(hier).reshape(8, -1),
            "rsag": np.asarray(rsag).reshape(8, -1),
            "compressed": np.stack(comp, 1)}


@pytest.fixture(scope="module")
def runs():
    x = _x()
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(spawn, collectives, (2, 4), ("pod", "data"),
                         device="cpu", args=(x, STEPS), timeout=300)
        ref = _reference(x)
        return x, ref, port.result()


@pytest.mark.parametrize("case", ["normal", "halves", "zeros", "wide"])
def test_int8_quantize_bitmatches_jax(case):
    rng = np.random.default_rng(1)
    x = {
        "normal": rng.normal(size=(4, 33)),
        # x / scale lands on exact halves: 127 * k / 254 for amax 1
        "halves": np.concatenate([[1.0], np.arange(-254, 255) / 254.0]),
        "zeros": np.zeros(16),
        "wide": rng.normal(size=300) * np.float32(1e30),
    }[case].astype(np.float32)
    jq, js = JC.int8_quantize(jnp.asarray(x))
    tq, ts = TC.int8_quantize(torch.as_tensor(x))
    for a, b in ((jq, tq), (js, ts),
                 (JC.int8_dequantize(jq, js), TC.int8_dequantize(tq, ts))):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_hierarchical_psum_equals_flat(runs):
    x, ref, ranks = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["hier"], res["flat"], RTOL, ATOL)
        np.testing.assert_allclose(res["flat"], ref["flat"][r], RTOL, ATOL)
        np.testing.assert_allclose(res["hier"], ref["hier"][r], RTOL, ATOL)
        np.testing.assert_allclose(res["pmax"], x.max(0), 0, 0)


def test_reduce_scatter_then_allgather_equals_psum_over_data(runs):
    _, ref, ranks = runs
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["rsag"], res["psum_data"], RTOL, ATOL)
        np.testing.assert_allclose(res["rsag"], ref["rsag"][r], RTOL, ATOL)


def test_compressed_cross_pod_psum_error_feedback(runs):
    x, ref, ranks = runs
    exact = np.asarray(ranks[0]["flat"])
    for r, res in enumerate(ranks):
        acc_c = res["compressed"].sum(0)
        acc_e = STEPS * exact
        rel = np.abs(acc_c - acc_e).max() / (np.abs(acc_e).max() + 1e-9)
        assert rel < 0.02, f"rank {r}: error-feedback drift {rel}"
        # one quantum (the shared scale) a pod: the pod sums may differ in
        # their last bit, and a value on a rounding edge moves a quantum
        quantum = (np.abs(x.reshape(2, 4, -1).sum(1)).max() * 1.01) / 127.0
        np.testing.assert_allclose(res["compressed"], ref["compressed"][r],
                                   0, 2 * quantum)
        out, err = res["compressed_1pod"]
        np.testing.assert_allclose(out, exact, RTOL, ATOL)
        assert not err.any()


@pytest.mark.parametrize("axes", [("pod", "data"), ("data", "pod"),
                                  ("data",), ("pod",)])
def test_mesh_collectives_have_jax_layout(runs, axes):
    """Members of an axis tuple are ranked row-major over the tuple in its
    own order (the reference's `_device_rank`, dist.py:79-84)."""
    _, _, ranks = runs
    tag = ",".join(axes)
    shape = {"pod": 2, "data": 4}

    def members(g):
        """Global ranks of g's group, row-major over `axes`."""
        out = []
        for idx in itertools.product(*(range(shape[a]) for a in axes)):
            c = {"pod": g // 4, "data": g % 4, **dict(zip(axes, idx))}
            out.append(c["pod"] * 4 + c["data"])
        return out

    for g, res in enumerate(ranks):
        mem = members(g)
        me = mem.index(g)
        n = len(mem)
        assert res[f"rank:{tag}"] == me
        np.testing.assert_array_equal(res[f"all_gather:{tag}"],
                                      np.array(mem)[:, None])
        np.testing.assert_array_equal(res[f"all_gather_tiled1:{tag}"],
                                      np.tile(np.array(mem), (2, 1)))
        np.testing.assert_array_equal(res[f"all_to_all:{tag}"],
                                      np.array(mem) * 100 + me)
        np.testing.assert_array_equal(res[f"psum_scatter:{tag}"],
                                      [sum(h * 100 + me for h in mem)])
        src = [j for j in range(0, n, 2) if (j + 1) % n == me]
        np.testing.assert_array_equal(res[f"ppermute:{tag}"],
                                      [mem[src[0]] + 1] if src else [0])


def test_collectives_are_counted_by_kind_and_axes(runs):
    _, _, ranks = runs
    counts = ranks[0]["counts"]
    assert counts[("all_to_all", ("data", "pod"))] == 1
    assert counts[("pmax", ("pod",))] == STEPS
    # each step: psum over data, pmax and the int32 psum over pod
    assert counts[("psum", ("pod",))] == 1 + STEPS
    assert all(r["counts"] == counts for r in ranks)
