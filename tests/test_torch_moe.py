"""Parity of the port's MoE layer (`repro_torch.models.layers.moe`) with the
JAX package's `moe_block`, on the CPU.  The same numpy inputs go through
the reference function and the port's.

Tolerances, each measured on the CPU (torch 2.13.0+cpu, jax 0.9.0):
- the output in f32 within the reference's own layer tolerance, 2e-5
  (tests/test_layers.py:42; measured at most 3.1e-7);
- the aux loss within 1e-6 relative (measured at most 1.2e-7);
- the routing (the top-k experts, ties included), the kept assignments
  and the dropped count exactly;
- in bf16 bit-equal outputs (measured: equal at every element).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import moe as JM
from repro_torch.models.layers import moe as TM

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
AUX_RTOL = 1e-6
_j_moe = jax.jit(JM.moe_block, static_argnums=5)


def _f32(*shape, rng, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _weights(rng, D, E, F, pad_value=None, n_real=None):
    """Router and expert weights; with `pad_value`, the experts from
    `n_real` on hold that value everywhere."""
    w = [_f32(D, E, rng=rng), _f32(E, D, F, rng=rng, scale=0.1),
         _f32(E, D, F, rng=rng, scale=0.1), _f32(E, F, D, rng=rng, scale=0.1)]
    if pad_value is not None:
        for a in w[1:]:
            a[n_real:] = pad_value
    return w


def _both(x, w, n_experts, n_pad, top_k, cf):
    jd = JM.MoEDims(n_experts, n_pad, top_k, cf)
    td = TM.MoEDims(n_experts, n_pad, top_k, cf)
    jout, jaux = _j_moe(jnp.asarray(x), *map(jnp.asarray, w), jd)
    tout, taux = TM.moe_block(_t(x), *map(_t, w), td)
    return (tout, taux), (np.asarray(jout), float(jaux)), td


def _oracle(sel, n_pad, cap):
    """The reference's k-major positions-in-expert in numpy: (kept mask
    (T, K), position (T, K))."""
    T, K = sel.shape
    filled = np.zeros(n_pad, np.int64)
    pos = np.zeros((T, K), np.int64)
    for k in range(K):
        for t in range(T):
            pos[t, k] = filled[sel[t, k]]
            filled[sel[t, k]] += 1
    return pos < cap, pos


# (name, n_experts, n_pad, top_k, capacity factor, B, S, D, F)
CASES = [
    ("normal", 4, 4, 2, 1.25, 2, 8, 16, 32),
    # tests/test_layers.py:140: capacity 4 of 16 assignments an expert
    ("overflow", 4, 4, 2, 0.25, 2, 8, 16, 32),
    # T*K/E < 1: cap clamps to 1
    ("cap_one", 4, 16, 2, 1.25, 1, 2, 16, 32),
    # granite-moe-3b's routing (40 experts, top 8) at a decode step of 8
    # slots (cap 2) and at 128 tokens (cap 32); and at the decode step on
    # the reference's 16-wide model axis (48 experts, 8 of them pads: cap 1)
    ("granite_decode", 40, 40, 8, 1.25, 8, 1, 32, 16),
    ("granite_128", 40, 40, 8, 1.25, 2, 64, 32, 16),
    ("granite_decode_pad48", 40, 48, 8, 1.25, 8, 1, 32, 16),
]


@pytest.mark.parametrize("name,E,Ep,K,cf,B,S,D,F", CASES,
                         ids=[c[0] for c in CASES])
def test_moe_block_matches_jax(name, E, Ep, K, cf, B, S, D, F):
    """Output within 2e-5 and aux within 1e-6 relative in f32; the routing
    equal to `jax.lax.top_k`'s, the capacity the reference's formula and
    the kept assignments those of the k-major numpy oracle."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = _f32(B, S, D, rng=rng)
    w = _weights(rng, D, Ep, F)
    (tout, taux), (jout, jaux), td = _both(x, w, E, Ep, K, cf)
    np.testing.assert_allclose(tout.numpy(), jout, **LAYER_TOL)
    assert abs(float(taux) - jaux) <= AUX_RTOL * abs(jaux)
    T = B * S
    cap = TM.capacity(T, td)
    assert cap == min(int(max(1, (T * K / Ep) * cf)), T)
    assert cap == {"cap_one": 1, "granite_decode": 2, "granite_128": 32,
                   "granite_decode_pad48": 1}.get(name, cap)
    xt = _t(x).reshape(T, D)
    _, _, sel = TM.route(xt, _t(w[0]), td)
    logits = jnp.where(jnp.arange(Ep) < E,
                       jnp.asarray(x).reshape(T, D) @ jnp.asarray(w[0]),
                       -1e30)
    jsel = np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)[1])
    np.testing.assert_array_equal(sel.numpy(), jsel)
    assert sel.max() < E  # pad experts never chosen
    keep_o, pos_o = _oracle(jsel, Ep, cap)
    slots = TM.dispatch(sel, td, cap)
    for k, (e_safe, p_safe, keep) in enumerate(slots):
        np.testing.assert_array_equal(keep.numpy(), keep_o[:, k])
        np.testing.assert_array_equal(
            e_safe.numpy(), np.where(keep_o[:, k], jsel[:, k], Ep))
        np.testing.assert_array_equal(
            p_safe.numpy(), np.where(keep_o[:, k], pos_o[:, k], 0))
    dropped = sum(int((~keep).sum()) for _, _, keep in slots)
    assert dropped == int((~keep_o).sum())
    if name == "overflow":
        assert dropped > 0
    if name == "granite_decode_pad48":  # 64 assignments, 40 kept at most
        assert dropped >= 64 - 40


def test_pad_experts_never_selected_like_jax():
    """tests/test_layers.py:153: pad experts with 1e6 weights; never
    chosen, so the output stays small, equal to the reference's."""
    rng = np.random.default_rng(1)
    x = _f32(1, 16, 8, rng=rng)
    w = _weights(rng, 8, 4, 16, pad_value=1e6, n_real=3)
    (tout, taux), (jout, jaux), _ = _both(x, w, 3, 4, 3, 4.0)
    assert float(tout.abs().max()) < 1e3
    np.testing.assert_allclose(tout.numpy(), jout, **LAYER_TOL)
    assert abs(float(taux) - jaux) <= AUX_RTOL * abs(jaux)


def test_router_ties_go_to_the_lower_expert_like_jax():
    """Two equal router columns: their experts tie on every token, and
    `jax.lax.top_k`'s lower index wins; the port's stable sort picks the
    same, where `torch.topk` promises no order."""
    rng = np.random.default_rng(2)
    D, E = 16, 4
    x = _f32(1, 12, D, rng=rng)
    w = _weights(rng, D, E, 32)
    w[0][:, 2] = w[0][:, 1] = 3.0 * np.abs(w[0][:, 0]) + 1.0
    x = np.abs(x)  # columns 1 and 2 lead every token
    td = TM.MoEDims(E, E, 1, 4.0)
    probs, _, sel = TM.route(_t(x).reshape(-1, D), _t(w[0]), td)
    assert bool((probs[:, 1] == probs[:, 2]).all())
    assert (sel[:, 0] == 1).all()
    (tout, taux), (jout, jaux), _ = _both(x, w, E, E, 1, 4.0)
    np.testing.assert_allclose(tout.numpy(), jout, **LAYER_TOL)
    assert abs(float(taux) - jaux) <= AUX_RTOL * abs(jaux)
    for K in (2, 3):  # both tied experts kept, in index order
        (tout, _), (jout, _), _ = _both(x, w, E, E, K, 4.0)
        np.testing.assert_allclose(tout.numpy(), jout, **LAYER_TOL)


def test_dropped_slot_gathers_the_last_expert_row_like_jax():
    """A dropped assignment gathers row E - 1 (the reference's clamped
    gather) and weighs it by 0: where that row is not finite, both give
    NaN on the dropped token, not 0."""
    rng = np.random.default_rng(3)
    D, E = 8, 2
    x = _f32(1, 6, D, rng=rng)
    w = _weights(rng, D, E, 16)
    w[0][:] = 0.0
    w[0][:, 1] = 1.0  # every token prefers expert 1
    x = np.abs(x)
    x[0, 0] = 1e30  # token 0 takes expert 1's slot 0; its products overflow
    (tout, _), (jout, _), _ = _both(x, w, E, E, 1, 1.0)
    np.testing.assert_array_equal(np.isnan(tout.numpy()), np.isnan(jout))
    assert np.isnan(jout[0, 3:]).all()  # dropped (cap 3), NaN
    assert np.isfinite(jout[0, 1:3]).all()
    np.testing.assert_allclose(tout.numpy(), jout, **LAYER_TOL)


def test_moe_block_bf16_matches_jax():
    """In bf16 (the engine's dtype) at granite-moe-3b's routing: the
    output equal to the reference's, element for element."""
    rng = np.random.default_rng(4)
    x = _f32(8, 1, 64, rng=rng)
    w = _weights(rng, 64, 48, 32)
    jd = JM.MoEDims(40, 48, 8, 1.25)
    td = TM.MoEDims(40, 48, 8, 1.25)
    jout, jaux = _j_moe(jnp.asarray(x, jnp.bfloat16),
                              *(jnp.asarray(a, jnp.bfloat16) for a in w), jd)
    tout, taux = TM.moe_block(_t(x).to(torch.bfloat16),
                              *(_t(a).to(torch.bfloat16) for a in w), td)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout, np.float32))
    assert abs(float(taux) - float(jaux)) <= AUX_RTOL * abs(float(jaux))


def test_moe_block_reads_nothing_back_from_the_device():
    """No host read in the block (a decode step stays capturable in a CUDA
    graph): no `.item()` or other scalar read-back runs inside it, not even
    a range check (`F.one_hot` reads its input back on the CPU)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class NoReadBack(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            assert "_local_scalar_dense" not in str(func), func
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(5)
    x = _t(_f32(8, 1, 32, rng=rng))
    w = list(map(_t, _weights(rng, 32, 48, 16)))
    with NoReadBack():
        out, aux = TM.moe_block(x, *w, TM.MoEDims(40, 48, 8, 1.25))
    assert out.shape == (8, 1, 32) and aux.shape == ()
