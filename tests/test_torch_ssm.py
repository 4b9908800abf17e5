"""Parity of the port's Mamba-2 SSD layer (`repro_torch.models.layers.ssm`)
with the JAX package's, on the CPU.  The same numpy inputs go through the
reference function and the port's.

Tolerances, each measured on the CPU (torch 2.13.0+cpu, jax 0.9.0):
- f32: 1e-4 absolute, the reference's own chunked-against-recurrent bar
  (tests/test_layers.py:110); measured at most 3.2e-5 on the output,
  7.2e-6 on the state and 1.4e-6 on the conv tail (`ssd_forward`), and
  2.9e-6, 1.9e-6 and 9.5e-7 after 8 `ssd_decode_step`s;
- bf16: the conv tail bit-equal; the f32 state within 1e-6 of its
  largest value (measured 3.3e-9: the f32 decays' rounding); the output
  within 1 bf16 ulp of its largest value (measured 0: equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import ssm as JS
from repro_torch.models.layers import ssm as TS

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-4)
_j_forward = jax.jit(JS.ssd_forward, static_argnums=2)
_j_decode = jax.jit(JS.ssd_decode_step, static_argnums=3)

# (d_model, d_inner, head_dim P, d_state N, n_groups, chunk, S): the
# reference test's layer (N < P: the inter-chunk output weights C first),
# N == P and N > P (it contracts over N first), the reduced configs'
# layer (N 16, P 64).
DIMS = [(32, 64, 16, 8, 2, 8, 16), (32, 64, 16, 16, 1, 8, 24),
        (32, 64, 16, 32, 2, 8, 16), (64, 256, 64, 16, 2, 16, 32)]
IDS = ["n8p16", "n16p16", "n32p16", "n16p64"]


def _f32(*shape, rng, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a, np.float32)).to(dtype)


def _layer(dm, di, P, N, G, Q, seed=0):
    """Both packages' dims and one parameter set, every leaf nonzero."""
    jd = JS.SSMDims(dm, di, P, N, G, chunk=Q)
    td = TS.SSMDims(dm, di, P, N, G, chunk=Q)
    rng = np.random.default_rng(seed)
    H = jd.n_heads
    p = {"in_proj": _f32(dm, jd.in_proj_out, rng=rng, scale=1.7 / dm**0.5),
         "conv_w": _f32(4, jd.conv_channels, rng=rng, scale=0.3),
         "conv_b": _f32(jd.conv_channels, rng=rng, scale=0.1),
         "A_log": np.log(np.arange(1, H + 1, dtype=np.float32)),
         "dt_bias": _f32(H, rng=rng, scale=0.5),
         "D": 1.0 + _f32(H, rng=rng, scale=0.2),
         "out_proj": _f32(di, dm, rng=rng, scale=2.4 / di**0.5)}
    return jd, td, p, rng


def _err(got, want):
    return float(np.abs(got.float().numpy() - np.asarray(want, np.float32))
                 .max())


def _ulps(got, want):
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.float().numpy() - want).max() / ulp)


def test_dims_match_jax():
    for args in DIMS:
        jd = JS.SSMDims(*args[:5], chunk=args[5])
        td = TS.SSMDims(*args[:5], chunk=args[5])
        assert (td.n_heads, td.conv_channels, td.in_proj_out) == (
            jd.n_heads, jd.conv_channels, jd.in_proj_out)


def test_softplus_is_logaddexp_like_jax():
    """`jax.nn.softplus` is logaddexp(x, 0); `F.softplus` returns x above
    20, which the port does not use."""
    x = np.array([-50.0, -20.0, -1.0, 0.0, 0.5, 19.9, 20.0, 20.5, 30.0,
                  88.0, 100.0], np.float32)
    np.testing.assert_array_equal(TS.softplus(_t(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("args", DIMS, ids=IDS)
def test_ssd_forward_matches_jax(args, with_h0):
    """Two chunks (or three), `h0` given and not, one and two groups: the
    output, the final state and the conv tail within 1e-4 in f32."""
    jd, td, p, rng = _layer(*args[:6])
    S = args[6]
    x = _f32(2, S, args[0], rng=rng)
    h0 = _f32(2, jd.n_heads, jd.d_state, jd.head_dim, rng=rng, scale=0.3)
    jy, jh, jtail = _j_forward(jnp.asarray(x), p, jd,
                                   jnp.asarray(h0) if with_h0 else None)
    ty, th, ttail = TS.ssd_forward(_t(x), {k: _t(v) for k, v in p.items()},
                                   td, _t(h0) if with_h0 else None)
    assert th.dtype == ttail.dtype == torch.float32
    assert tuple(ttail.shape) == (2, 3, jd.conv_channels)
    for got, want in ((ty, jy), (th, jh), (ttail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_forward_refuses_a_partial_chunk():
    _, td, p, rng = _layer(*DIMS[0][:6])
    with pytest.raises(AssertionError):
        TS.ssd_forward(_t(_f32(1, 12, 32, rng=rng)),
                       {k: _t(v) for k, v in p.items()}, td)


@pytest.mark.parametrize("args", DIMS, ids=IDS)
def test_ssd_decode_steps_match_jax(args):
    """8 `ssd_decode_step`s from a nonzero state and conv tail: each step's
    output and the final state and tail within 1e-4 in f32."""
    jd, td, p, rng = _layer(*args[:6], seed=1)
    x = _f32(2, 8, args[0], rng=rng)
    h = _f32(2, jd.n_heads, jd.d_state, jd.head_dim, rng=rng, scale=0.3)
    conv = _f32(2, 3, jd.conv_channels, rng=rng)
    jst = JS.SSMState(h=jnp.asarray(h), conv=jnp.asarray(conv))
    tst = TS.SSMState(h=_t(h), conv=_t(conv))
    tp = {k: _t(v) for k, v in p.items()}
    for s in range(8):
        jy, jst = _j_decode(jnp.asarray(x[:, s:s + 1]), jst, p, jd)
        ty, tst = TS.ssd_decode_step(_t(x[:, s:s + 1]), tst, tp, td)
        assert tuple(ty.shape) == (2, 1, args[0])
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), **TOL)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv), **TOL)


@pytest.mark.parametrize("args", DIMS, ids=IDS)
def test_chunked_equals_recurrent_and_tail_continues(args):
    """tests/test_layers.py:87-133 on the port alone (f32): `ssd_forward`
    equals decode steps from zero states, and the prefill's state and conv
    tail continue into decode steps equal to a longer forward."""
    _, td, p, rng = _layer(*args[:6], seed=2)
    tp = {k: _t(v) for k, v in p.items()}
    S, Q = args[6], args[5]
    x = _t(_f32(2, S + Q, args[0], rng=rng))
    y_full, h_full, _ = TS.ssd_forward(x[:, :S], tp, td)
    st = TS.SSMState(h=torch.zeros(2, td.n_heads, td.d_state, td.head_dim),
                     conv=torch.zeros(2, 3, td.conv_channels))
    ys = []
    for t in range(S):
        y, st = TS.ssd_decode_step(x[:, t:t + 1], st, tp, td)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_full, **TOL)
    torch.testing.assert_close(st.h, h_full, **TOL)
    y_all, _, _ = TS.ssd_forward(x, tp, td)
    _, h_pre, tail = TS.ssd_forward(x[:, :S], tp, td)
    st = TS.SSMState(h=h_pre, conv=tail)
    ys = []
    for t in range(S, S + Q):
        y, st = TS.ssd_decode_step(x[:, t:t + 1], st, tp, td)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, 1), y_all[:, S:], **TOL)


@pytest.mark.parametrize("args", DIMS, ids=IDS)
def test_ssd_bf16_matches_jax(args):
    """In bf16 (the models' compute dtype): the chunk einsums in bf16, in
    XLA's contraction order; the conv tail bit-equal to the reference's,
    the f32 state to f32 rounding, the output within 1 ulp of its largest
    value."""
    jd, td, p, rng = _layer(*args[:6], seed=3)
    x = _f32(2, args[6], args[0], rng=rng, scale=0.5)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: _t(v, torch.bfloat16) for k, v in p.items()}
    jy, jh, jtail = _j_forward(jnp.asarray(x, jnp.bfloat16), jp, jd)
    ty, th, ttail = TS.ssd_forward(_t(x, torch.bfloat16), tp, td)
    assert ty.dtype == torch.bfloat16
    assert _err(th, jh) <= 1e-6 * float(np.abs(np.asarray(jh)).max())
    np.testing.assert_array_equal(ttail.numpy(), np.asarray(jtail))
    assert _ulps(ty, jy) <= 1
