"""Parity of the port's enc-dec and VLM families (`Model._context_kv`,
`_cross_attn`, `_encoder`, `_decoder_full`, `_vlm_stack_full`, their
`train_logits`, `prefill` and `decode_step` branches, and `ServeEngine`
with either model) with the JAX package's, on the CPU, at the reduced
whisper-base (2 encoder and 2 decoder layers) and llama-3.2-vision-11b (10
layers, 2 gated cross-attention layers, 4 query heads over 2 K/V heads).
The same numpy inputs go through the reference function and the port's,
with the weights of `test_torch_models._redrawn_tree`: its norms, biases
and gates redrawn nonzero, since at init whisper's zero layer-norm scales
zero its logits and the VLM's zero gate cuts the image off
(`test_init_traps_match_jax`).

Tolerances, each measured on the CPU (torch 2.13.0+cpu, jax 0.9.0) and
set with room above it:
- layers, f32: the reference's own 2e-5 (tests/test_layers.py:42,84);
  measured at most 2.4e-7;
- models, f32: logits within 5e-5 absolute (measured at most 3.1e-6),
  caches within 1e-5 (measured 9.2e-7), the greedy tokens equal;
- models, bf16: whisper within 2 ulps of the largest reference value
  (measured 1.0); the VLM within 3 (measured 2.125 on the prefill's
  logits).  The VLM's excess is the reference's own: its jitted `prefill`
  differs from its eager run by 2.0 ulps, and the port is within 1.5 of
  the eager run;
- the bf16 GELU bit-equal to `jax.nn.gelu(approximate=True)`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.io as JIO
import repro.models.registry as JMR
from repro.configs.registry import reduced_config as j_reduced_config
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.io import init_caches
from repro_torch.models.layers import mlp as TM
from repro_torch.models.registry import build_model
from test_torch_models import (DTYPES, LAYER_TOL, _bf16_ulps, _close, _f32,
                               _j_tree, _models, _redrawn_tree, _rng, _t)
from test_torch_serve import _model_runs, _same_serving, tree  # noqa: F401

torch.set_num_threads(1)

ARCHS = ["whisper-base", "llama-3.2-vision-11b"]
BF16_ULPS = {"whisper-base": 2, "llama-3.2-vision-11b": 3}
B, S, STEPS = 2, 16, 8
ENC_FRAMES = 24  # the reduced encoder's context (whisper's is 1500)


def _ctx_key(cfg):
    return "enc_embeds" if cfg.family == "encdec" else "image_embeds"


def _batches(cfg, rng, zero_ctx=False):
    """tokens (B, S) and the context (B, frames or image tokens, D) from
    `rng`, for each package."""
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    n = ENC_FRAMES if cfg.family == "encdec" else cfg.n_image_tokens
    ctx = _f32(B, n, cfg.d_model, rng=rng)
    if zero_ctx:
        ctx = np.zeros_like(ctx)
    key = _ctx_key(cfg)
    return ({"tokens": jnp.asarray(tok), key: jnp.asarray(ctx)},
            {"tokens": _t(tok), key: _t(ctx)})


def _check(got, want, dtype, arch, atol=5e-5):
    if dtype == "f32":
        _close(got, want, rtol=0, atol=atol)
    else:
        assert _bf16_ulps(got, want) <= BF16_ULPS[arch]


def _jlayer(stacked, i):
    return jax.tree.map(lambda a: a[i], stacked)


# ---------------------------------------------------------------------------
# GELU, cross-attention, the encoder
# ---------------------------------------------------------------------------


def test_bf16_gelu_is_bit_equal_to_jax():
    """12,288 normal x 3 inputs: `mlp.gelu` in bf16 equals
    `jax.nn.gelu(approximate=True)` bit for bit (`F.gelu` differs at 5,262,
    the per-op form with the f32 constant 0.044715 at 31); in f32 within
    1e-6 absolute (measured 9.5e-7: XLA's f32 tanh reaches -1 sooner, so at
    x = -4.88 the reference gives -0.0 and the port -5.8e-7)."""
    x = (3 * _rng(0).standard_normal(12288)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.jit(functools.partial(
        jax.nn.gelu, approximate=True))(jx).astype(jnp.float32))
    got = TM.gelu(_t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_allclose(
        TM.gelu(_t(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_context_kv_and_cross_attn_match_jax(arch):
    """`_context_kv` and `_cross_attn` of the first cross layer in f32:
    whisper's with its q/k/v biases and layer norm, the VLM's GQA (4 query
    heads over 2 K/V heads) with and without its tanh gate."""
    cfg, jcfg, jm, jp, tm, tp, rng = _models(arch, "f32")
    name = "dec_cross" if cfg.family == "encdec" else "cross"
    ctx = _f32(B, 40, cfg.d_model, rng=rng)
    x = _f32(B, 5, cfg.d_model, rng=rng)
    jc = _jlayer(jp[name], 0)
    tc = tm._layer(tp[name], 0)
    jk, jv = jm._context_kv(jc, jnp.asarray(ctx))
    tk, tv = tm._context_kv(tc, _t(ctx))
    assert tuple(tk.shape) == jk.shape == (B, 40, cfg.n_kv_heads, 64)
    _close(tk, jk, **LAYER_TOL)
    _close(tv, jv, **LAYER_TOL)
    gates = [None] if cfg.family == "encdec" else [None, 0]
    for g in gates:
        jg = None if g is None else jp[name]["gate"][g]
        tg = None if g is None else tp[name]["gate"][g]
        want = jm._cross_attn(jnp.asarray(x), jc, jk, jv, gate=jg)
        got = tm._cross_attn(_t(x), tc, tk, tv, gate=tg)
        _close(got, want, **LAYER_TOL)


def test_encoder_matches_jax():
    """whisper's `_encoder` (non-causal self-attention with biases, layer
    norms, the GELU MLP) over 24 frames, in f32; it does not touch the
    model's causal dims."""
    cfg, jcfg, jm, jp, tm, tp, rng = _models("whisper-base", "f32")
    enc = _f32(B, ENC_FRAMES, cfg.d_model, rng=rng)
    _close(tm._encoder(tp, _t(enc)), jm._encoder(jp, jnp.asarray(enc)),
           **LAYER_TOL)
    assert tm.attn_dims.causal and not tm.noncausal_dims.causal


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_encdec_vlm_model_matches_jax(arch, dtype):
    """`train_logits`, `prefill` (logits and the four caches: self K/V,
    cross `xk`/`xv`) and 8 `decode_step`s from empty self-attention caches
    and the prefill's `xk`/`xv`, against the reference's; in f32 with each
    model fed its own greedy token, which must agree, in bf16 with the
    reference's.  Decode leaves `xk`/`xv` as they are."""
    cfg, jcfg, jm, jp, tm, tp, rng = _models(arch, dtype)
    jd, td = DTYPES[dtype]
    jb, tb = _batches(cfg, rng)
    jl, jaux = jax.jit(jm.train_logits)(jp, jb)
    tl, taux = tm.train_logits(tp, tb)
    assert tl.dtype == td and tuple(tl.shape) == jl.shape
    assert float(taux) == float(jaux) == 0.0
    _check(tl, jl, dtype, arch)
    jl1, jc = jax.jit(jm.prefill)(jp, jb)
    tl1, tc = tm.prefill(tp, tb)
    _check(tl1, jl1, dtype, arch)
    assert sorted(tc) == sorted(jc) == ["k", "v", "xk", "xv"]
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and tc[k].dtype == td, k
        _check(tc[k], jc[k], dtype, arch, atol=1e-5)
    jcache = dict(JIO.init_caches(jcfg, B, S, dtype=jd), xk=jc["xk"],
                  xv=jc["xv"])
    tcache = dict(init_caches(cfg, B, S, dtype=td, device="cpu"),
                  xk=tc["xk"].clone(), xv=tc["xv"].clone())
    jdec = jax.jit(jm.decode_step)
    jt = tt = np.asarray(tb["tokens"][:, :1])
    for t in range(STEPS):
        lengths = np.full((B,), t, np.int32)
        jlog, jcache = jdec(jp, jcache, jnp.asarray(jt), jnp.asarray(lengths))
        tlog, tcache2 = tm.decode_step(tp, tcache, _t(tt), _t(lengths))
        assert tcache2 is tcache  # written in place
        _check(tlog, jlog, dtype, arch)
        jt = np.asarray(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
        if dtype == "f32":
            tt = tlog.argmax(-1).to(torch.int32)[:, None].numpy()
            np.testing.assert_array_equal(tt, jt)
        else:
            tt = jt
    for k in jcache:
        _check(tcache[k], jcache[k], dtype, arch, atol=1e-5)
    assert torch.equal(tcache["xk"], tc["xk"])
    assert torch.equal(tcache["xv"], tc["xv"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill_like_recompute(arch):
    """Port alone, f32: teacher-forced decode steps from empty
    self-attention caches and the prefill's `xk`/`xv` give the prefill's
    last logits and its K/V caches."""
    cfg = reduced_config(arch)
    tm = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tree, rng = _redrawn_tree(arch, seed=5)
    tp = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    _, tb = _batches(cfg, rng)
    want, pre = tm.prefill(tp, tb)
    caches = dict(init_caches(cfg, B, S, dtype=torch.float32, device="cpu"),
                  xk=pre["xk"], xv=pre["xv"])
    tok = tb["tokens"]
    for t in range(S):
        got, caches = tm.decode_step(tp, caches, tok[:, t:t + 1],
                                     torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    for k in ("k", "v"):
        torch.testing.assert_close(caches[k], pre[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_context_moves_the_logits(arch):
    """The cross path is live: `enc_embeds` or `image_embeds` against
    zeros moves `train_logits` (f32) by more than 100 times the f32 logits
    bound and by more than twice the bf16 bound in ulps of the largest
    logit (measured 0.029 and 14.7 ulps for whisper, 0.29 and 9.2 for the
    VLM), so the parity tests of either dtype see a dead cross path; and
    `prefill`.  The reference's zero-context logits equal the port's.""" 
    cfg, jcfg, jm, jp, tm, tp, rng = _models(arch, "f32")
    state = rng.bit_generator.state
    jb, tb = _batches(cfg, rng)
    rng.bit_generator.state = state
    jz, tz = _batches(cfg, rng, zero_ctx=True)
    assert torch.equal(tb["tokens"], tz["tokens"])
    tl, _ = tm.train_logits(tp, tb)
    tl0, _ = tm.train_logits(tp, tz)
    jl0, _ = jax.jit(jm.train_logits)(jp, jz)
    _close(tl0, jl0, rtol=0, atol=5e-5)
    moved = float((tl - tl0).abs().max())
    ulp = 2.0 ** (np.floor(np.log2(float(tl.abs().max()))) - 7)
    assert moved > 100 * 5e-5 and moved > 2 * BF16_ULPS[arch] * ulp
    p1, _ = tm.prefill(tp, tb)
    p0, _ = tm.prefill(tp, tz)
    assert float((p1 - p0).abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_traps_match_jax(arch):
    """At init (norm scales and the gate zero) the port reproduces the
    reference's two traps (ROADMAP queue 3): whisper's logits are all zero
    (each layer norm outputs its zero bias), and the VLM's image moves
    nothing (tanh(0) gates the cross-attention off)."""
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    tree = _j_tree(arch)
    jm = JMR.build_model(jcfg, remat=False, compute_dtype=jnp.float32)
    tm = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    rng = _rng(2)
    state = rng.bit_generator.state
    jb, tb = _batches(cfg, rng)
    rng.bit_generator.state = state
    jz, tz = _batches(cfg, rng, zero_ctx=True)
    jl, _ = jax.jit(jm.train_logits)(jp, jb)
    tl, _ = tm.train_logits(tp, tb)
    tl0, _ = tm.train_logits(tp, tz)
    _close(tl, jl, rtol=0, atol=5e-5)
    if cfg.family == "encdec":
        assert float(np.abs(np.asarray(jl)).max()) == 0.0
        assert float(tl.abs().max()) == 0.0
    else:
        assert float(tl.abs().max()) > 1.0
        assert torch.equal(tl, tl0)


# ---------------------------------------------------------------------------
# ServeEngine with an enc-dec or VLM model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype,K", [
    ("whisper-base", "bf16", 1), ("whisper-base", "f32", 4),
    ("llama-3.2-vision-11b", "bf16", 1), ("llama-3.2-vision-11b", "f32", 4)])
def test_encdec_vlm_engine_matches_jax(tree, arch, dtype, K):
    """`ServeEngine` with a reduced whisper or VLM model (the redrawn
    weights) against the reference engine on the same weights and draws
    (test_torch_serve.py's `_model_runs`): every request completes with
    the same admissions, completion steps, health, token counts and
    carry; in f32 the same tokens, and the self-attention caches within
    1e-5; in bf16 (EOS off) a near tie may pick another token (the VLM's
    uid 8 does), as in test_torch_serve.py's bf16 cases.  `xk`/`xv` stay
    zero in both engines: neither carries audio or an image (ROADMAP
    queue 3)."""
    ecfg = dict(batch_size=4, max_seq=32, sched_window=K)
    if dtype == "bf16":
        ecfg["eos_token"] = -1
    with pytest.MonkeyPatch.context() as mp:
        ref, want, eng, got = _model_runs(tree, _redrawn_tree(arch)[0], mp,
                                          dtype, arch=arch, **ecfg)
    _same_serving(ref, want, eng, got)
    assert got["completed"] == 12
    assert all(len(v) > 0 for v in eng.outputs.values())
    assert sorted(eng.caches) == ["k", "v", "xk", "xv"]
    if dtype == "f32":
        assert eng.outputs == ref.outputs
        for k in ("k", "v"):
            _close(eng.caches[k], ref.caches[k], rtol=0, atol=1e-5)
    for k in ("xk", "xv"):
        assert not eng.caches[k].any() and not np.asarray(ref.caches[k]).any()
