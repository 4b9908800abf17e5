"""Parity of the port's int8 KV cache (`Model._q8_kv`, the int8 branch of
`_attn_decode` and `decode_step`, `attend_chunked`'s `k_scale`/`v_scale`,
`build_model(kv_int8=True)`, `make_serve_step(kv_int8=True)`) with the JAX
package's, on the CPU.

Tolerances, measured on the CPU (torch 2.13.0+cpu, jax 0.9.0):
- `_q8_kv`: bit-equal (int8 values and bf16 scales);
- `attend_chunked` with scales, both branches: the layers' 2e-5
  (tests/test_torch_models.py's `LAYER_TOL`; measured 4.8e-7);
- 8 int8 decode steps of reduced llama3.2-3b and granite-moe-1b-a400m
  against the reference's jitted int8 decode, `attend_chunked`'s dense
  and chunked branches: logits within the model tests' bounds (f32 5e-5
  absolute, measured 7.6e-6; bf16 2 ulps for llama3.2-3b, 4 for
  granite-moe, measured 0.5 and 1.0).  In f32 the int8 payloads and
  their scales are bit-equal.  In bf16 the new K/V rows themselves differ
  by bf16 ulps between the packages (XLA and PyTorch round bf16 ops at
  different places, as in the bf16 model tests), and a bf16 ulp of a value
  near its row's largest is about one quantum (amax / 127): 11.3-13.4 % of
  the 8,192 written payload entries differ, by at most 2 quanta, and
  17-25 of the 128 written scales by 1 or 2 bf16 ulps (the K/V's own).
  Bounds: 20 %, 2 quanta, 2 ulps (the model tests' bf16 bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models.io import init_caches as j_init_caches
from repro.models.layers import attention as JA
from repro.models.model import Model as JModel
from repro.models.registry import build_model as j_build_model
from repro.train.steps import make_serve_step as j_make_serve_step
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.io import init_caches
from repro_torch.models.layers import attention as TA
from repro_torch.models.model import Model
from repro_torch.models.registry import build_model
from repro_torch.train.steps import make_serve_step

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULPS = {"llama3.2-3b": 2, "granite-moe-1b-a400m": 4}
B, S, STEPS = 2, 16, 8


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want|."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / ulp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_q8_kv_bit_equal_to_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = _rng(0)
    x = (rng.standard_normal((4, 1, 8, 64))
         * rng.uniform(1e-3, 30.0, (4, 1, 8, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1e-8 / 127
    jq, js = JModel._q8_kv(jnp.asarray(x, jd))
    tq, ts = Model._q8_kv(torch.tensor(x).to(td))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("kv_chunk", [64, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_attend_chunked_with_scales_matches_jax(kv_chunk, causal):
    """int8 K/V with per-(token, head) bf16 scales, dense (one chunk) and
    chunked (4 chunks, each dequantized in the loop), with a validity
    mask as decode gives it."""
    rng = _rng(1)
    Bq, Sq, Skv, Hq, Hkv, hd = 2, 3, 64, 4, 2, 32
    q = rng.standard_normal((Bq, Sq, Hq, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (Bq, Skv, Hkv, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (Bq, Skv, Hkv, hd)).astype(np.int8)
    ks = jnp.asarray(rng.uniform(1e-3, 0.05, (Bq, Skv, Hkv)),
                     jnp.bfloat16)
    vs = jnp.asarray(rng.uniform(1e-3, 0.05, (Bq, Skv, Hkv)),
                     jnp.bfloat16)
    qpos = np.array([[40, 41, 42], [10, 11, 12]], np.int32)
    kpos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (Bq, Skv))
    valid = kpos < np.array([[43], [13]])
    jdims = JA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=hd,
                        causal=causal)
    tdims = TA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=hd,
                        causal=causal)
    want = JA.attend_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jdims, jnp.asarray(qpos), jnp.asarray(kpos),
                             kv_valid=jnp.asarray(valid), kv_chunk=kv_chunk,
                             k_scale=ks, v_scale=vs)
    got = TA.attend_chunked(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), tdims,
        torch.tensor(qpos), torch.tensor(kpos), kv_valid=torch.tensor(valid),
        kv_chunk=kv_chunk, k_scale=torch.tensor(_np(ks)).to(torch.bfloat16),
        v_scale=torch.tensor(_np(vs)).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)


def _j_tree(arch, seed):
    jm = j_build_model(j_reduced_config(arch), remat=False)
    params, _ = jm.init(jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


def _int8_decodes(arch, dtype, kv_chunk, seed=1):
    """8 teacher-forced int8 decode steps of the reference (jitted) and the
    port from the same numpy tree; returns (logits pairs, caches pairs)."""
    jd, td = DTYPES[dtype]
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    tree = _j_tree(arch, seed)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, cfg, device="cpu", dtype=td)
    jm = j_build_model(jcfg, remat=False, compute_dtype=jd, kv_int8=True,
                       kv_chunk=kv_chunk)
    tm = build_model(cfg, compute_dtype=td, kv_int8=True, kv_chunk=kv_chunk,
                     device="cpu")
    jc = j_init_caches(jcfg, B, S, dtype=jd, kv_int8=True)
    tc = init_caches(cfg, B, S, dtype=td, kv_int8=True, device="cpu")
    tok = _rng(seed).integers(0, cfg.vocab, (B, STEPS)).astype(np.int32)
    jdec = jax.jit(jm.decode_step)
    logits = []
    for t in range(STEPS):
        lengths = np.full((B,), t, np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                      jnp.asarray(lengths))
        tl, tc2 = tm.decode_step(tp, tc, torch.tensor(tok[:, t:t + 1]),
                                 torch.tensor(lengths))
        assert tc2 is tc
        logits.append((tl, jl))
    return logits, (tc, jc)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", sorted(BF16_ULPS))
@pytest.mark.parametrize("kv_chunk", [2048, 4])
def test_int8_decode_matches_jax(arch, dtype, kv_chunk):
    """The int8 decode step (dense and moe families) against the
    reference's, through `attend_chunked`'s dense branch (`kv_chunk`
    2048 > the cache's 16 rows) and its chunked one (4)."""
    logits, (tc, jc) = _int8_decodes(arch, dtype, kv_chunk)
    for tl, jl in logits:
        if dtype == "f32":
            np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                       atol=5e-5)
        else:
            assert _bf16_ulps(_np(tl), _np(jl)) <= BF16_ULPS[arch]
    assert sorted(tc) == sorted(jc) == ["k", "k_scale", "v", "v_scale"]
    written = STEPS * B * tc["k"].shape[0] * tc["k"][0, 0, 0].numel()
    for k in ("k", "v"):
        got, want = tc[k].numpy().astype(np.int32), np.asarray(jc[k], np.int32)
        s_got, s_want = _np(tc[k + "_scale"]), _np(jc[k + "_scale"])
        assert tc[k].dtype == torch.int8
        assert tc[k + "_scale"].dtype == torch.bfloat16
        if dtype == "f32":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(s_got, s_want)
            continue
        assert np.abs(got - want).max() <= 2, k
        assert float((got != want).sum()) <= 0.2 * written, k
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(s_want, 1e-30))) - 7)
        assert np.all(np.abs(s_got - s_want) <= 2 * ulp), k


def test_int8_decode_tracks_bf16_like_the_reference():
    """tests/test_kernel_integration.py::test_int8_kv_decode_matches_bf16 on
    the port (the reference's `key(0)` weights): a greedy rollout of 5 steps
    with int8 caches gives the bf16 caches' tokens, and the softmaxes stay
    within 0.05."""
    cfg = reduced_config("llama3.2-3b")
    tree = _j_tree("llama3.2-3b", 0)
    params = params_from_numpy(tree, cfg, device="cpu")
    m_bf = build_model(cfg, remat=False, device="cpu")
    m_i8 = build_model(cfg, remat=False, kv_int8=True, device="cpu")
    Bq, Sq = 2, 64
    c_bf = init_caches(cfg, Bq, Sq, device="cpu")
    c_i8 = init_caches(cfg, Bq, Sq, kv_int8=True, device="cpu")
    lengths = torch.zeros((Bq,), dtype=torch.int32)
    tok = torch.full((Bq, 1), 7, dtype=torch.int32)
    for t in range(5):
        lb, c_bf = m_bf.decode_step(params, c_bf, tok, lengths)
        li, c_i8 = m_i8.decode_step(params, c_i8, tok, lengths)
        lengths = lengths + 1
        nb, ni = lb.argmax(-1), li.argmax(-1)
        assert torch.equal(nb, ni), t
        pb, pi = lb.float().softmax(-1), li.float().softmax(-1)
        assert float((pb - pi).abs().max()) < 0.05, t
        tok = nb[:, None].to(torch.int32)


def test_serve_step_int8_matches_jax():
    """`make_serve_step(kv_int8=True)`: greedy tokens, lengths + 1 and the
    int8 caches over 8 steps, in f32, against the reference's jitted serve
    step from the same tree and first token."""
    arch = "llama3.2-3b"
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    tree = _j_tree(arch, 3)
    jstep, _ = j_make_serve_step(jcfg, None, kv_int8=True,
                                 compute_dtype=jnp.float32)
    tstep, tm = make_serve_step(cfg, None, kv_int8=True,
                                compute_dtype=torch.float32, device="cpu")
    assert tm.kv_int8
    first = _rng(3).integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(first), "lengths": jnp.zeros((B,), jnp.int32),
          "caches": j_init_caches(jcfg, B, S, dtype=jnp.float32,
                                  kv_int8=True)}
    tb = {"tokens": torch.tensor(first),
          "lengths": torch.zeros((B,), dtype=torch.int32),
          "caches": init_caches(cfg, B, S, dtype=torch.float32, kv_int8=True,
                                device="cpu")}
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    jfn = jax.jit(jstep)
    for _ in range(STEPS):
        jb = jfn(jp, jb)
        tb = tstep(tp, tb)
        assert tb["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(tb["lengths"].numpy(),
                                      np.asarray(jb["lengths"]))
    for k in ("k", "v"):
        np.testing.assert_array_equal(tb["caches"][k].numpy(),
                                      np.asarray(jb["caches"][k]))
