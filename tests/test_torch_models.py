"""Parity of the port's model path (`repro_torch.configs`,
`repro_torch.models`, `convert.params_from_numpy`) with the JAX package's,
for the dense, MoE, SSM and hybrid families, on the CPU, and the parameter
trees of every family (the enc-dec and VLM models are
tests/test_torch_encdec_vlm.py's).  The same numpy inputs go through the
reference function and the port's.

Tolerances, each measured on the CPU (torch 2.13.0+cpu, jax 0.9.0) and
set with room above it:
- layers, f32: the reference's own 2e-5 (tests/test_layers.py:42,84);
  measured up to 5e-6;
- models, f32: logits within 5e-5 absolute (measured at most 6.7e-6 on
  logits up to 16), caches within 1e-5 (measured 9.2e-7), and the greedy
  tokens equal;
- models, bf16: within 2 bf16 ulps of the largest reference value (an ulp
  is 2^(floor(log2 max) - 7)); measured at most 1 ulp.  Bit equality is
  not expected: XLA and PyTorch round bf16 elementwise ops (silu, gelu,
  the f32 -> bf16 casts after reductions) at different places;
- the MoE, SSM and hybrid families (reduced granite-moe-1b-a400m,
  mamba2-780m and jamba-1.5-large-398b, experts unpadded as the
  reference's mesh-free `build_model` leaves them): f32 as the dense
  models (measured at most 5.7e-6 on logits, 8.5e-7 on caches), the aux
  loss within 1e-6 relative (measured 1.2e-7).  bf16 within 2 ulps for
  mamba2 (measured 0.125), 4 for granite-moe (measured 2.875) and 10 for
  jamba (measured 9.0 on `train_logits`, 5.25 on the prefill's V cache);
  the bf16 aux loss within 2e-4 relative (measured 1.5e-4).  The MoE
  families' excess is the reference's own: its jitted `train_logits`
  differs from its eager run by the same 2.875 and 9.0 ulps and 1.5e-4
  of aux, at one token (granite-moe) and four (jamba), where its fused
  bf16 norm swaps two near-tied experts.  The port is within 0.5 ulp and
  2.8e-6 of aux of the eager run for granite-moe, and within 4.5 ulps
  (one token's near tie) for jamba.
Configs, cache shapes and parameter trees are compared exactly.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as JB
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import list_configs as j_list_configs
from repro.configs.registry import reduced_config as j_reduced_config
from repro.models.io import _cache_shapes as j_cache_shapes
from repro.models.io import init_caches as j_init_caches
from repro.models.layers import attention as JA
from repro.models.layers import mlp as JM
from repro.models.layers import norm as JN
from repro.models.layers import rope as JR
from repro.models.params import padded_vocab as j_padded_vocab
from repro.models.registry import build_model as j_build_model
import repro_torch.configs.base as TB
from repro_torch.configs.registry import get_config, list_configs, reduced_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import params as TP
from repro_torch.models.io import _cache_shapes, init_caches
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import mlp as TM
from repro_torch.models.layers import norm as TN
from repro_torch.models.layers import rope as TR
from repro_torch.models.registry import build_model

torch.set_num_threads(1)

DENSE = ["llama3.2-3b", "gemma-2b", "granite-8b", "qwen2.5-32b"]
FAMILIES = ["granite-moe-1b-a400m", "mamba2-780m", "jamba-1.5-large-398b"]
ENCDEC_VLM = ["whisper-base", "llama-3.2-vision-11b"]
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(*shape, rng, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# layers, f32 at 2e-5
# ---------------------------------------------------------------------------


def test_norms_match_jax():
    rng = _rng(0)
    x = _f32(2, 8, 64, rng=rng, scale=3.0)
    scale, bias = _f32(64, rng=rng, scale=0.1), _f32(64, rng=rng, scale=0.1)
    _close(TN.rms_norm(_t(x), _t(scale)), JN.rms_norm(x, scale), **LAYER_TOL)
    _close(TN.layer_norm(_t(x), _t(scale), _t(bias)),
           JN.layer_norm(x, scale, bias), **LAYER_TOL)


@pytest.mark.parametrize("theta,max_pos", [(10000.0, 64), (500000.0, 512)])
def test_rope_matches_jax(theta, max_pos):
    rng = _rng(1)
    x = _f32(2, 16, 4, 64, rng=rng)
    pos = rng.integers(0, max_pos, (2, 16)).astype(np.int32)
    _close(TR.rope_freqs(64, theta), JR.rope_freqs(64, theta), rtol=1e-6,
           atol=0)
    _close(TR.apply_rope(_t(x), _t(pos), theta),
           JR.apply_rope(x, pos, theta), **LAYER_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp_matches_jax(act):
    rng = _rng(2)
    x = _f32(2, 8, 64, rng=rng)
    w = [_f32(64, 128, rng=rng, scale=0.1), _f32(64, 128, rng=rng, scale=0.1),
         _f32(128, 64, rng=rng, scale=0.1)]
    _close(TM.gated_mlp(_t(x), *map(_t, w), act=act),
           JM.gated_mlp(x, *w, act=act), **LAYER_TOL)


def test_dense_mlp_matches_jax():
    rng = _rng(3)
    x = _f32(2, 8, 64, rng=rng)
    w = [_f32(64, 128, rng=rng, scale=0.1), _f32(128, rng=rng, scale=0.1),
         _f32(128, 64, rng=rng, scale=0.1), _f32(64, rng=rng, scale=0.1)]
    _close(TM.dense_mlp(_t(x), *map(_t, w)), JM.dense_mlp(x, *w),
           **LAYER_TOL)


def test_project_qkv_with_bias_matches_jax():
    rng = _rng(4)
    dims_j = JA.AttnDims(n_heads=4, n_kv_heads=2, head_dim=32)
    dims_t = TA.AttnDims(n_heads=4, n_kv_heads=2, head_dim=32)
    x = _f32(2, 8, 64, rng=rng)
    w = [_f32(64, 128, rng=rng, scale=0.1), _f32(64, 64, rng=rng, scale=0.1),
         _f32(64, 64, rng=rng, scale=0.1)]
    b = [_f32(128, rng=rng), _f32(64, rng=rng), _f32(64, rng=rng)]
    qpos = np.broadcast_to(np.arange(8, dtype=np.int32) + 5, (2, 8))
    kpos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    for rope in (True, False):
        got = TA.project_qkv(_t(x), *map(_t, w), dims_t, _t(qpos), _t(kpos),
                             bias=tuple(map(_t, b)), rope=rope)
        want = JA.project_qkv(x, *w, dims_j, qpos, kpos, bias=tuple(b),
                              rope=rope)
        for g, j in zip(got, want):
            _close(g, j, **LAYER_TOL)


# (Hq, Hkv): GQA with G = 2, MQA with G = 4
HEADS = [(4, 2), (4, 1)]


def _qkv(Hq, Hkv, B=2, S=64, hd=32, seed=0):
    rng = _rng(seed)
    return (_f32(B, S, Hq, hd, rng=rng), _f32(B, S, Hkv, hd, rng=rng),
            _f32(B, S, Hkv, hd, rng=rng))


@pytest.mark.parametrize("Hq,Hkv", HEADS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_chunk", [64, 16])  # dense; chunked, 4 chunks
@pytest.mark.parametrize("mask", ["kv_valid", "kv_len"])
def test_attend_chunked_matches_jax(Hq, Hkv, causal, kv_chunk, mask):
    """Both branches of `attend_chunked` (Skv <= kv_chunk, and the online
    softmax over 4 chunks), with `kv_valid` masking a ragged tail and one
    row's first chunk whole (its running max starts at NEG_INF).  With the
    mask as a length (`kv_len`: a one-token query at each row's last valid
    position, rows of 50 and 1 positions), the call equals bit for bit the
    same call with the equivalent `kv_valid`, alone or beside it, and the
    reference: on the CPU `kv_len` changes nothing."""
    q, k, v = _qkv(Hq, Hkv)
    B, S = q.shape[:2]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if mask == "kv_len":
        lens = np.array([50, 1], np.int32)
        valid = pos < lens[:, None]
        qpos = (lens - 1)[:, None]
        q1 = q[np.arange(B), qpos[:, 0]][:, None]
        jd = JA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=32,
                         causal=causal)
        td = TA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=32,
                         causal=causal)
        args = (_t(q1), _t(k), _t(v), td, _t(qpos), _t(pos))
        want = TA.attend_chunked(*args, kv_valid=_t(valid),
                                 kv_chunk=kv_chunk)
        for kw in (dict(kv_len=_t(lens)),
                   dict(kv_len=_t(lens), kv_valid=_t(valid))):
            got = TA.attend_chunked(*args, kv_chunk=kv_chunk, **kw)
            assert torch.equal(got, want), kw.keys()
        _close(want, JA.attend_chunked(q1, k, v, jd, qpos, pos,
                                       kv_valid=valid, kv_chunk=kv_chunk),
               **LAYER_TOL)
        return
    valid = np.ones((B, S), bool)
    valid[0, 40:] = False
    valid[1, :16] = False
    valid[1, 50:] = False
    kw = dict(kv_chunk=kv_chunk)
    for kv_valid in (None, valid):
        jd = JA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=32,
                         causal=causal)
        td = TA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=32,
                         causal=causal)
        got = TA.attend_chunked(_t(q), _t(k), _t(v), td, _t(pos), _t(pos),
                                kv_valid=None if kv_valid is None
                                else _t(kv_valid), **kw)
        want = JA.attend_chunked(q, k, v, jd, pos, pos, kv_valid=kv_valid,
                                 **kw)
        _close(got, want, **LAYER_TOL)


def test_attend_dense_query_head_reads_kv_head_h_div_g():
    """Query head h reads KV head h // G: GQA equals MHA with each KV head
    repeated G times in place (`repeat_interleave`), as in the reference
    (tests/test_layers.py::test_gqa_grouping)."""
    q, k, v = _qkv(4, 2, seed=5)
    B, S = q.shape[:2]
    pos = _t(np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    gqa = TA._attend_dense(_t(q), _t(k), _t(v),
                           TA.AttnDims(4, 2, 32), pos, pos)
    mha = TA._attend_dense(_t(q), _t(k).repeat_interleave(2, dim=2),
                           _t(v).repeat_interleave(2, dim=2),
                           TA.AttnDims(4, 4, 32), pos, pos)
    torch.testing.assert_close(gqa, mha, rtol=1e-4, atol=1e-5)


def test_bf16_rounding_order_matches_jax():
    """The bf16 steps the port mirrors bit for bit: the query scaled in
    bf16 by the scale rounded to bf16 (head_dim 128: 128^-0.5 is not a bf16
    number), then cast to f32; and gemma's embedding times sqrt(d_model)
    rounded to bf16 (sqrt(2048) is not one either)."""
    rng = _rng(8)
    q = _f32(2, 3, 8, 128, rng=rng, scale=4.0)
    jq = jnp.asarray(q, jnp.bfloat16)
    tq = _t(q).to(torch.bfloat16)
    want = JA._scale(JA.AttnDims(8, 2, 128))
    got = TA._scaled_f32(tq, TA.AttnDims(8, 2, 128))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray((jq * want).astype(jnp.float32)).reshape(
            got.shape))
    cfg, jcfg = reduced_config("gemma-2b"), j_reduced_config("gemma-2b")
    cfg = dataclasses.replace(cfg, d_model=2048)
    jcfg = dataclasses.replace(jcfg, d_model=2048)
    emb = _f32(64, 2048, rng=rng)
    tok = rng.integers(0, 64, (2, 5)).astype(np.int32)
    jm = j_build_model(jcfg, remat=False)
    tm = build_model(cfg, device="cpu")
    np.testing.assert_array_equal(
        tm._embed({"embed": _t(emb).to(torch.bfloat16)}, _t(tok)).float()
        .numpy(),
        np.asarray(jm._embed({"embed": jnp.asarray(emb)}, jnp.asarray(tok)),
                   np.float32))


@pytest.mark.parametrize("Hq,Hkv", HEADS)
def test_decode_attend_matches_jax(Hq, Hkv):
    rng = _rng(6)
    B, S, hd = 2, 32, 16
    k_hist, v_hist = (_f32(B, S, Hkv, hd, rng=rng) for _ in range(2))
    q_new = _f32(B, 1, Hq, hd, rng=rng)
    k_new, v_new = (_f32(B, 1, Hkv, hd, rng=rng) for _ in range(2))
    jd = JA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
    td = TA.AttnDims(n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
    for length, chunk in ((S - 4, 8), (0, 4096), (S - 1, 4096)):
        out, cache = TA.decode_attend(
            _t(q_new), TA.KVCacheSlice(_t(k_hist), _t(v_hist)), _t(k_new),
            _t(v_new), td, length, kv_chunk=chunk)
        jout, jcache = JA.decode_attend(
            q_new, JA.KVCacheSlice(k_hist, v_hist), k_new, v_new, jd,
            jnp.int32(length), kv_chunk=chunk)
        _close(out, jout, **LAYER_TOL)
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


# ---------------------------------------------------------------------------
# configs, cache shapes, parameter trees
# ---------------------------------------------------------------------------


def test_configs_and_shapes_equal_jax():
    assert list_configs() == j_list_configs()
    for arch in list_configs():
        for ours, theirs in ((get_config(arch), j_get_config(arch)),
                             (reduced_config(arch), j_reduced_config(arch))):
            assert type(ours).__name__ == type(theirs).__name__
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
            assert ours.resolved_head_dim == theirs.resolved_head_dim
            assert ours.param_count() == theirs.param_count()
            assert ours.active_param_count() == theirs.active_param_count()
            for name, shape in TB.SHAPES.items():
                assert (TB.shape_applicable(ours, shape)
                        == JB.shape_applicable(theirs, JB.SHAPES[name]))
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    assert {k: v.step_fn for k, v in TB.SHAPES.items()} == {
        k: v.step_fn for k, v in JB.SHAPES.items()}
    assert get_config("llama3.2-3b").param_count() == 3_212_574_720


@pytest.mark.parametrize("kv_int8", [False, True])
def test_cache_shapes_equal_jax(kv_int8):
    for arch in list_configs():
        for cfg, jcfg in ((get_config(arch), j_get_config(arch)),
                          (reduced_config(arch), j_reduced_config(arch))):
            ours = _cache_shapes(cfg, 8, 512, kv_int8=kv_int8)
            theirs = j_cache_shapes(jcfg, 8, 512, kv_int8=kv_int8)
            assert list(ours) == list(theirs), arch
            for name, (shape, dt) in theirs.items():
                assert ours[name][0] == shape, (arch, name)
                assert str(ours[name][1]).removeprefix("torch.") == \
                    np.dtype(dt).name, (arch, name)


def test_init_caches_zero_on_the_named_device():
    cfg = reduced_config("llama3.2-3b")
    c = init_caches(cfg, 3, 16, device="cpu")
    j = j_init_caches(j_reduced_config("llama3.2-3b"), 3, 16)
    for name in j:
        assert c[name].dtype == torch.bfloat16
        assert tuple(c[name].shape) == j[name].shape
        assert not c[name].any()
    assert init_caches(cfg, 1, 4, dtype=torch.float32,
                       device="cpu")["k"].dtype == torch.float32


def _j_tree(arch, seed=0):
    """The reference's reduced tree as numpy (its mesh-free `build_model`,
    whose experts pad as the port's)."""
    jm = j_build_model(j_reduced_config(arch), remat=False)
    params, _ = jm.init(jax.random.key(seed))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", DENSE + FAMILIES + ENCDEC_VLM)
def test_init_params_tree_and_scales_match_jax(arch):
    """Key paths and shapes equal to the reference's `init_params` tree;
    every drawn leaf's standard deviation within 5 % of its scale, its mean
    near 0; norms and biases zero; the SSD's ``A_log`` and ``D`` within 1
    f32 ulp of the reference's."""
    cfg = reduced_config(arch)
    jtree = _j_tree(arch)
    got = TP.init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    want = dict(TP.leaves(jtree))
    ours = dict(TP.leaves(got))
    assert sorted(ours) == sorted(want)
    layout = dict(TP.leaves(TP.param_layout(cfg)))
    assert list(layout) == list(ours)
    for path, w in ours.items():
        assert tuple(w.shape) == want[path].shape, path
        shape, scale = layout[path]
        if scale is None:
            assert not w.any(), path
            continue
        if isinstance(scale, str):  # "ones", "a_log": no draw; XLA's f32
            # log and PyTorch's may round 1 ulp apart
            np.testing.assert_array_max_ulp(w.numpy(), want[path], maxulp=1)
            continue
        std, mean = float(w.std()), float(w.mean())
        assert abs(std / scale - 1) < 0.05, (path, std, scale)
        assert abs(mean) < 0.05 * scale, (path, mean)
        jstd = float(want[path].std())
        assert abs(jstd / scale - 1) < 0.05, (path, jstd, scale)
    bf = TP.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, w in TP.leaves(bf):
        assert w.dtype == TP.leaf_dtype(path, torch.bfloat16)
        torch.testing.assert_close(w, ours[path].to(w.dtype),
                                   rtol=0, atol=0)
    assert tuple(bf["embed"].shape) == (j_padded_vocab(j_reduced_config(
        arch)), cfg.d_model)


def test_layer_norm_and_gelu_mlp_layouts_match_jax():
    """`_attn_params` with `norm == "layer"` and `qkv_bias`, and the plain
    GELU MLP's layout (the dense family's config space, here a whisper-like
    dense config), key for key and shape for shape."""
    over = dict(family="dense", norm="layer", act="gelu_mlp", qkv_bias=True)
    cfg = dataclasses.replace(reduced_config("whisper-base"), **over)
    jcfg = dataclasses.replace(j_reduced_config("whisper-base"), **over)
    jtree = jax.tree.map(np.asarray, j_build_model(
        jcfg, remat=False).init(jax.random.key(0))[0])
    want = {p: a.shape for p, a in TP.leaves(jtree)}
    got = {p: s for p, (s, _) in TP.leaves(TP.param_layout(cfg))}
    assert got == want


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b"])
def test_full_width_experts_pad_as_the_mesh_free_reference(arch):
    """At full width the port pads its experts as the reference's
    mesh-free `build_model` (its engine's model) pads them: the same
    `moe_dims`, and the tree of its `init` shape for shape
    (`jax.eval_shape`, no arrays made); granite-moe-3b-a800m stores
    3,298,985,472 parameters (its config counts 3,298,693,632, without
    the norm scales and the vocab's padding), its 40 experts unpadded."""
    jm = j_build_model(j_get_config(arch), remat=False)
    cfg = get_config(arch)
    assert (dataclasses.asdict(build_model(cfg, device="cpu").moe_dims)
            == dataclasses.asdict(jm.moe_dims))
    jtree = jax.eval_shape(lambda k: jm.init(k)[0], jax.random.key(0))
    want = {p: tuple(a.shape) for p, a in TP.leaves(jtree)}
    got = {p: s for p, (s, _) in TP.leaves(TP.param_layout(cfg))}
    assert got == want
    if arch == "granite-moe-3b-a800m":
        assert sum(map(math.prod, got.values())) == 3_298_985_472


@pytest.mark.parametrize("arch", DENSE + ["jamba-1.5-large-398b"]
                         + ENCDEC_VLM)
def test_params_numpy_round_trip_is_bit_equal(arch):
    cfg = reduced_config(arch)
    jtree = _j_tree(arch, seed=3)
    f32 = params_from_numpy(jtree, cfg, device="cpu", dtype=torch.float32)
    back = params_to_numpy(f32)
    for path, a in TP.leaves(jtree):
        b = dict(TP.leaves(back))[path]
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, a, err_msg=path)
    bf = params_from_numpy(jtree, cfg, device="cpu")
    for path, w in TP.leaves(bf):
        a = _t(dict(TP.leaves(jtree))[path])
        assert w.dtype == TP.leaf_dtype(path, torch.bfloat16)
        assert torch.equal(w, a.to(w.dtype))
        assert torch.equal(params_from_numpy(
            params_to_numpy(bf), cfg, device="cpu")["embed"], bf["embed"])
    broken = dict(jtree, embed=jtree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(broken, cfg, device="cpu")
    last = list(jtree)[-1]  # "mlp", "dec_mlp" or "cross"
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in jtree.items() if k != last},
                          cfg, device="cpu")


# ---------------------------------------------------------------------------
# the model: train_logits, prefill, decode_step
# ---------------------------------------------------------------------------

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, STEPS = 2, 16, 8


def _bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the largest |want|."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got.detach().float().numpy() - want).max() / ulp)


def _check(got, want, dtype):
    if dtype == "f32":
        _close(got, want, rtol=0, atol=5e-5)
    else:
        assert _bf16_ulps(got, want) <= 2


def _redrawn_tree(arch, seed=1):
    """The reference's reduced init tree (numpy) with its norms, biases
    (the SSD's too; scale 0.1) and the VLM's cross-attention gate (scale
    1) redrawn nonzero from a numpy generator, so that they count: at init the layer norms'
    zero scales zero whisper's logits and the zero gate cuts the image
    off (ROADMAP queue 3).  Returns (tree, the generator)."""
    tree = _j_tree(arch, seed)
    rng = _rng(seed)
    for path, a in list(TP.leaves(tree)):
        name = path.split("/")[-1]
        if name.startswith(("b", "norm", "final_norm")) or name in (
                "conv_b", "dt_bias", "gate"):
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node[p]
            node[leaf] = _f32(*a.shape, rng=rng,
                              scale=1.0 if name == "gate" else 0.1)
    return tree, rng


def _models(arch, dtype, seed=1):
    """The reference model and the port's with the same weights,
    `_redrawn_tree`'s."""
    jd, td = DTYPES[dtype]
    cfg, jcfg = reduced_config(arch), j_reduced_config(arch)
    tree, rng = _redrawn_tree(arch, seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, cfg, device="cpu", dtype=td)
    jm = j_build_model(jcfg, remat=False, compute_dtype=jd)
    tm = build_model(cfg, compute_dtype=td, device="cpu")
    return cfg, jcfg, jm, jparams, tm, tparams, rng


@pytest.mark.parametrize("arch,dtype", [(a, "f32") for a in DENSE]
                         + [("llama3.2-3b", "bf16"), ("gemma-2b", "bf16")])
def test_model_matches_jax(arch, dtype):
    """`train_logits`, `prefill` (logits and caches) and 8 `decode_step`s
    from empty caches.  In f32 each step feeds both models their own greedy
    token, which must agree; in bf16 both take the reference's token
    (teacher forcing), so a near tie cannot fork the streams."""
    cfg, jcfg, jm, jp, tm, tp, rng = _models(arch, dtype)
    jd, td = DTYPES[dtype]
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jl, jaux = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(tok)})
    tl, taux = tm.train_logits(tp, {"tokens": _t(tok)})
    assert tl.dtype == td and tuple(tl.shape) == jl.shape
    assert float(taux) == float(jaux) == 0.0
    _check(tl, jl, dtype)
    jl1, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)})
    tl1, tc = tm.prefill(tp, {"tokens": _t(tok)})
    _check(tl1, jl1, dtype)
    _check(tl1, tl[:, -1].float().numpy(), dtype)  # one row vs S rows
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        if dtype == "f32":
            _close(tc[k], jc[k], rtol=0, atol=1e-5)
        else:
            assert _bf16_ulps(tc[k], jc[k]) <= 2
    jcache = j_init_caches(jcfg, B, S, dtype=jd)
    tcache = init_caches(cfg, B, S, dtype=td, device="cpu")
    jdec = jax.jit(jm.decode_step)
    jt = tt = tok[:, :1]
    for t in range(STEPS):
        lengths = np.full((B,), t, np.int32)
        jlog, jcache = jdec(jp, jcache, jnp.asarray(jt), jnp.asarray(lengths))
        tlog, tcache2 = tm.decode_step(tp, tcache, _t(tt), _t(lengths))
        assert tcache2 is tcache  # written in place
        _check(tlog, jlog, dtype)
        jt = np.asarray(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
        if dtype == "f32":
            tt = tlog.argmax(-1).to(torch.int32)[:, None].numpy()
            np.testing.assert_array_equal(tt, jt)
        else:
            tt = jt
    for k in ("k", "v"):
        if dtype == "f32":
            _close(tcache[k], jcache[k], rtol=0, atol=1e-5)
        else:
            assert _bf16_ulps(tcache[k], jcache[k]) <= 2


# bf16 bounds of the MoE, SSM and hybrid families, in ulps (module
# docstring): the MoE families' are the reference's own jit-against-eager
# difference.
FAMILY_BF16_ULPS = {"granite-moe-1b-a400m": 4, "mamba2-780m": 2,
                    "jamba-1.5-large-398b": 10}


def _family_check(got, want, dtype, arch, atol=5e-5):
    if dtype == "f32":
        _close(got, want, rtol=0, atol=atol)
    else:
        assert _bf16_ulps(got, want) <= FAMILY_BF16_ULPS[arch]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_model_matches_jax(arch, dtype):
    """The MoE, SSM and hybrid families' `train_logits` (with the summed
    aux loss), `prefill` (logits and every cache: K/V, `ssm_h`,
    `ssm_conv`) and 8 `decode_step`s from zero caches, against the
    reference's; in f32 with each model fed its own greedy token, which
    must agree, in bf16 with the reference's.  The SSD families run 64
    tokens (two of the reduced config's 32-token chunks)."""
    cfg, jcfg, jm, jp, tm, tp, rng = _models(arch, dtype)
    jd, td = DTYPES[dtype]
    S_ = 64 if cfg.ssm else S
    tok = rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    jl, jaux = jax.jit(jm.train_logits)(jp, {"tokens": jnp.asarray(tok)})
    tl, taux = tm.train_logits(tp, {"tokens": _t(tok)})
    assert tl.dtype == td and tuple(tl.shape) == jl.shape
    _family_check(tl, jl, dtype, arch)
    if cfg.moe:
        assert float(jaux) > 0
        assert abs(float(taux) - float(jaux)) <= (
            1e-6 if dtype == "f32" else 2e-4) * float(jaux)
    else:
        assert float(taux) == float(jaux) == 0.0
    jl1, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)})
    tl1, tc = tm.prefill(tp, {"tokens": _t(tok)})
    _family_check(tl1, jl1, dtype, arch)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert str(tc[k].dtype).removeprefix("torch.") == \
            np.dtype(jc[k].dtype).name, k
        _family_check(tc[k], jc[k], dtype, arch, atol=1e-5)
    jcache = j_init_caches(jcfg, B, S_, dtype=jd)
    tcache = init_caches(cfg, B, S_, dtype=td, device="cpu")
    jdec = jax.jit(jm.decode_step)
    jt = tt = tok[:, :1]
    for t in range(STEPS):
        lengths = np.full((B,), t, np.int32)
        jlog, jcache = jdec(jp, jcache, jnp.asarray(jt), jnp.asarray(lengths))
        tlog, tcache2 = tm.decode_step(tp, tcache, _t(tt), _t(lengths))
        assert tcache2 is tcache  # written in place
        _family_check(tlog, jlog, dtype, arch)
        jt = np.asarray(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
        if dtype == "f32":
            tt = tlog.argmax(-1).to(torch.int32)[:, None].numpy()
            np.testing.assert_array_equal(tt, jt)
        else:
            tt = jt
    for k in jcache:
        _family_check(tcache[k], jcache[k], dtype, arch, atol=1e-5)


def test_ssm_decode_continues_prefill_like_recompute():
    """tests/test_layers.py:87-111 at the model's level, port alone (f32):
    mamba2's teacher-forced decode steps from zero states give the
    prefill's last logits and its `ssm_h` and `ssm_conv`."""
    cfg = reduced_config("mamba2-780m")
    tm = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(5))
    tok = _t(_rng(7).integers(0, cfg.vocab, (B, 32)).astype(np.int32))
    want, pre = tm.prefill(tp, {"tokens": tok})
    caches = init_caches(cfg, B, 32, dtype=torch.float32, device="cpu")
    for t in range(32):
        got, caches = tm.decode_step(tp, caches, tok[:, t:t + 1],
                                     torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    for k in ("ssm_h", "ssm_conv"):
        torch.testing.assert_close(caches[k], pre[k], rtol=1e-5, atol=1e-5)


def test_decode_continues_prefill_like_recompute():
    """tests/test_layers.py::test_decode_matches_full_recompute at the
    model's level, port alone: teacher-forced decode steps from empty
    caches give the prefill's last logits and its caches (f32)."""
    cfg = reduced_config("llama3.2-3b")
    tm = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(5))
    tok = _t(_rng(7).integers(0, cfg.vocab, (B, S)).astype(np.int32))
    want, pre = tm.prefill(tp, {"tokens": tok})
    caches = init_caches(cfg, B, S, dtype=torch.float32, device="cpu")
    for t in range(S):
        got, caches = tm.decode_step(tp, caches, tok[:, t:t + 1],
                                     torch.full((B,), t, dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    for k in ("k", "v"):
        torch.testing.assert_close(caches[k], pre[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,kv_int8", [("llama3.2-3b", False),
                                          ("llama3.2-3b", True),
                                          ("granite-moe-1b-a400m", False),
                                          ("jamba-1.5-large-398b", False)])
def test_cpu_decode_step_launches_no_kernel(arch, kv_int8):
    """On the CPU a decode step runs the plain arms only: it launches no
    hand-written kernel (`kernels.ops.LAUNCHES` unchanged), though its
    self-attention passes the mask as a length (`kv_len`)."""
    from repro_torch.kernels import ops as KO

    cfg = reduced_config(arch)
    tm = build_model(cfg, kv_int8=kv_int8, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(2))
    caches = init_caches(cfg, 2, 16, kv_int8=kv_int8, device="cpu")
    before = dict(KO.LAUNCHES)
    tok = torch.full((2, 1), 3, dtype=torch.int32)
    for t in range(1, 3):
        logits, caches = tm.decode_step(
            tp, caches, tok, torch.full((2,), t, dtype=torch.int32))
    assert bool(torch.isfinite(logits.float()).all())
    assert KO.LAUNCHES == before


def test_kv_int8_raises_until_its_slice():
    """The int8 KV cache's slice has landed: `build_model(kv_int8=True)`
    builds, and its decode on int8 caches (written in place with their
    bf16 scales) gives the bf16 decode's greedy tokens over a rollout
    (tests/test_kernel_integration.py's check; the parity with the
    reference's int8 decode is tests/test_torch_kv_int8.py's)."""
    cfg = reduced_config("llama3.2-3b")
    m8 = build_model(cfg, kv_int8=True, device="cpu")
    mb = build_model(cfg, device="cpu")
    assert m8.kv_int8 and not mb.kv_int8
    params = mb.init(torch.Generator().manual_seed(0))
    c8 = init_caches(cfg, 2, 16, kv_int8=True, device="cpu")
    cb = init_caches(cfg, 2, 16, device="cpu")
    tok = torch.full((2, 1), 7, dtype=torch.int32)
    for t in range(6):
        lengths = torch.full((2,), t, dtype=torch.int32)
        lb, _ = mb.decode_step(params, cb, tok, lengths)
        li, c8_ = m8.decode_step(params, c8, tok, lengths)
        assert c8_ is c8 and c8["k"].dtype == torch.int8
        assert c8["k_scale"].dtype == torch.bfloat16
        assert bool(c8["k_scale"][:, :, t].gt(0).all())
        assert torch.equal(lb.argmax(-1), li.argmax(-1)), t
        tok = lb.argmax(-1).to(torch.int32)[:, None]
