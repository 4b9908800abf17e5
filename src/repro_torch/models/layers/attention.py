"""GQA/MQA attention with RoPE: train, prefill and decode paths.

Counterpart of src/repro/models/layers/attention.py, with the reference's
arithmetic: `q` is scaled in its own dtype and only then cast to f32, the
scores and the softmax are f32, masked entries take `NEG_INF` before the
softmax (or the running max of the chunked branch), and query head h reads
KV head ``h // G`` (the reference's (Hkv, G) reshape of the query heads).
The layer never calls `scaled_dot_product_attention`, whose bf16 numerics
differ from the reference's.

All paths take explicit positions, so the same code serves training (iota),
prefill and decode (the cache length).  An int8 K/V comes with its
per-(token, head) scales (`k_scale`, `v_scale`) and is dequantized as the
reference's is, ``int8.float() * scale.float()``: all of it at once in the
dense branch (then cast to q's dtype), one chunk at a time in the chunked
branch (kept in f32).

A one-token query on the card whose mask is a per-row length
(`attend_chunked`'s `kv_len`) goes to the hand-written kernel
`kernels.ops.decode_attend`, which reads only each row's valid prefix, in
the same arithmetic.  Everything else, and every CPU tensor, runs the
plain code below, which is the kernel's plain arm.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as KO
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 500000.0
    causal: bool = True
    qk_scale: Optional[float] = None

    @property
    def q_out(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_out(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def project_qkv(
    x: torch.Tensor,  # (B, S, D)
    wq: torch.Tensor,  # (D, Hq*hd)
    wk: torch.Tensor,  # (D, Hkv*hd)
    wv: torch.Tensor,  # (D, Hkv*hd)
    dims: AttnDims,
    q_positions: torch.Tensor,  # (B, S)
    kv_positions: torch.Tensor,  # (B, S)
    bias: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    rope: bool = True,
):
    B, S, _ = x.shape
    q = x @ wq
    k = x @ wk
    v = x @ wv
    if bias is not None:
        bq, bk, bv = bias
        q, k, v = q + bq, k + bk, v + bv
    q = q.reshape(B, S, dims.n_heads, dims.head_dim)
    k = k.reshape(B, S, dims.n_kv_heads, dims.head_dim)
    v = v.reshape(B, S, dims.n_kv_heads, dims.head_dim)
    if rope:
        q = apply_rope(q, q_positions, dims.rope_theta)
        k = apply_rope(k, kv_positions, dims.rope_theta)
    return q, k, v


def _scale(dims: AttnDims) -> float:
    if dims.qk_scale is not None:
        return dims.qk_scale
    return dims.head_dim ** -0.5


@functools.lru_cache(maxsize=64)
def _rounded_scale(dims: AttnDims, dtype: torch.dtype) -> float:
    """The scale rounded to q's dtype, as the reference's weakly typed
    scalar is (PyTorch would multiply by the f32 scale).  Cached: a decode
    step asks for it once a layer."""
    return float(torch.tensor(_scale(dims), dtype=dtype))


def _scaled_f32(q: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """``(q * scale)`` in q's dtype, then f32, grouped (B, Sq, Hkv, G, hd),
    the scale rounded first (`_rounded_scale`)."""
    B, Sq, _, hd = q.shape
    s = _rounded_scale(dims, q.dtype)
    return (q * s).float().reshape(B, Sq, dims.n_kv_heads, dims.q_per_kv, hd)


def _mask(dims: AttnDims, q_positions, kv_positions, kv_valid):
    """(B, Sq|1, 1, 1, Skv) bool, or None when nothing is masked."""
    mask = None
    if kv_valid is not None:
        mask = kv_valid[:, None, None, None, :]
    if dims.causal:
        c = kv_positions[:, None, None, None, :] <= q_positions[
            :, :, None, None, None]
        mask = c if mask is None else mask & c
    return mask


def attend_chunked(
    q: torch.Tensor,  # (B, Sq, Hq, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,  # (B, Skv, Hkv, hd)
    dims: AttnDims,
    q_positions: torch.Tensor,  # (B, Sq) absolute positions (causal mask)
    kv_positions: torch.Tensor,  # (B, Skv)
    kv_valid: Optional[torch.Tensor] = None,  # (B, Skv) bool
    kv_chunk: int = 2048,
    k_scale: Optional[torch.Tensor] = None,  # (B, Skv, Hkv): int8 K/V
    v_scale: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,  # (B,) int32
) -> torch.Tensor:
    """Flash-style attention: a loop over KV chunks with running (max,
    sum, acc), the live score block (B, Hq, Sq, kv_chunk).  Exact, not an
    approximation.  Returns (B, Sq, Hq, hd).  With `k_scale`/`v_scale`,
    `k`/`v` are int8 and each chunk is dequantized inside the loop.

    `kv_len` promises that the mask is a per-row length: `kv_valid` is
    ``arange(Skv) < kv_len`` (or None, and then taken to be that),
    `kv_positions` is the iota, and the causal mask drops nothing below
    kv_len.  A one-token query (Sq 1) on CUDA tensors with no int8 scales
    then runs the kernel `kernels.ops.decode_attend`, which reads each
    row's first kv_len positions only; anything it does not take raises.
    On the CPU `kv_len` changes nothing."""
    if (kv_len is not None and q.shape[1] == 1 and k_scale is None
            and v_scale is None and q.is_cuda):
        return KO.decode_attend(q, k, v, kv_len,
                                _rounded_scale(dims, q.dtype))
    B, Sq, Hq, hd = q.shape
    Skv = k.shape[1]
    if kv_len is not None and kv_valid is None:
        kv_valid = torch.arange(Skv, device=q.device) < kv_len[:, None]
    if Skv <= kv_chunk:
        if k_scale is not None:
            k = _dequant(k, k_scale).to(q.dtype)
        if v_scale is not None:
            v = _dequant(v, v_scale).to(q.dtype)
        return _attend_dense(q, k, v, dims, q_positions, kv_positions,
                             kv_valid)

    assert Skv % kv_chunk == 0, (Skv, kv_chunk)
    G = dims.q_per_kv
    qh = _scaled_f32(q, dims)
    if kv_valid is None:
        kv_valid = torch.ones((B, Skv), dtype=torch.bool, device=q.device)
    m_run = torch.full((B, Sq, dims.n_kv_heads, G), NEG_INF,
                       dtype=torch.float32, device=q.device)
    l_run = torch.zeros_like(m_run)
    acc = torch.zeros((B, Sq, dims.n_kv_heads, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Skv, kv_chunk):
        sl = slice(c0, c0 + kv_chunk)
        kc, vc = k[:, sl], v[:, sl]
        if k_scale is not None:
            kc = _dequant(kc, k_scale[:, sl])
        if v_scale is not None:
            vc = _dequant(vc, v_scale[:, sl])
        # scores: (B, Sq, Hkv, G, C)
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, kc.float())
        mask = _mask(dims, q_positions, kv_positions[:, sl], kv_valid[:, sl])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p, vc.float())
        acc = acc * corr[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp_min(l_run[..., None], 1e-30)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def _dequant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 K/V (B, C, Hkv, hd) times its (B, C, Hkv) scales, in f32."""
    return x.float() * scale.float()[..., None]


def _attend_dense(q, k, v, dims: AttnDims, q_positions, kv_positions,
                  kv_valid=None) -> torch.Tensor:
    """Direct-scores path for short KV (one chunk)."""
    B, Sq, Hq, hd = q.shape
    qh = _scaled_f32(q, dims)
    s = torch.einsum("bqkgd,bckd->bqkgc", qh, k.float())
    mask = _mask(dims, q_positions, kv_positions, kv_valid)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


class KVCacheSlice(NamedTuple):
    """One layer's decode cache."""

    k: torch.Tensor  # (B, S_max, Hkv, hd)
    v: torch.Tensor  # (B, S_max, Hkv, hd)


def decode_attend(
    q: torch.Tensor,  # (B, 1, Hq, hd), already roped at position `length`
    cache: KVCacheSlice,
    new_k: torch.Tensor,  # (B, 1, Hkv, hd) roped
    new_v: torch.Tensor,
    dims: AttnDims,
    length,  # () int32: tokens already in the cache
    kv_chunk: int = 4096,
) -> Tuple[torch.Tensor, KVCacheSlice]:
    """One-token decode: append to the cache, attend over the valid prefix.
    Returns a new cache, as the reference's; the write position is clamped
    into the cache, as `dynamic_update_slice` clamps it."""
    B = new_k.shape[0]
    S_max = cache.k.shape[1]
    length = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    at = torch.clamp(length, 0, S_max - 1).long().reshape(1)
    k = cache.k.index_copy(1, at, new_k)
    v = cache.v.index_copy(1, at, new_v)
    pos = torch.arange(S_max, dtype=torch.int32, device=q.device).expand(
        B, S_max)
    valid = pos < (length + 1)
    qpos = length.reshape(1, 1).expand(B, 1)
    kv_len = (length + 1).reshape(1).expand(B).contiguous()
    out = attend_chunked(q, k, v, dims, qpos, pos, kv_valid=valid,
                         kv_chunk=kv_chunk, kv_len=kv_len)
    return out, KVCacheSlice(k, v)
