"""The model: full-sequence forward, prefill and decode for the dense family.

Counterpart of src/repro/models/model.py (`Model._norm`, `_embed`,
`_unembed`, `_attn_full`, `_attn_decode`, `_ffn`, the dense branch of
`_stack_full`, `train_logits`, `prefill` and the dense branch of
`decode_step`), with the reference's signatures and return values.  The
parameters are passed in, as the reference's are: a nested dict of
layer-stacked tensors (`params.init_params`, `convert.params_from_numpy`).
The layer loop is a Python ``for`` over the stacked leaves (``w[l]`` is a
view), in place of `lax.scan`.

Each weight is cast to the compute dtype where the reference casts it
(every layer, every step); stored in that dtype already (`init_params`'
default) the cast is a no-op, which gives the reference's numbers without
an f32 copy on the card.  `decode_step` writes the new K/V rows into the
caches in place (the reference donates them) and returns the same dict;
the caller keeps every length below the cache's depth (the engine ends a
request on `full`), since an index past it raises on the CPU and is a
device-side assert on the card.  The other families raise
`NotImplementedError` naming their ROADMAP item (`params.NOT_PORTED`); so
does the int8 KV cache (`registry.build_model`).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import (AttnDims, attend_chunked,
                                                 project_qkv)
from repro_torch.models.layers.mlp import dense_mlp, gated_mlp
from repro_torch.models.layers.norm import layer_norm, rms_norm
from repro_torch.models.params import init_params, require_ported
from repro_torch.utils.hostsync import resolve_device

Tree = Dict[str, Any]


class _DecodeIndex(NamedTuple):
    """A decode step's cache indices, the same for every layer."""

    rows: torch.Tensor  # (B,) int64
    at: torch.Tensor  # (B,) int64: where each row's new K/V goes
    qpos: torch.Tensor  # (B, 1) int32
    pos: torch.Tensor  # (B, S_max) int32
    valid: torch.Tensor  # (B, S_max) bool: pos < length + 1


class Model(torch.nn.Module):
    """The dense family's forward passes on `device` (the card unless the
    caller names another).  Holds no weights: every entry point takes
    them, as the reference's."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 kv_chunk: int = 2048, device=None):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.kv_chunk = kv_chunk
        self.device = resolve_device(device)
        self.attn_dims = AttnDims(
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
        )

    def init(self, generator: Optional[torch.Generator] = None) -> Tree:
        """Random parameters in the compute dtype on the model's device."""
        return init_params(self.cfg, generator, self.compute_dtype,
                           self.device)

    # -- helpers -------------------------------------------------------------

    def _norm(self, x, scale, bias=None):
        if self.cfg.norm == "layer":
            return layer_norm(x, scale, bias)
        return rms_norm(x, scale)

    def _layer(self, stacked: Tree, i: int) -> Tree:
        """Layer `i`'s leaves (views), floats in the compute dtype."""
        return {k: w[i].to(self.compute_dtype) if w.is_floating_point()
                else w[i] for k, w in stacked.items()}

    # -- sublayers -----------------------------------------------------------

    def _attn_full(self, x, p, q_pos, kv_pos, collect_cache: bool):
        """Self-attention over a full sequence.  Returns (y, (k, v)|None)."""
        h = self._norm(x, p["norm"], p.get("norm_b"))
        bias = (p["bq"], p["bk"], p["bv"]) if "bq" in p else None
        q, k, v = project_qkv(h, p["wq"], p["wk"], p["wv"], self.attn_dims,
                              q_pos, kv_pos, bias)
        out = attend_chunked(q, k, v, self.attn_dims, q_pos, kv_pos,
                             kv_chunk=self.kv_chunk)
        B, S = out.shape[:2]
        y = out.reshape(B, S, -1) @ p["wo"]
        return x + y, ((k, v) if collect_cache else None)

    def _attn_decode(self, x, p, cache_k, cache_v, idx: _DecodeIndex):
        """One-token self-attention against a per-request-length cache;
        the new K/V rows go into `cache_k`/`cache_v` in place."""
        B = x.shape[0]
        h = self._norm(x, p["norm"], p.get("norm_b"))
        bias = (p["bq"], p["bk"], p["bv"]) if "bq" in p else None
        q, k_new, v_new = project_qkv(h, p["wq"], p["wk"], p["wv"],
                                      self.attn_dims, idx.qpos, idx.qpos,
                                      bias)
        cache_k.index_put_((idx.rows, idx.at), k_new[:, 0].to(cache_k.dtype))
        cache_v.index_put_((idx.rows, idx.at), v_new[:, 0].to(cache_v.dtype))
        out = attend_chunked(
            q, cache_k.to(q.dtype), cache_v.to(q.dtype), self.attn_dims,
            idx.qpos, idx.pos, kv_valid=idx.valid, kv_chunk=self.kv_chunk)
        y = out.reshape(B, 1, -1) @ p["wo"]
        return x + y

    def _ffn(self, x, p):
        h = self._norm(x, p["norm"], p.get("norm_b"))
        if self.cfg.act == "gelu_mlp":
            y = dense_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
        else:
            y = gated_mlp(h, p["w_gate"], p["w_up"], p["w_down"],
                          self.cfg.act)
        return x + y

    def _stack_full(self, params, x, positions, collect_cache: bool):
        """Returns (x, caches, aux): caches {"k", "v"} stacked over the
        layers (decode feeds on them), or None."""
        ks, vs = [], []
        for i in range(self.cfg.n_layers):
            x, kv = self._attn_full(x, self._layer(params["attn"], i),
                                    positions, positions, collect_cache)
            x = self._ffn(x, self._layer(params["mlp"], i))
            if collect_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        caches = ({"k": torch.stack(ks), "v": torch.stack(vs)}
                  if collect_cache else None)
        return x, caches, torch.zeros((), device=x.device)

    # -- public entry points -------------------------------------------------

    def _embed(self, params, tokens):
        emb = params["embed"]
        x = emb.index_select(0, tokens.reshape(-1)).reshape(
            *tokens.shape, emb.shape[1]).to(self.compute_dtype)
        if self.cfg.embed_scale:
            # sqrt(d_model) rounded to the compute dtype first, as the
            # reference's jnp.asarray(., compute_dtype)
            x = x * float(torch.tensor(self.cfg.d_model ** 0.5,
                                       dtype=self.compute_dtype))
        return x

    def _unembed(self, params, x):
        x = self._norm(x, params["final_norm"].to(self.compute_dtype),
                       params.get("final_norm_b"))
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(self.compute_dtype).t()
        return x @ params["head"].to(self.compute_dtype)

    def _positions(self, tokens):
        B, S = tokens.shape
        return torch.arange(S, dtype=torch.int32,
                            device=tokens.device).expand(B, S)

    def train_logits(self, params, batch: Tree):
        """batch: tokens (B, S).  Returns (logits (B, S, V_pad), aux): the
        forward pass only (training is ROADMAP queue 1 item 9)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, _, aux = self._stack_full(params, x, self._positions(tokens),
                                     collect_cache=False)
        return self._unembed(params, x), aux

    def prefill(self, params, batch: Tree):
        """Full-context forward collecting decode caches.  Returns
        (last_logits (B, V_pad), caches)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, cache, _ = self._stack_full(params, x, self._positions(tokens),
                                       collect_cache=True)
        logits = self._unembed(params, x[:, -1:, :])[:, 0, :]
        return logits, cache

    def decode_step(self, params, caches: Tree, tokens, lengths):
        """One decode step.  tokens (B, 1), lengths (B,) current cache
        fill.  Writes the step's K/V into `caches` in place and returns
        (logits (B, V_pad), caches)."""
        if "k_scale" in caches:
            raise NotImplementedError(
                "int8 KV caches: ROADMAP queue 1 item 8.4 (kv_int8)")
        x = self._embed(params, tokens)
        B = tokens.shape[0]
        S_max = caches["k"].shape[2]
        pos = torch.arange(S_max, dtype=torch.int32,
                           device=lengths.device).expand(B, S_max)
        idx = _DecodeIndex(
            rows=torch.arange(B, device=lengths.device),
            at=lengths.long(), qpos=lengths[:, None], pos=pos,
            valid=pos < (lengths[:, None] + 1))
        for i in range(self.cfg.n_layers):
            x = self._attn_decode(x, self._layer(params["attn"], i),
                                  caches["k"][i], caches["v"][i], idx)
            x = self._ffn(x, self._layer(params["mlp"], i))
        logits = self._unembed(params, x)[:, 0, :]
        return logits, caches
