"""The model: full-sequence forward, prefill and decode for every family.

Counterpart of src/repro/models/model.py (`Model._norm`, `_embed`,
`_unembed`, `_attn_full`, `_attn_decode`, `_cross_attn`, `_context_kv`,
`_ffn`, `_moe_ffn`, `_ssm_layer`, `_stack_full`, `_vlm_stack_full`,
`_hybrid_stack_full`, `_encoder`, `_decoder_full`, `train_logits`,
`prefill`, `decode_step`, `_hybrid_decode`, `_vlm_decode`, `_q8_kv` and
`cross_entropy_loss`), with the reference's signatures and return
values.  The parameters are passed in,
as the reference's are: a nested dict of layer-stacked tensors
(`params.init_params`, `convert.params_from_numpy`).  The layer loop is a
Python ``for`` over the stacked leaves (``w[l]`` is a view), in place of
`lax.scan`; the hybrid family's loops over superblocks and, inside one,
over the period's positions: attention at `hybrid_attn_pos` and SSD
elsewhere, each followed by the MoE FFN on odd positions and the dense
one on even ones.  The VLM's loops over groups of `cross_attn_every`
layers, the gated cross-attention after the self-attention of each
group's last layer.

The context of the enc-dec and VLM families (the encoder's output of
`enc_embeds`, or `image_embeds`) is an argument of the stacks, where the
reference passes the image through a model attribute; cross-attention
reads it unroped and unmasked (`noncausal_dims`, all-zero positions), as
does the encoder's self-attention.  Decode attends to the caches' `xk` and
`xv`, which it leaves as they are.

Each weight is cast to the compute dtype where the reference casts it
(every layer, every step); stored in that dtype already (`init_params`'
default) the cast is a no-op, which gives the reference's numbers without
an f32 copy on the card.  The leaves the reference reads uncast, the ssm
family's decode norm and the VLM's gate, are stored in f32
(`params.F32_LEAVES`).
`decode_step` writes the new K/V rows and the SSD states (`ssm_h`,
`ssm_conv`, f32) into the caches in place (the reference donates them)
and returns the same dict; the caller keeps every length below the
cache's depth (the engine ends a request on `full`), since an index past
it raises on the CPU and is a device-side assert on the card.  The MoE
layer's aux loss is summed over the layers by `train_logits` and dropped
by decode, as in the reference.

The int8 KV cache (`kv_int8`, dense and moe families): each new K/V row
is quantized per (token, head) by `_q8_kv` and written with its bf16 scale
into the caches' ``k_scale``/``v_scale``; attention dequantizes the cache
(`attend_chunked`'s scales).  `remat` recomputes each layer body (a
superblock of the hybrid family, a group of the VLM's) in the backward
pass, as the reference's `jax.checkpoint` around its scan body, so the
forward keeps only each layer's input and not its activations or the
compute-dtype copies of its weights; it takes effect only where autograd
records a parameter, so serving is untouched.  There, too, each stacked
leaf is sliced through one `unbind` (`_slice`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers.attention import (AttnDims, attend_chunked,
                                                 project_qkv)
from repro_torch.models.layers.mlp import dense_mlp, gated_mlp
from repro_torch.models.layers.moe import MoEDims, moe_block
from repro_torch.models.layers.norm import layer_norm, rms_norm
from repro_torch.models.layers.ssm import (SSMState, ssd_decode_step,
                                           ssd_forward)
from repro_torch.models.params import (init_params, leaves, padded_experts,
                                       ssm_dims)
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
    """A config's forward passes on `device` (the card unless the caller
    names another).  Holds no weights: every entry point takes them, as
    the reference's."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 kv_chunk: int = 2048, device=None, remat: bool = True,
                 kv_int8: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.kv_chunk = kv_chunk
        self.remat = remat
        self.kv_int8 = kv_int8
        self._recording = self._recompute = False
        self._unbound: Dict[int, Any] = {}
        self.device = resolve_device(device)
        self.attn_dims = AttnDims(
            n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta,
        )
        # the encoder's self-attention and every cross-attention
        self.noncausal_dims = dataclasses.replace(self.attn_dims,
                                                  causal=False)
        if cfg.ssm:
            self.ssm_dims = ssm_dims(cfg)
        if cfg.moe:
            self.moe_dims = MoEDims(
                n_experts=cfg.moe.n_experts,
                n_experts_pad=padded_experts(cfg),
                top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
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

    def _records(self, params) -> None:
        """Set up a forward: whether autograd records a parameter, and
        with it whether the layer bodies are recomputed (`remat`)."""
        self._recording = torch.is_grad_enabled() and any(
            w.requires_grad for _, w in leaves(params))
        self._recompute = self.remat and self._recording
        self._unbound = {}

    def _remat(self, body, x, *args):
        """`body(x, *args)`, recomputed in the backward pass when the
        forward records (`_records`)."""
        if self._recompute:
            return checkpoint(body, x, *args, use_reentrant=False)
        return body(x, *args)

    def _slice(self, w: torch.Tensor, i: tuple) -> torch.Tensor:
        """``w[i]``.  Where autograd records the forward, a view from one
        `unbind` of the stacked leaf (kept for the forward and its
        recomputation), whose backward stacks the layers' gradients once;
        each ``w[i]`` would add a zero tensor of the whole stack to the
        leaf's gradient, layer after layer."""
        if not (self._recording and w.requires_grad):
            return w[i]
        views = self._unbound.get(id(w))
        if views is None:  # w is kept beside its views, so its id stays
            views = self._unbound[id(w)] = (
                w, [t.unbind(0) for t in w.unbind(0)] if len(i) == 2
                else w.unbind(0))
        out = views[1][i[0]]
        return out[i[1]] if len(i) == 2 else out

    def _layer(self, stacked: Tree, *i: int) -> Tree:
        """Layer `i`'s leaves (views; the hybrid family's two indices,
        superblock and position), floats in the compute dtype."""
        return {k: self._slice(w, i).to(self.compute_dtype)
                if w.is_floating_point() else self._slice(w, i)
                for k, w in stacked.items()}

    # -- sublayers -----------------------------------------------------------

    def _attn_full(self, x, p, q_pos, kv_pos, collect_cache: bool,
                   dims: Optional[AttnDims] = None):
        """Self-attention over a full sequence (causal unless `dims` says
        otherwise).  Returns (y, (k, v)|None)."""
        dims = dims or self.attn_dims
        h = self._norm(x, p["norm"], p.get("norm_b"))
        bias = (p["bq"], p["bk"], p["bv"]) if "bq" in p else None
        q, k, v = project_qkv(h, p["wq"], p["wk"], p["wv"], dims, q_pos,
                              kv_pos, bias)
        out = attend_chunked(q, k, v, dims, q_pos, kv_pos,
                             kv_chunk=self.kv_chunk)
        B, S = out.shape[:2]
        y = out.reshape(B, S, -1) @ p["wo"]
        return x + y, ((k, v) if collect_cache else None)

    @staticmethod
    def _q8_kv(x):
        """(B, 1, H, hd) -> (int8 values, (B, 1, H) bf16 scales): symmetric
        per (token, head), quantized with the f32 scale, which is stored
        rounded to bf16 (`torch.round` rounds half to even, as
        `jnp.round`)."""
        xf = x.float()
        s = (xf.abs().amax(dim=-1) + 1e-8) / 127.0
        q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
        return q.to(torch.int8), s.to(torch.bfloat16)

    def _attn_decode(self, x, p, cache_k, cache_v, idx: _DecodeIndex,
                     scales=None):
        """One-token self-attention against a per-request-length cache;
        the new K/V rows go into `cache_k`/`cache_v` in place.  `scales`:
        the int8 caches' (k_scale, v_scale) (B, S_max, Hkv), written in
        place beside them."""
        B = x.shape[0]
        h = self._norm(x, p["norm"], p.get("norm_b"))
        bias = (p["bq"], p["bk"], p["bv"]) if "bq" in p else None
        q, k_new, v_new = project_qkv(h, p["wq"], p["wk"], p["wv"],
                                      self.attn_dims, idx.qpos, idx.qpos,
                                      bias)
        at = (idx.rows, idx.at)
        if scales is not None:
            ks, vs = scales
            k_q, k_s = self._q8_kv(k_new)
            v_q, v_s = self._q8_kv(v_new)
            cache_k.index_put_(at, k_q[:, 0])
            cache_v.index_put_(at, v_q[:, 0])
            ks.index_put_(at, k_s[:, 0])
            vs.index_put_(at, v_s[:, 0])
            out = attend_chunked(
                q, cache_k, cache_v, self.attn_dims, idx.qpos, idx.pos,
                kv_valid=idx.valid, kv_chunk=self.kv_chunk, k_scale=ks,
                v_scale=vs)
        else:
            cache_k.index_put_(at, k_new[:, 0].to(cache_k.dtype))
            cache_v.index_put_(at, v_new[:, 0].to(cache_v.dtype))
            out = attend_chunked(
                q, cache_k.to(q.dtype), cache_v.to(q.dtype), self.attn_dims,
                idx.qpos, idx.pos, kv_valid=idx.valid,
                kv_chunk=self.kv_chunk)
        y = out.reshape(B, 1, -1) @ p["wo"]
        return x + y

    def _cross_attn(self, x, p, ctx_k, ctx_v, gate=None):
        """Cross-attention to precomputed context K/V (no RoPE, non-causal);
        `gate` (stored f32) scales the output by tanh(gate), rounded to the
        output's dtype first."""
        dims = self.noncausal_dims
        h = self._norm(x, p["norm"], p.get("norm_b"))
        B, S, _ = h.shape
        q = (h @ p["wq"]).reshape(B, S, dims.n_heads, dims.head_dim)
        if "bq" in p:
            q = q + p["bq"].reshape(1, 1, dims.n_heads, dims.head_dim)
        qpos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        kpos = torch.zeros((B, ctx_k.shape[1]), dtype=torch.int32,
                           device=x.device)
        out = attend_chunked(q, ctx_k, ctx_v, dims, qpos, kpos,
                             kv_chunk=self.kv_chunk)
        y = out.reshape(B, S, -1) @ p["wo"]
        if gate is not None:
            y = torch.tanh(gate).to(y.dtype) * y
        return x + y

    def _context_kv(self, p, ctx):
        """Project a context (image or encoder states) into cross K/V."""
        dims = self.attn_dims
        B, S, _ = ctx.shape
        shape = (B, S, dims.n_kv_heads, dims.head_dim)
        k = (ctx @ p["wk"]).reshape(shape)
        v = (ctx @ p["wv"]).reshape(shape)
        if "bk" in p:
            k = k + p["bk"].reshape(1, 1, dims.n_kv_heads, dims.head_dim)
            v = v + p["bv"].reshape(1, 1, dims.n_kv_heads, dims.head_dim)
        return k, v

    def _ffn(self, x, p):
        h = self._norm(x, p["norm"], p.get("norm_b"))
        if self.cfg.act == "gelu_mlp":
            y = dense_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
        else:
            y = gated_mlp(h, p["w_gate"], p["w_up"], p["w_down"],
                          self.cfg.act)
        return x + y

    def _moe_ffn(self, x, p):
        h = self._norm(x, p["norm"])
        y, aux = moe_block(h, p["router"], p["e_gate"], p["e_up"],
                           p["e_down"], self.moe_dims)
        return x + y, aux

    def _ssm_layer(self, x, p, h0=None):
        h = self._norm(x, p["norm"])
        y, h_last, conv_tail = ssd_forward(h, p, self.ssm_dims, h0)
        return x + y, h_last, conv_tail

    def _stack_full(self, params, x, positions, collect_cache: bool,
                    ctx=None):
        """Returns (x, caches, aux): caches the family's per-layer state
        stacked over the layers ({"k", "v"}, {"ssm_h", "ssm_conv"}, both,
        or {"k", "v", "xk", "xv"} with the context's K/V; decode feeds on
        them), or None; aux the MoE layers' summed load-balancing loss (0
        without MoE).  `ctx`: the enc-dec family's encoder output or the
        VLM's image embeddings (`_context`)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return self._hybrid_stack_full(params, x, positions,
                                           collect_cache)
        if cfg.family == "encdec":
            return self._decoder_full(params, x, positions, ctx,
                                      collect_cache)
        if cfg.family == "vlm":
            return self._vlm_stack_full(params, x, positions, ctx,
                                        collect_cache)
        aux = torch.zeros((), device=x.device)
        if cfg.family == "ssm":
            hs, convs = [], []
            for i in range(cfg.n_layers):
                x, h_last, conv_tail = self._remat(
                    lambda x, i: self._ssm_layer(
                        x, self._layer(params["ssm"], i)), x, i)
                hs.append(h_last)
                convs.append(conv_tail)
            caches = ({"ssm_h": torch.stack(hs),
                       "ssm_conv": torch.stack(convs)}
                      if collect_cache else None)
            return x, caches, aux

        def body(x, i):
            x, kv = self._attn_full(x, self._layer(params["attn"], i),
                                    positions, positions, collect_cache)
            if cfg.moe:
                x, a = self._moe_ffn(x, self._layer(params["moe"], i))
                return x, kv, a
            return self._ffn(x, self._layer(params["mlp"], i)), kv, None

        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, kv, a = self._remat(body, x, i)
            if a is not None:
                aux = aux + a
            if collect_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        caches = ({"k": torch.stack(ks), "v": torch.stack(vs)}
                  if collect_cache else None)
        return x, caches, aux

    def _vlm_stack_full(self, params, x, positions, img, collect_cache):
        """Groups of `cross_attn_every` layers (layer ``g * k + i``), the
        gated cross-attention to `img` after the self-attention of each
        group's last layer.  Caches: k/v (ng, k, B, S, Hkv, hd), xk/xv
        (ng, B, n_image_tokens, Hkv, hd)."""
        k = self.cfg.cross_attn_every
        ng = self.cfg.n_layers // k

        def group(x, g):
            gk, gv = [], []
            for i in range(k):
                x, kv = self._attn_full(
                    x, self._layer(params["attn"], g * k + i), positions,
                    positions, collect_cache)
                if i == k - 1:
                    cp = self._layer(params["cross"], g)
                    ck, cv = self._context_kv(cp, img)
                    x = self._cross_attn(x, cp, ck, cv,
                                         gate=params["cross"]["gate"][g])
                x = self._ffn(x, self._layer(params["mlp"], g * k + i))
                if collect_cache:
                    gk.append(kv[0])
                    gv.append(kv[1])
            return x, gk, gv, ck, cv

        ks, vs, xks, xvs = [], [], [], []
        for g in range(ng):
            x, gk, gv, ck, cv = self._remat(group, x, g)
            if collect_cache:
                ks.append(torch.stack(gk))
                vs.append(torch.stack(gv))
                xks.append(ck)
                xvs.append(cv)
        caches = ({"k": torch.stack(ks), "v": torch.stack(vs),
                   "xk": torch.stack(xks), "xv": torch.stack(xvs)}
                  if collect_cache else None)
        return x, caches, torch.zeros((), device=x.device)

    def _encoder(self, params, enc_x):
        """Whisper's encoder: a non-causal self-attention and MLP stack."""
        B, S, _ = enc_x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=enc_x.device).expand(B, S)

        def body(x, i):
            x, _ = self._attn_full(x, self._layer(params["enc_attn"], i),
                                   positions, positions, False,
                                   dims=self.noncausal_dims)
            return self._ffn(x, self._layer(params["enc_mlp"], i))

        x = enc_x
        for i in range(self.cfg.n_encoder_layers):
            x = self._remat(body, x, i)
        return x

    def _decoder_full(self, params, x, positions, enc_out, collect_cache):
        """Each decoder layer: self-attention, cross-attention to
        `enc_out`, MLP.  Caches: k/v and xk/xv (L, B, S|S_enc, Hkv, hd)."""

        def body(x, i):
            x, kv = self._attn_full(x, self._layer(params["dec_attn"], i),
                                    positions, positions, collect_cache)
            cp = self._layer(params["dec_cross"], i)
            ck, cv = self._context_kv(cp, enc_out)
            x = self._cross_attn(x, cp, ck, cv)
            return self._ffn(x, self._layer(params["dec_mlp"], i)), kv, ck, cv

        ks, vs, xks, xvs = [], [], [], []
        for i in range(self.cfg.n_layers):
            x, kv, ck, cv = self._remat(body, x, i)
            if collect_cache:
                ks.append(kv[0])
                vs.append(kv[1])
                xks.append(ck)
                xvs.append(cv)
        caches = ({"k": torch.stack(ks), "v": torch.stack(vs),
                   "xk": torch.stack(xks), "xv": torch.stack(xvs)}
                  if collect_cache else None)
        return x, caches, torch.zeros((), device=x.device)

    def _hybrid_ffn(self, x, params, sb: int, pos: int, slot: dict):
        """The FFN after position `pos` of superblock `sb`: MoE on odd
        positions, dense on even ones (`slot` counts each kind's index in
        the superblock).  Returns (x, aux or None)."""
        if pos % self.cfg.moe.every == 1:
            x, a = self._moe_ffn(x, self._layer(params["moe"], sb,
                                                slot["moe"]))
            slot["moe"] += 1
            return x, a
        x = self._ffn(x, self._layer(params["mlp"], sb, slot["mlp"]))
        slot["mlp"] += 1
        return x, None

    def _hybrid_stack_full(self, params, x, positions, collect_cache):
        cfg = self.cfg

        def superblock(x, sb):
            slot = {"ssm": 0, "moe": 0, "mlp": 0}
            sb_h, sb_conv, sb_aux = [], [], []
            for pos in range(cfg.hybrid_period):
                if pos == cfg.hybrid_attn_pos:
                    x, kv = self._attn_full(
                        x, self._layer(params["attn"], sb), positions,
                        positions, collect_cache)
                else:
                    x, h_last, conv_tail = self._ssm_layer(
                        x, self._layer(params["ssm"], sb, slot["ssm"]))
                    sb_h.append(h_last)
                    sb_conv.append(conv_tail)
                    slot["ssm"] += 1
                x, a = self._hybrid_ffn(x, params, sb, pos, slot)
                if a is not None:
                    sb_aux.append(a)
            return x, kv, sb_h, sb_conv, sb_aux

        aux = torch.zeros((), device=x.device)
        ks, vs, hs, convs = [], [], [], []
        for sb in range(cfg.n_layers // cfg.hybrid_period):
            x, kv, sb_h, sb_conv, sb_aux = self._remat(superblock, x, sb)
            for a in sb_aux:
                aux = aux + a
            if collect_cache:
                ks.append(kv[0])
                vs.append(kv[1])
                hs.append(torch.stack(sb_h))
                convs.append(torch.stack(sb_conv))
        caches = ({"k": torch.stack(ks), "v": torch.stack(vs),
                   "ssm_h": torch.stack(hs), "ssm_conv": torch.stack(convs)}
                  if collect_cache else None)
        return x, caches, aux

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

    def _context(self, params, batch: Tree):
        """The stacks' context: the encoder's output of `enc_embeds`
        (enc-dec), `image_embeds` (VLM), in the compute dtype; else None."""
        fam = self.cfg.family
        if fam == "encdec":
            return self._encoder(
                params, batch["enc_embeds"].to(self.compute_dtype))
        if fam == "vlm":
            return batch["image_embeds"].to(self.compute_dtype)
        return None

    def train_logits(self, params, batch: Tree):
        """batch: tokens (B, S) [+ enc_embeds (B, S_enc, D) | image_embeds
        (B, n_image_tokens, D)].  Returns (logits (B, S, V_pad), aux)."""
        self._records(params)
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, _, aux = self._stack_full(params, x, self._positions(tokens),
                                     False, self._context(params, batch))
        return self._unembed(params, x), aux

    def prefill(self, params, batch: Tree):
        """Full-context forward collecting decode caches (batch as
        `train_logits`').  Returns (last_logits (B, V_pad), caches)."""
        self._records(params)
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, cache, _ = self._stack_full(params, x, self._positions(tokens),
                                       True, self._context(params, batch))
        logits = self._unembed(params, x[:, -1:, :])[:, 0, :]
        return logits, cache

    def _ssm_decode(self, x, norm, p, h, conv):
        """One SSD layer's decode step; the states `h` and `conv` (cache
        views) are written in place."""
        y, st = ssd_decode_step(self._norm(x, norm), SSMState(h=h, conv=conv),
                                p, self.ssm_dims)
        h.copy_(st.h)
        conv.copy_(st.conv)
        return x + y

    def decode_step(self, params, caches: Tree, tokens, lengths):
        """One decode step.  tokens (B, 1), lengths (B,) current cache
        fill.  Writes the step's K/V and SSD states into `caches` in place
        and returns (logits (B, V_pad), caches).  An int8 model
        (`kv_int8`) of the dense or moe family decodes int8 caches (with
        ``k_scale``/``v_scale``) as the reference does."""
        self._records(params)
        cfg = self.cfg
        x = self._embed(params, tokens)
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                # the reference normalizes with the stored (uncast) scale
                x = self._ssm_decode(x, params["ssm"]["norm"][i],
                                     self._layer(params["ssm"], i),
                                     caches["ssm_h"][i],
                                     caches["ssm_conv"][i])
            return self._unembed(params, x)[:, 0, :], caches
        B = tokens.shape[0]
        S_max = caches["k"].shape[-3]  # (..., B, S_max, Hkv, hd)
        pos = torch.arange(S_max, dtype=torch.int32,
                           device=lengths.device).expand(B, S_max)
        idx = _DecodeIndex(
            rows=torch.arange(B, device=lengths.device),
            at=lengths.long(), qpos=lengths[:, None], pos=pos,
            valid=pos < (lengths[:, None] + 1))
        if cfg.family == "hybrid":
            x = self._hybrid_decode(params, caches, x, idx)
            return self._unembed(params, x)[:, 0, :], caches
        if cfg.family == "vlm":
            x = self._vlm_decode(params, caches, x, idx)
            return self._unembed(params, x)[:, 0, :], caches
        if cfg.family == "encdec":
            for i in range(cfg.n_layers):
                x = self._attn_decode(x, self._layer(params["dec_attn"], i),
                                      caches["k"][i], caches["v"][i], idx)
                x = self._cross_attn(x, self._layer(params["dec_cross"], i),
                                     caches["xk"][i].to(x.dtype),
                                     caches["xv"][i].to(x.dtype))
                x = self._ffn(x, self._layer(params["dec_mlp"], i))
            return self._unembed(params, x)[:, 0, :], caches
        int8_kv = self.kv_int8 and "k_scale" in caches
        for i in range(cfg.n_layers):
            x = self._attn_decode(
                x, self._layer(params["attn"], i), caches["k"][i],
                caches["v"][i], idx,
                scales=((caches["k_scale"][i], caches["v_scale"][i])
                        if int8_kv else None))
            if cfg.moe:
                x, _ = self._moe_ffn(x, self._layer(params["moe"], i))
            else:
                x = self._ffn(x, self._layer(params["mlp"], i))
        logits = self._unembed(params, x)[:, 0, :]
        return logits, caches

    def _hybrid_decode(self, params, caches, x, idx: _DecodeIndex):
        cfg = self.cfg
        for sb in range(cfg.n_layers // cfg.hybrid_period):
            slot = {"ssm": 0, "moe": 0, "mlp": 0}
            for pos in range(cfg.hybrid_period):
                if pos == cfg.hybrid_attn_pos:
                    x = self._attn_decode(x, self._layer(params["attn"], sb),
                                          caches["k"][sb], caches["v"][sb],
                                          idx)
                else:
                    si = slot["ssm"]
                    p = self._layer(params["ssm"], sb, si)
                    x = self._ssm_decode(x, p["norm"], p,
                                         caches["ssm_h"][sb, si],
                                         caches["ssm_conv"][sb, si])
                    slot["ssm"] += 1
                x, _ = self._hybrid_ffn(x, params, sb, pos, slot)
        return x

    def _vlm_decode(self, params, caches, x, idx: _DecodeIndex):
        k = self.cfg.cross_attn_every
        for g in range(self.cfg.n_layers // k):
            for i in range(k):
                x = self._attn_decode(
                    x, self._layer(params["attn"], g * k + i),
                    caches["k"][g, i], caches["v"][g, i], idx)
                if i == k - 1:
                    x = self._cross_attn(
                        x, self._layer(params["cross"], g),
                        caches["xk"][g].to(x.dtype),
                        caches["xv"][g].to(x.dtype),
                        gate=params["cross"]["gate"][g])
                x = self._ffn(x, self._layer(params["mlp"], g * k + i))
        return x


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """Mean token cross-entropy over (B, S, V_pad) logits: the pad columns
    take -1e30 in the logits' dtype, the max and the sum of exponentials
    are f32, and the label's logit is gathered in the logits' dtype, then
    widened (the reference's order; not `F.cross_entropy`)."""
    V_pad = logits.shape[-1]
    if V_pad > vocab:
        real = torch.arange(V_pad, device=logits.device) < vocab
        logits = torch.where(real, logits, torch.full(
            (), -1e30, dtype=logits.dtype, device=logits.device))
    lf = logits.float()
    m = torch.amax(lf, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(lf - m[..., None]), dim=-1))
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked.float())
