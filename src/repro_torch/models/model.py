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
it raises on the CPU and is a device-side assert on the card.  Off a
mesh, self-attention's decode passes its mask as a length as well
(`attend_chunked`'s `kv_len`, length + 1), so that on the card it runs the
decode-attention kernel over each row's valid prefix; the int8 cache's
and the sharded decode's do not.  The MoE layer's aux loss is summed over
the layers by `train_logits` and dropped by decode, as in the
reference.

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

On a `Mesh` (`mesh=`, with `rules`, the reference's `Model.mesh` and
`Model.rules`) the model is ZeRO-3 + tensor-parallel, one rank a device.
The parameters are each rank's blocks under `specs` (`params.param_specs`;
storage follows the spec tree exactly), and activations are batch-sharded
over the rules' batch axes (``rules.tokens[0]``) and replicated over
'model' between sublayers.  At use (`_layer`, inside the remat'd body, so
the backward recomputes the gather), each layer's slice is gathered over
its storage axes but 'model' (the ZeRO gather, `collectives.gather`, whose
gradient is psum_scatter'd back over the batch axes).  Over 'model' the
sublayers are Megatron-style: `_w` keeps a weight's model block where the
spec's split lines up with the compute (wq/wk/wv, w_in/w_gate/w_up and the
SSD's out_proj rows by heads or d_ff, wo/w_out/w_down by rows) and gathers
it over 'model' otherwise: the KV projections when the KV heads do not
divide the model axis (gemma-2b's one KV head), the SSD's `in_proj`,
`conv_w` and `conv_b`, whose flat split cuts across the [z, x, B, C, dt]
segments (each rank then keeps its heads' columns), and the MoE router.
A replicated activation enters a split region through `collectives.enter`
and row-parallel partial sums leave through `collectives.leave` (psum over
'model').  The vocabulary is sharded over 'model': the embedding sums the
ranks' lookups, and the logits stay vocab-sharded until `loss` (a sharded
cross-entropy: pmax then psum over 'model') or `greedy` (a gathered
argmax).  Attention with query heads that do not divide the model axis,
and an SSD whose heads do not, run replicated over 'model'.  The MoE FFN
is `moe_block_ep` whenever 'model' is a tensor-parallel axis.  Decode is
sequence-parallel over 'model', as the reference's KV cache layout
(`kv_cache`: the sequence over 'model') implies: each model rank holds a
block of positions for every KV head, the step's q, k and v heads are
gathered over 'model', the new row goes to the rank whose block holds its
position, and the softmax is distributed (pmax of the scores' max, one
psum of the exp-sums and weighted values).  The SSD states follow
`ssm_state` (heads over 'model'); the conv tail is stored flat-split
over 'model' and gathered at use.  On a mesh without a 'pod' axis the
rules lose it (`strip_pod`, as the reference's); rules naming another axis
the mesh lacks, or a mesh axis wider than 1 that no rule uses, raise a
ValueError (`sharding.check_rules`).

Spans (`obs`, the engine's observability bundle; the disabled `NULL` by
default): `decode_step` is a ``model.decode_step`` span (cat ``model``)
holding ``model.embed``, per layer ``model.attn`` (with ``model.attend``
around the attention over the cache) and ``model.ffn``, ``model.moe`` or
``model.ssm``, and ``model.unembed``.  The FFN, MoE and SSD spans are
their layers' own, so the full-sequence passes record them too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import enter, gather, leave, scatter
from repro_torch.distributed.sharding import (P, ShardingRules, check_rules,
                                              entry_axes, fit_rank,
                                              gather_full, strip_pod)
from repro_torch.models.layers.attention import (NEG_INF, AttnDims,
                                                 _dequant, _mask, _scaled_f32,
                                                 attend_chunked, project_qkv)
from repro_torch.models.layers.mlp import dense_mlp, gated_mlp
from repro_torch.models.layers.moe import MoEDims, moe_block, moe_block_ep
from repro_torch.models.layers.norm import layer_norm, rms_norm
from repro_torch.models.layers.ssm import (SSMDims, SSMState,
                                           ssd_decode_step, ssd_forward)
from repro_torch.models.params import (init_params, leaves, padded_experts,
                                       param_specs, ssm_dims)
from repro_torch.obs import NULL, Observability
from repro_torch.utils.hostsync import resolve_device

Tree = Dict[str, Any]


class _DecodeIndex(NamedTuple):
    """A decode step's cache indices, the same for every layer."""

    rows: torch.Tensor  # (B,) int64
    at: torch.Tensor  # (B,) int64: where each row's new K/V goes
    qpos: torch.Tensor  # (B, 1) int32
    pos: torch.Tensor  # (B, S_max) int32
    valid: torch.Tensor  # (B, S_max) bool: pos < length + 1
    kv_len: torch.Tensor  # (B,) int32: length + 1, `valid` as a length


class _Layer(dict):
    """One layer's leaves; on a mesh, `specs` holds their per-layer
    specs."""

    def __init__(self):
        super().__init__()
        self.specs: Dict[str, Any] = {}


class Model(torch.nn.Module):
    """A config's forward passes on `device` (the card unless the caller
    names another).  Holds no weights: every entry point takes them, as
    the reference's."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 kv_chunk: int = 2048, device=None, remat: bool = True,
                 kv_int8: bool = False, mesh=None,
                 rules: Optional[ShardingRules] = None,
                 model_axis_size: Optional[int] = None,
                 obs: Optional[Observability] = None):
        super().__init__()
        self.cfg = cfg
        self.obs = obs if obs is not None else NULL
        self.compute_dtype = compute_dtype
        self.kv_chunk = kv_chunk
        self.remat = remat
        self.kv_int8 = kv_int8
        self._recording = self._recompute = False
        self._unbound: Dict[int, Any] = {}
        self._keys: Dict[int, str] = {}
        self.mesh = mesh
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
            self.rules = check_rules(
                strip_pod(rules or ShardingRules(), mesh), mesh)
            if model_axis_size is None:
                model_axis_size = mesh.shape.get("model", 1)
        else:
            self.device = resolve_device(device)
            self.rules = rules
        self.model_axis_size = max(model_axis_size or 1, 1)
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
                n_experts_pad=padded_experts(cfg, self.model_axis_size),
                top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
            )
        self.specs = None
        # one device: no batch axes, no tensor-parallel axis
        self._bx, self._tp, self._nm, self._r = (), None, 1, 0
        self._attn_tp = self._kv_local = self._ssm_tp = False
        if mesh is not None:
            self.specs = param_specs(cfg, self.rules, self.model_axis_size)
            self._geometry()

    def _geometry(self) -> None:
        """The sharded layout: batch axes, the tensor-parallel axis and how
        attention and the SSD split over it."""
        mesh, cfg = self.mesh, self.cfg
        self._bx = entry_axes(self.rules.tokens[0])
        tp = "model" if ("model" in mesh.shape
                         and "model" not in self._bx) else None
        self._tp = tp
        self._nm = mesh.shape[tp] if tp else 1
        self._r = mesh.device_rank(tp) if tp else 0
        nm, r = self._nm, self._r
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        # attention: local query heads, and the KV heads they read
        self._attn_tp = tp is not None and Hq % nm == 0
        if self._attn_tp:
            hq = Hq // nm
            G = Hq // Hkv
            self._kv_local = Hkv % nm == 0
            need = [(r * hq + j) // G for j in range(hq)]
            if self._kv_local or hq % G == 0 or G % hq == 0:
                kv = sorted(set(need))  # whole GQA groups stay on the rank
            else:
                kv = need  # one KV head per local query head
            self._kv_heads = kv
            self._attn_local = dataclasses.replace(
                self.attn_dims, n_heads=hq, n_kv_heads=len(kv))
        else:
            self._kv_local = False
        # the SSD: local heads and their B/C groups
        self._ssm_tp = False
        if cfg.ssm and tp is not None:
            d = self.ssm_dims
            H, G = d.n_heads, d.n_groups
            if H % nm == 0:
                self._ssm_tp = True
                hl = H // nm
                hpg = H // G
                heads = range(r * hl, (r + 1) * hl)
                if hl % hpg == 0 or hpg % hl == 0:
                    groups = sorted({h // hpg for h in heads})
                else:
                    groups = [h // hpg for h in heads]  # a group a head
                P_, N = d.head_dim, d.d_state
                di, gn = d.d_inner, G * N
                xcols = list(range(r * hl * P_, (r + 1) * hl * P_))
                bcols = [g * N + n for g in groups for n in range(N)]
                self._ssm_local = SSMDims(
                    d_model=d.d_model, d_inner=hl * P_, head_dim=P_,
                    d_state=N, n_groups=len(groups), d_conv=d.d_conv,
                    chunk=d.chunk)
                # columns of in_proj [z, x, B, C, dt] and of the conv
                # channels [x, B, C] this rank computes with
                conv = (xcols + [di + c for c in bcols]
                        + [di + gn + c for c in bcols])
                self._ssm_conv_cols = torch.tensor(conv, device=self.device)
                self._ssm_in_cols = torch.tensor(
                    xcols + [di + c for c in conv]
                    + [di + d.conv_channels + h for h in heads],
                    device=self.device)

    def init(self, generator: Optional[torch.Generator] = None) -> Tree:
        """Random parameters in the compute dtype on the model's device;
        on a mesh, this rank's blocks (every rank draws the same tree)."""
        return init_params(self.cfg, generator, self.compute_dtype,
                           self.device, model_axis=self.model_axis_size,
                           mesh=self.mesh, specs=self.specs)

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
        # the spec subtree of each stacked group, found by the dict's id
        self._keys = {id(v): k for k, v in params.items()
                      if isinstance(v, dict)}

    def _cache_layout_check(self) -> None:
        """The caches' specs put the batch over ('pod', 'data') and the
        sequence over 'model'; rules whose batch rows run over 'model' too
        (`policy.replicated_block_rules`) train, but cannot fill them."""
        if self.mesh is not None and "model" in self._bx:
            raise ValueError("prefill and decode on a mesh whose 'model' "
                             "axis carries batch rows: the caches' spec "
                             "splits the sequence over 'model'")

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
        superblock and position), floats in the compute dtype.  On a mesh,
        each leaf gathered over its storage axes but the tensor-parallel
        one (the ZeRO gather), with its per-layer spec in the result's
        `specs`."""
        key = self._keys.get(id(stacked)) if self.mesh is not None else None
        out = _Layer()
        for k, w in stacked.items():
            x = self._slice(w, i)
            if x.is_floating_point():
                x = x.to(self.compute_dtype)
            if self.mesh is not None:
                spec = fit_rank(self.specs[key][k], w.ndim)[len(i):]
                out.specs[k] = spec
                x = self._storage(x, spec)
            out[k] = x
        return out

    # -- the sharded layout --------------------------------------------------

    def _storage(self, x, spec):
        """`x` gathered over every axis of `spec` but the tensor-parallel
        one: the gradient is psum_scatter'd over the batch axes, whose
        ranks work on different rows, and cut to the block over the
        others."""
        for d, e in enumerate(spec):
            axes = entry_axes(e)
            if self._tp in axes and axes[0] != self._tp:
                raise ValueError(f"spec {spec!r}: the model axis must lead "
                                 f"its entry")
            for a in reversed(axes):
                if a != self._tp:
                    x = gather(x, self.mesh, a, d, split=a in self._bx)
        return x

    def _tp_dim(self, spec):
        for d, e in enumerate(spec):
            if self._tp is not None and self._tp in entry_axes(e):
                return d
        return None

    def _w(self, p, k: str, keep: Optional[int] = None, split: bool = True):
        """Leaf `k` of a layer (`_layer`) in the form the compute takes:
        its model block along dimension `keep`, or whole with `keep`
        None.  `split`: whether the work on a whole weight differs across
        the model ranks (its gradient is then summed over them)."""
        x = p[k]
        if self.mesh is None or self._tp is None:
            return x
        d = self._tp_dim(p.specs[k])
        if d is not None and d == keep:
            return x
        if d is not None:
            x = gather(x, self.mesh, self._tp, d, split=split or
                       keep is not None)
            if keep is not None:
                n = x.shape[keep] // self._nm
                x = x.narrow(keep, self._r * n, n)
            return x
        if keep is not None:
            return scatter(x, self.mesh, self._tp, keep)
        return enter(x, self.mesh, self._tp) if split else x

    def _whole(self, w, spec):
        """`w` gathered over the model axis too, for work that is the same
        on every model rank."""
        d = self._tp_dim(spec)
        if d is None:
            return w
        return gather(w, self.mesh, self._tp, d, split=False)

    def _enter(self, x):
        return enter(x, self.mesh, self._tp) if self._tp else x

    def _leave(self, x):
        return leave(x, self.mesh, self._tp) if self._tp else x

    def _top(self, params, name: str):
        """A top-level leaf (embed, head) in the compute dtype, gathered
        over its storage axes but the model axis, and its spec."""
        w = params[name].to(self.compute_dtype)
        spec = fit_rank(self.specs[name], w.ndim)
        return self._storage(w, spec), spec

    # -- sublayers -----------------------------------------------------------

    def _attn_full(self, x, p, q_pos, kv_pos, collect_cache: bool,
                   dims: Optional[AttnDims] = None):
        """Self-attention over a full sequence (causal unless `dims` says
        otherwise).  Returns (y, (k, v)|None); on a mesh the (k, v) are in
        the cache's layout (`_kv_cache_layout`) and, under tensor-parallel
        attention, this rank's query heads do the work."""
        dims = dims or self.attn_dims
        h = self._norm(x, p["norm"], p.get("norm_b"))
        tp = self._attn_tp
        if tp:
            h = self._enter(h)
        ldims = self._local_dims(dims) if tp else dims
        wq, wk, wv, bias = self._qkv_weights(p)
        q, k, v = project_qkv(h, wq, wk, wv, ldims, q_pos, kv_pos, bias)
        out = attend_chunked(q, k, v, ldims, q_pos, kv_pos,
                             kv_chunk=self.kv_chunk)
        B, S = out.shape[:2]
        y = self._out_proj(p, out.reshape(B, S, -1))
        cache = None
        if collect_cache:
            if tp and not self._kv_local:  # every KV head, for the cache
                _, wk, wv, bias = self._qkv_weights(p, full_kv=True)
                _, k, v = project_qkv(h, wq, wk, wv, dataclasses.replace(
                    ldims, n_kv_heads=self.attn_dims.n_kv_heads), q_pos,
                    kv_pos, bias)
            cache = (self._kv_cache_layout(k, tp and self._kv_local),
                     self._kv_cache_layout(v, tp and self._kv_local))
        return x + y, cache

    def _local_dims(self, dims: AttnDims) -> AttnDims:
        """`dims` with this rank's heads (tensor-parallel attention)."""
        return dataclasses.replace(dims, n_heads=self._attn_local.n_heads,
                                   n_kv_heads=self._attn_local.n_kv_heads)

    def _kv_cols(self, w, full_heads: bool = False):
        """A whole K/V projection (or bias, last dimension Hkv*hd)
        narrowed to the KV heads this rank reads (all of them with
        `full_heads`)."""
        if full_heads:
            return w
        hd = self.attn_dims.head_dim
        if self._kv_heads == list(range(self._kv_heads[0],
                                        self._kv_heads[-1] + 1)):
            return w.narrow(-1, self._kv_heads[0] * hd,
                            len(self._kv_heads) * hd)
        cols = torch.tensor([h * hd + c for h in self._kv_heads
                             for c in range(hd)], device=w.device)
        return w.index_select(-1, cols)

    def _qkv_weights(self, p, full_kv: bool = False):
        """(wq, wk, wv, bias) as the sharded attention computes with them:
        the local query heads' columns and the KV heads they read
        (`full_kv`: every KV head), or everything whole when attention is
        replicated over the model axis."""
        tp = self._attn_tp
        wq = self._w(p, "wq", keep=1 if tp else None, split=tp)
        bq = self._w(p, "bq", keep=0 if tp else None, split=tp) \
            if "bq" in p else None
        kv = {}
        for k in ("wk", "wv", "bk", "bv"):
            if k not in p:
                continue
            if tp and self._kv_local and not full_kv:
                kv[k] = self._w(p, k, keep=p[k].ndim - 1)
            else:
                kv[k] = self._w(p, k, split=tp)
                if tp:
                    kv[k] = self._kv_cols(kv[k], full_kv)
        bias = (bq, kv["bk"], kv["bv"]) if bq is not None else None
        return wq, kv["wk"], kv["wv"], bias

    def _kv_cache_layout(self, k, heads_split: bool):
        """(B, S, Hkv_l|Hkv, hd) K or V -> the cache's layout (the
        sequence over the model axis, every KV head): an all_to_all over
        the model axis from the heads' split, or this rank's block of
        positions of whole heads."""
        if self._nm == 1:
            return k
        nm = self._nm
        B, S = k.shape[:2]
        if S % nm:
            raise ValueError(f"a sequence of {S} does not split {nm} ways "
                             f"over the model axis")
        if not heads_split:
            return k.narrow(1, self._r * (S // nm), S // nm)
        t = self.mesh.all_to_all(k.transpose(0, 1).contiguous(), self._tp)
        t = t.reshape(nm, S // nm, B, *k.shape[2:])  # member, pos, B, h, d
        return t.permute(2, 1, 0, 3, 4).reshape(B, S // nm, -1, k.shape[3])

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
        with self.obs.tracer.span("model.attn", "model"):
            return self._attn_decode_layer(x, p, cache_k, cache_v, idx,
                                           scales)

    def _attn_decode_layer(self, x, p, cache_k, cache_v, idx: _DecodeIndex,
                           scales):
        B = x.shape[0]
        tr = self.obs.tracer
        h = self._norm(x, p["norm"], p.get("norm_b"))
        if self.mesh is not None:
            return self._attn_decode_sharded(x, h, p, cache_k, cache_v, idx,
                                             scales)
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
            with tr.span("model.attend", "model"):
                out = attend_chunked(
                    q, cache_k, cache_v, self.attn_dims, idx.qpos, idx.pos,
                    kv_valid=idx.valid, kv_chunk=self.kv_chunk, k_scale=ks,
                    v_scale=vs)
        else:
            cache_k.index_put_(at, k_new[:, 0].to(cache_k.dtype))
            cache_v.index_put_(at, v_new[:, 0].to(cache_v.dtype))
            k, v = cache_k.to(q.dtype), cache_v.to(q.dtype)
            with tr.span("model.attend", "model"):
                out = attend_chunked(
                    q, k, v, self.attn_dims, idx.qpos, idx.pos,
                    kv_chunk=self.kv_chunk, kv_len=idx.kv_len)
        y = out.reshape(B, 1, -1) @ p["wo"]
        return x + y

    def _heads_all(self, *ts):
        """Each (B, S, h_local, hd) tensor with every rank's heads
        (member-major), in one all_gather over the model axis."""
        if self._nm == 1:
            return list(ts)
        sizes = [t.shape[2] for t in ts]
        g = self.mesh.all_gather(torch.cat(ts, 2), self._tp, axis=2)
        out, at = [], 0
        for n in sizes:
            part = g[:, :, :, at:at + n]
            out.append(part.reshape(*part.shape[:2], -1, part.shape[-1]))
            at += n
        return out

    def _sp_attend(self, q, k, v, dims: AttnDims, q_pos, kv_pos,
                   kv_valid=None, k_scale=None, v_scale=None):
        """Attention of q (B, Sq, Hq, hd), every head, to this rank's block
        of positions of k/v (B, S_l, Hkv, hd), the softmax spread over the
        model axis: the scores' max by pmax, the exp-sums and weighted
        values by one psum.  Returns (B, Sq, Hq, hd) in q's dtype."""
        if k_scale is not None:
            k = _dequant(k, k_scale).to(q.dtype)
        if v_scale is not None:
            v = _dequant(v, v_scale).to(q.dtype)
        B, Sq, Hq, hd = q.shape
        qh = _scaled_f32(q, dims)
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, k.float())
        mask = _mask(dims, q_pos, kv_pos, kv_valid)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m = torch.amax(s, dim=-1)
        if self._nm > 1:
            m = self.mesh.pmax(m, self._tp)
        e = torch.exp(s - m[..., None])
        lo = torch.cat([torch.sum(e, dim=-1)[..., None],
                        torch.einsum("bqkgc,bckd->bqkgd", e, v.float())], -1)
        if self._nm > 1:
            lo = self.mesh.psum(lo, self._tp)
        out = lo[..., 1:] / lo[..., :1]
        return out.reshape(B, Sq, Hq, hd).to(q.dtype)

    def _own_heads(self, out):
        """This rank's query heads of (B, S, Hq, hd), flattened."""
        if self._attn_tp:
            hq = self._attn_local.n_heads
            out = out.narrow(2, self._r * hq, hq)
        return out.reshape(*out.shape[:2], -1)

    def _out_proj(self, p, out):
        """The attention output projection: row-parallel (and summed over
        the model axis) under tensor-parallel attention."""
        tp = self._attn_tp
        y = out @ self._w(p, "wo", keep=0 if tp else None, split=tp)
        return self._leave(y) if tp else y

    def _attn_decode_sharded(self, x, h, p, cache_k, cache_v,
                             idx: _DecodeIndex, scales):
        """Sequence-parallel decode: the step's q, k and v with every head,
        the new K/V row written by the rank whose block of positions holds
        it, and `_sp_attend`."""
        tp = self._attn_tp
        dims = self.attn_dims
        wq, wk, wv, bias = self._qkv_weights(
            p, full_kv=tp and not self._kv_local)
        ldims = dims
        if tp:
            ldims = self._local_dims(dims)
            if not self._kv_local:
                ldims = dataclasses.replace(ldims, n_kv_heads=dims.n_kv_heads)
        q, k_new, v_new = project_qkv(h, wq, wk, wv, ldims, idx.qpos,
                                      idx.qpos, bias)
        if tp:
            if self._kv_local:
                q, k_new, v_new = self._heads_all(q, k_new, v_new)
            else:
                (q,) = self._heads_all(q)
        S_l = cache_k.shape[1]
        loc = idx.at - self._r * S_l
        inb = (loc >= 0) & (loc < S_l)
        at = (idx.rows, loc.clamp(0, S_l - 1))

        def put(cache, new):
            keep = inb.reshape(-1, *([1] * (new.dim() - 1)))
            cache.index_put_(at, torch.where(keep, new.to(cache.dtype),
                                             cache[at]))

        if scales is not None:
            ks, vs = scales
            k_q, k_s = self._q8_kv(k_new)
            v_q, v_s = self._q8_kv(v_new)
            put(cache_k, k_q[:, 0])
            put(cache_v, v_q[:, 0])
            put(ks, k_s[:, 0])
            put(vs, v_s[:, 0])
            with self.obs.tracer.span("model.attend", "model"):
                out = self._sp_attend(q, cache_k, cache_v, dims, idx.qpos,
                                      idx.pos, idx.valid, ks, vs)
        else:
            put(cache_k, k_new[:, 0])
            put(cache_v, v_new[:, 0])
            k, v = cache_k.to(q.dtype), cache_v.to(q.dtype)
            with self.obs.tracer.span("model.attend", "model"):
                out = self._sp_attend(q, k, v, dims, idx.qpos, idx.pos,
                                      idx.valid)
        return x + self._out_proj(p, self._own_heads(out))

    def _cross_attn(self, x, p, ctx_k, ctx_v, gate=None,
                    layout: str = "compute"):
        """Cross-attention to precomputed context K/V (no RoPE, non-causal);
        `gate` (stored f32) scales the output by tanh(gate), rounded to the
        output's dtype first.  On a mesh, `layout` says what the context
        K/V are: "compute" (`_context_kv`'s), "seq" (every head, this
        rank's block of positions: the enc-dec cache) or "full" (every
        head and position: the VLM's cache)."""
        dims = self.noncausal_dims
        h = self._norm(x, p["norm"], p.get("norm_b"))
        B, S, _ = h.shape
        tp = self._attn_tp
        ldims = self._local_dims(dims) if tp else dims
        if tp:
            h = self._enter(h)
        q = (h @ self._w(p, "wq", keep=1 if tp else None, split=tp)
             ).reshape(B, S, ldims.n_heads, dims.head_dim)
        if "bq" in p:
            q = q + self._w(p, "bq", keep=0 if tp else None,
                            split=tp).reshape(1, 1, ldims.n_heads,
                                              dims.head_dim)
        qpos = torch.zeros((B, S), dtype=torch.int32, device=x.device)
        kpos = torch.zeros((B, ctx_k.shape[1]), dtype=torch.int32,
                           device=x.device)
        if layout == "seq" and self.mesh is not None:
            if tp:
                (q,) = self._heads_all(q)
            out = self._sp_attend(q, ctx_k, ctx_v, dims, qpos, kpos)
            y = self._out_proj(p, self._own_heads(out))
        else:
            if layout == "full" and tp:
                sel = torch.tensor(self._kv_heads, device=x.device)
                ctx_k = ctx_k.index_select(2, sel)
                ctx_v = ctx_v.index_select(2, sel)
            out = attend_chunked(q, ctx_k, ctx_v, ldims, qpos, kpos,
                                 kv_chunk=self.kv_chunk)
            y = self._out_proj(p, out.reshape(B, S, -1))
        if gate is not None:
            y = torch.tanh(gate).to(y.dtype) * y
        return x + y

    def _context_kv(self, p, ctx, full_heads: bool = False):
        """Project a context (image or encoder states) into cross K/V.  On
        a mesh, the KV heads this rank's query heads read (`full_heads`:
        every KV head)."""
        dims = self.attn_dims
        B, S, _ = ctx.shape
        tp = self._attn_tp
        if tp:
            ctx = self._enter(ctx)
        if tp and self._kv_local and not full_heads:
            p = {k: self._w(p, k, keep=p[k].ndim - 1)
                 for k in ("wk", "wv", "bk", "bv") if k in p}
        else:
            p = {k: self._w(p, k, split=tp)
                 for k in ("wk", "wv", "bk", "bv") if k in p}
            if tp:
                p = {k: self._kv_cols(t, full_heads) for k, t in p.items()}
        k = ctx @ p["wk"]
        v = ctx @ p["wv"]
        if "bk" in p:
            k = k + p["bk"]
            v = v + p["bv"]
        shape = (B, S, -1, dims.head_dim)
        return k.reshape(shape), v.reshape(shape)

    def _context_cache(self, p, ctx, ck, cv, layout: str):
        """The enc-dec ("seq") or VLM ("full") cache form of the context
        K/V `ck`/`cv` (`_context_kv`'s) on a mesh."""
        if self.mesh is None:
            return ck, cv
        tp = self._attn_tp
        if tp and not self._kv_local:
            ck, cv = self._context_kv(p, ctx, full_heads=True)
        split = tp and self._kv_local
        if layout == "seq":
            return (self._kv_cache_layout(ck, split),
                    self._kv_cache_layout(cv, split))
        if split:
            return tuple(self._heads_all(ck.detach(), cv.detach()))
        return ck, cv

    def _ffn(self, x, p):
        """The MLP; on a mesh column-parallel in and row-parallel out,
        summed over 'model' (the output bias added once, after)."""
        with self.obs.tracer.span("model.ffn", "model"):
            return self._ffn_layer(x, p)

    def _ffn_layer(self, x, p):
        h = self._norm(x, p["norm"], p.get("norm_b"))
        tp = self._tp is not None
        col, row = (1, 0) if tp else (None, None)
        h = self._enter(h)
        if self.cfg.act == "gelu_mlp":
            y = dense_mlp(h, self._w(p, "w_in", keep=col),
                          self._w(p, "b_in", keep=row),
                          self._w(p, "w_out", keep=row),
                          0 if tp else p["b_out"])
            return x + (self._leave(y) + p["b_out"] if tp else y)
        y = gated_mlp(h, self._w(p, "w_gate", keep=col),
                      self._w(p, "w_up", keep=col),
                      self._w(p, "w_down", keep=row), self.cfg.act)
        return x + self._leave(y)

    def _moe_ffn(self, x, p):
        with self.obs.tracer.span("model.moe", "model"):
            return self._moe_layer(x, p)

    def _moe_layer(self, x, p):
        h = self._norm(x, p["norm"])
        if self.mesh is not None and self._tp:
            y, aux = moe_block_ep(
                h, self._w(p, "router"), self._w(p, "e_gate", keep=0),
                self._w(p, "e_up", keep=0), self._w(p, "e_down", keep=0),
                self.moe_dims, self.mesh, self._bx, self._tp)
            return x + y, aux
        y, aux = moe_block(h, p["router"], p["e_gate"], p["e_up"],
                           p["e_down"], self.moe_dims)
        if self.mesh is not None and self._bx:  # per-rank aux, pmean'd
            aux = leave(aux / self.mesh.axis_size(self._bx), self.mesh,
                        self._bx)
        return x + y, aux

    def _ssm_params(self, p):
        """The SSD leaves as this rank computes with them: its heads'
        columns of in_proj and of the conv (gathered over 'model', whose
        flat split cuts across the segments), its heads' A_log, dt_bias
        and D, and its out_proj rows; everything whole when the SSD runs
        replicated over 'model'."""
        if not self._ssm_tp:
            return {k: self._w(p, k, split=False) for k in p}, self.ssm_dims
        q = {
            "in_proj": self._w(p, "in_proj").index_select(
                1, self._ssm_in_cols),
            "conv_w": self._w(p, "conv_w").index_select(
                1, self._ssm_conv_cols),
            "conv_b": self._w(p, "conv_b").index_select(
                0, self._ssm_conv_cols),
            "out_proj": self._w(p, "out_proj", keep=0),
        }
        for k in ("A_log", "dt_bias", "D"):
            q[k] = self._w(p, k, keep=0)
        return q, self._ssm_local

    def _ssm_layer(self, x, p, h0=None):
        h = self._norm(x, p["norm"])
        if self.mesh is not None and self._tp:
            q, dims = self._ssm_params(p)
            if self._ssm_tp:
                h = self._enter(h)
            y, h_last, _ = ssd_forward(h, q, dims, h0)
            if self._ssm_tp:
                y = self._leave(y)
            else:  # the state's block of heads
                h_last = self._block(h_last, 1)
            return x + y, h_last, self._conv_tail(h, p)
        y, h_last, conv_tail = ssd_forward(h, p, self.ssm_dims, h0)
        return x + y, h_last, conv_tail

    def _block(self, t, dim: int):
        """This rank's block of dimension `dim` over the model axis."""
        n = t.shape[dim] // self._nm
        return t.narrow(dim, self._r * n, n)

    def _conv_tail(self, h, p):
        """The conv tail for decode (the last K-1 rows of the conv's input
        channels), this rank's block of the flat channels (the cache's
        layout).  No gradient flows through it."""
        d = self.ssm_dims
        with torch.no_grad():
            w = self._w(p, "in_proj", split=False)
            tail = h[:, h.shape[1] - (d.d_conv - 1):].detach() @ w[
                :, d.d_inner:d.d_inner + d.conv_channels]
            return self._block(tail.float(), 2)

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
                    if collect_cache:
                        ck, cv = self._context_cache(cp, img, ck, cv, "full")
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
            if collect_cache:
                ck, cv = self._context_cache(cp, enc_out, ck, cv, "seq")
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
        if self.mesh is not None:
            x = self._embed_sharded(params, tokens)
        else:
            emb = params["embed"]
            x = emb.index_select(0, tokens.reshape(-1)).reshape(
                *tokens.shape, emb.shape[1]).to(self.compute_dtype)
        if self.cfg.embed_scale:
            # sqrt(d_model) rounded to the compute dtype first, as the
            # reference's jnp.asarray(., compute_dtype)
            x = x * float(torch.tensor(self.cfg.d_model ** 0.5,
                                       dtype=self.compute_dtype))
        return x

    def _embed_sharded(self, params, tokens):
        """The lookup in this rank's block of the vocabulary (zero rows
        for the others' tokens), summed over the model axis."""
        emb, spec = self._top(params, "embed")
        if self._tp_dim(spec) != 0:  # the vocabulary is not model-split
            return self._whole(emb, spec)[tokens.long()]
        V_l = emb.shape[0]
        ids = tokens.long() - self._r * V_l
        inb = (ids >= 0) & (ids < V_l)
        x = emb[ids.clamp(0, V_l - 1)] * inb[..., None].to(emb.dtype)
        return self._leave(x)

    @property
    def vocab_axes(self):
        """The axes the logits' vocabulary is sharded over on a mesh."""
        if self.mesh is None or self._tp is None:
            return ()
        name = "embed" if self.cfg.tie_embeddings else "head"
        d = self._tp_dim(fit_rank(self.specs[name], 2))
        return (self._tp,) if d == (0 if name == "embed" else 1) else ()

    def _unembed(self, params, x):
        x = self._norm(x, params["final_norm"].to(self.compute_dtype),
                       params.get("final_norm_b"))
        if self.mesh is not None:
            name = "embed" if self.cfg.tie_embeddings else "head"
            w, spec = self._top(params, name)
            if self.vocab_axes:
                x = self._enter(x)
            else:
                w = self._whole(w, spec)
            return x @ (w.t() if name == "embed" else w)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(self.compute_dtype).t()
        return x @ params["head"].to(self.compute_dtype)

    def loss(self, logits, labels) -> torch.Tensor:
        """The mean token cross-entropy of `train_logits`' logits: on a
        mesh, of the global batch, from this rank's block of logits and
        labels (`sharded_cross_entropy`), the same on every rank."""
        if self.mesh is None:
            return cross_entropy_loss(logits, labels, self.cfg.vocab)
        return sharded_cross_entropy(logits, labels, self.cfg.vocab,
                                     self.mesh, self.vocab_axes, self._bx)

    def greedy(self, logits) -> torch.Tensor:
        """The argmax over the vocabulary of (B, V) logits, ties to the
        lower index; on a mesh, of this rank's rows, from each rank's
        block of the vocabulary (a gathered argmax).  Returns (B,) int32."""
        if (self.mesh is None or not self.vocab_axes
                or self.mesh.axis_size(self.vocab_axes) == 1):
            return torch.argmax(logits, dim=-1).to(torch.int32)
        V_l = logits.shape[-1]
        val, idx = torch.max(logits, dim=-1)
        vals = self.mesh.all_gather(val, self.vocab_axes, axis=1)
        idxs = self.mesh.all_gather(idx, self.vocab_axes, axis=1)
        member = torch.argmax(vals, dim=1, keepdim=True)
        return (torch.gather(idxs, 1, member)[:, 0]
                + member[:, 0] * V_l).to(torch.int32)

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
        self._cache_layout_check()
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, cache, _ = self._stack_full(params, x, self._positions(tokens),
                                       True, self._context(params, batch))
        logits = self._unembed(params, x[:, -1:, :])[:, 0, :]
        return logits, cache

    def _ssm_decode(self, x, norm, p, h, conv):
        """One SSD layer's decode step; the states `h` and `conv` (cache
        views) are written in place.  On a mesh the conv state (flat-split
        over 'model') is gathered, each rank steps its heads, and the new
        conv window is computed for every channel and cut to the rank's
        block."""
        with self.obs.tracer.span("model.ssm", "model"):
            return self._ssm_decode_layer(x, norm, p, h, conv)

    def _ssm_decode_layer(self, x, norm, p, h, conv):
        xin = self._norm(x, norm)
        if self.mesh is None or self._tp is None:
            y, st = ssd_decode_step(xin, SSMState(h=h, conv=conv), p,
                                    self.ssm_dims)
            h.copy_(st.h)
            conv.copy_(st.conv)
            return x + y
        q, dims = self._ssm_params(p)
        conv_full = gather_full(conv, self.mesh, P(None, None, self._tp))
        if self._ssm_tp:
            state = SSMState(h=h, conv=conv_full.index_select(
                2, self._ssm_conv_cols))
        else:
            state = SSMState(h=gather_full(h, self.mesh, P(None, self._tp)),
                             conv=conv_full)
        y, st = ssd_decode_step(xin, state, q, dims)
        if self._ssm_tp:
            y = self._leave(y)
            h.copy_(st.h)
        else:
            h.copy_(self._block(st.h, 1))
        d = self.ssm_dims
        w = self._w(p, "in_proj", split=False)
        xbc = xin[:, 0, :] @ w[:, d.d_inner:d.d_inner + d.conv_channels]
        wdt = torch.promote_types(conv.dtype, xbc.dtype)
        window = torch.cat([conv_full.to(wdt), xbc[:, None, :].to(wdt)], 1)
        conv.copy_(self._block(window[:, 1:], 2))
        return x + y

    def decode_step(self, params, caches: Tree, tokens, lengths):
        """One decode step.  tokens (B, 1), lengths (B,) current cache
        fill.  Writes the step's K/V and SSD states into `caches` in place
        and returns (logits (B, V_pad), caches).  An int8 model
        (`kv_int8`) of the dense or moe family decodes int8 caches (with
        ``k_scale``/``v_scale``) as the reference does.  Traced as a
        ``model.decode_step`` span (module docstring)."""
        tr = self.obs.tracer
        with tr.span("model.decode_step", "model"):
            x = self._decode_layers(params, caches, tokens, lengths, tr)
            with tr.span("model.unembed", "model"):
                return self._unembed(params, x)[:, 0, :], caches

    def _decode_layers(self, params, caches: Tree, tokens, lengths, tr):
        """`decode_step` up to the unembedding: the last layer's output
        (B, 1, D)."""
        self._records(params)
        self._cache_layout_check()
        cfg = self.cfg
        with tr.span("model.embed", "model"):
            x = self._embed(params, tokens)
        if cfg.family == "ssm":
            for i in range(cfg.n_layers):
                # the reference normalizes with the stored (uncast) scale
                x = self._ssm_decode(x, params["ssm"]["norm"][i],
                                     self._layer(params["ssm"], i),
                                     caches["ssm_h"][i],
                                     caches["ssm_conv"][i])
            return x
        B = tokens.shape[0]
        S_max = caches["k"].shape[-3]  # (..., B, S_max, Hkv, hd)
        # on a mesh, this rank's block of positions
        first = self._r * S_max if self.mesh is not None else 0
        pos = torch.arange(first, first + S_max, dtype=torch.int32,
                           device=lengths.device).expand(B, S_max)
        idx = _DecodeIndex(
            rows=torch.arange(B, device=lengths.device),
            at=lengths.long(), qpos=lengths[:, None], pos=pos,
            valid=pos < (lengths[:, None] + 1),
            kv_len=(lengths + 1).to(torch.int32))
        if cfg.family == "hybrid":
            return self._hybrid_decode(params, caches, x, idx)
        if cfg.family == "vlm":
            return self._vlm_decode(params, caches, x, idx)
        if cfg.family == "encdec":
            for i in range(cfg.n_layers):
                x = self._attn_decode(x, self._layer(params["dec_attn"], i),
                                      caches["k"][i], caches["v"][i], idx)
                x = self._cross_attn(x, self._layer(params["dec_cross"], i),
                                     caches["xk"][i].to(x.dtype),
                                     caches["xv"][i].to(x.dtype),
                                     layout="seq")
                x = self._ffn(x, self._layer(params["dec_mlp"], i))
            return x
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
        return x

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
                        gate=params["cross"]["gate"][g], layout="full")
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


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int, mesh, vocab_axes,
                          batch_axes) -> torch.Tensor:
    """`cross_entropy_loss` of the global batch from this rank's block of
    the logits (B_loc, S, V_pad / n, the vocabulary split over
    `vocab_axes`) and of the labels (B_loc, S): the max by pmax, the sum
    of exponentials and the label's logit by psum over `vocab_axes`, and
    the rows' means pmean'd over `batch_axes`.  The same value on every
    rank; autograd gives each rank its share of the gradient."""
    V_l = logits.shape[-1]
    off = mesh.device_rank(vocab_axes) * V_l if vocab_axes else 0
    col = torch.arange(off, off + V_l, device=logits.device)
    if off + V_l > vocab:
        logits = torch.where(col < vocab, logits, torch.full(
            (), -1e30, dtype=logits.dtype, device=logits.device))
    lf = logits.float()
    m = torch.amax(lf, dim=-1).detach()
    if vocab_axes and mesh.axis_size(vocab_axes) > 1:
        m = mesh.pmax(m, vocab_axes)
    se = leave(torch.sum(torch.exp(lf - m[..., None]), dim=-1), mesh,
               vocab_axes)
    lse = m + torch.log(se)
    lab = labels.long() - off
    inb = (lab >= 0) & (lab < V_l)
    picked = torch.gather(logits, -1, lab.clamp(0, V_l - 1)[..., None])
    picked = leave(picked[..., 0].float() * inb, mesh, vocab_axes)
    loss = torch.mean(lse - picked)
    if batch_axes:
        loss = leave(loss / mesh.axis_size(batch_axes), mesh, batch_axes)
    return loss
