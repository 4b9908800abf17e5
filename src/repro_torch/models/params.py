"""Parameter initialization for every family.

Counterpart of src/repro/models/params.py: nested dicts with layer-stacked
leaves (a leading layer axis; the hybrid family's SSD, MoE and MLP leaves
two, superblock then position), the reference's key paths, shapes and
scales (0.02; ``wo``, ``w_down``, ``w_out``, ``e_down`` and ``out_proj``
over sqrt(2L); ``embed`` and ``head`` over sqrt(D); ``conv_w`` 0.1; norms,
biases and the VLM's cross-attention ``gate`` zero; the SSD's ``A_log``
log(1..H) and ``D`` one; the port-only shared expert ``s_gate``,
``s_up``, ``s_down`` as the dense MLP's and the gated SSD norm's
``out_norm`` zero).  The enc-dec family stacks its encoder
(``enc_attn``, ``enc_mlp``) and decoder (``dec_attn``, ``dec_cross``,
``dec_mlp``) layers; the VLM's ``cross`` holds one attention layer for
every ``cross_attn_every`` layers.  The experts pad to a multiple of the
mesh's model axis (`padded_experts`; 1 with no mesh, as the reference's
mesh-free `build_model`): the port's tree takes that model's `init` tree
leaf for leaf.  The draws come from an explicit `torch.Generator`, whose stream is
not `jax.random`'s: a test that needs the reference's numbers converts its
tree (`convert.params_from_numpy`).  The leaves are stored in
the compute dtype, so no f32 copy stays on the card; a stacked leaf is
drawn in f32 and cast one matrix at a time, which keeps the peak near the
stored total.  `param_specs` is the reference's spec tree, the second
value its `init_params` returns: a `PartitionSpec` for every leaf, from
the `ShardingRules` (the hybrid family's two-axis leaves take a leading
None); `init_params(..., mesh=, specs=)` keeps each rank's block of every
drawn leaf (`sharding.local_shard`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (P, ShardingRules, local_shard,
                                              pad_to_multiple)
from repro_torch.utils.hostsync import resolve_device

Tree = Dict[str, Any]

VOCAB_PAD = 128  # pad vocab to multiples of 128

# Leaves the reference reads without casting to the compute dtype: kept in
# f32 (model.py's `_unembed` passes `final_norm_b` as stored, the ssm
# family's `decode_step` normalizes with the stored `ssm/norm`, and the
# VLM's cross-attention takes tanh of the stored `cross/gate`).
F32_LEAVES = ("final_norm_b", "ssm/norm", "cross/gate")


def padded_vocab(cfg: ModelConfig) -> int:
    return pad_to_multiple(cfg.vocab, VOCAB_PAD)


def padded_experts(cfg: ModelConfig, model_axis: int = 1) -> int:
    """The experts padded to a multiple of the mesh's model axis (1 with
    no mesh, as the reference's `build_model` takes it)."""
    assert cfg.moe is not None
    return pad_to_multiple(cfg.moe.n_experts, model_axis)


# (shape, init): init a float is N(0, init^2), None a zero leaf, "ones" a
# leaf of ones, "a_log" the SSD's log(1..H) along the last axis.
Leaf = Tuple[Tuple[int, ...], Union[float, str, None]]


def _attn_layout(cfg: ModelConfig, n: int) -> Dict[str, Leaf]:
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    qo, kvo = cfg.n_heads * hd, cfg.n_kv_heads * hd
    s = 0.02
    p = {
        "norm": ((n, D), None),
        "wq": ((n, D, qo), s),
        "wk": ((n, D, kvo), s),
        "wv": ((n, D, kvo), s),
        "wo": ((n, qo, D), s / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        p |= {"bq": ((n, qo), None), "bk": ((n, kvo), None),
              "bv": ((n, kvo), None)}
    if cfg.norm == "layer":
        p["norm_b"] = ((n, D), None)
    return p


def _mlp_layout(cfg: ModelConfig, n: int) -> Dict[str, Leaf]:
    D, F = cfg.d_model, cfg.d_ff
    s = 0.02
    if cfg.act == "gelu_mlp":  # plain MLP with biases
        return {
            "norm": ((n, D), None),
            "norm_b": ((n, D), None),
            "w_in": ((n, D, F), s),
            "b_in": ((n, F), None),
            "w_out": ((n, F, D), s / math.sqrt(2 * cfg.n_layers)),
            "b_out": ((n, D), None),
        }
    return {
        "norm": ((n, D), None),
        "w_gate": ((n, D, F), s),
        "w_up": ((n, D, F), s),
        "w_down": ((n, F, D), s / math.sqrt(2 * cfg.n_layers)),
    }


def _moe_layout(cfg: ModelConfig, n: int, e_pad: int) -> Dict[str, Leaf]:
    D, F = cfg.d_model, cfg.d_ff
    s = 0.02
    out = {
        "norm": ((n, D), None),
        "router": ((n, D, e_pad), s),
        "e_gate": ((n, e_pad, D, F), s),
        "e_up": ((n, e_pad, D, F), s),
        "e_down": ((n, e_pad, F, D), s / math.sqrt(2 * cfg.n_layers)),
    }
    Fs = cfg.moe.shared_d_ff
    if Fs:  # port-only: the shared expert
        out |= {"s_gate": ((n, D, Fs), s), "s_up": ((n, D, Fs), s),
                "s_down": ((n, Fs, D), s / math.sqrt(2 * cfg.n_layers))}
    return out


def ssm_dims(cfg: ModelConfig):
    from repro_torch.models.layers.ssm import SSMDims

    sc = cfg.ssm
    return SSMDims(d_model=cfg.d_model, d_inner=sc.d_inner,
                   head_dim=sc.head_dim, d_state=sc.d_state,
                   n_groups=sc.n_groups, d_conv=sc.d_conv, chunk=sc.chunk,
                   gated_norm=sc.gated_norm, norm_eps=cfg.norm_eps)


def _ssm_layout(cfg: ModelConfig, n: int) -> Dict[str, Leaf]:
    dims = ssm_dims(cfg)
    s = 0.02
    H = dims.n_heads
    out = {
        "norm": ((n, cfg.d_model), None),
        "in_proj": ((n, cfg.d_model, dims.in_proj_out), s),
        "conv_w": ((n, dims.d_conv, dims.conv_channels), 0.1),
        "conv_b": ((n, dims.conv_channels), None),
        "A_log": ((n, H), "a_log"),
        "dt_bias": ((n, H), None),
        "D": ((n, H), "ones"),
        "out_proj": ((n, dims.d_inner, cfg.d_model),
                     s / math.sqrt(2 * cfg.n_layers)),
    }
    if dims.gated_norm:  # port-only: the gated norm's scale
        out["out_norm"] = ((n, dims.d_inner), None)
    return out


def _restack(layout: Dict[str, Leaf], nsb: int, per: int) -> Dict[str, Leaf]:
    """Leading axis nsb * per -> (nsb, per), as the reference's hybrid
    branch reshapes its stacked leaves."""
    return {k: ((nsb, per) + shape[1:], init)
            for k, (shape, init) in layout.items()}


def param_layout(cfg: ModelConfig, model_axis: int = 1) -> Tree:
    """The parameter tree as (shape, init) leaves, in the reference's
    key order (which is also its draw order)."""
    V = padded_vocab(cfg)
    D = cfg.d_model
    L = cfg.n_layers
    layout: Tree = {
        "embed": ((V, D), 1.0 / math.sqrt(D)),
        "final_norm": ((D,), None),
    }
    if cfg.norm == "layer":
        layout["final_norm_b"] = ((D,), None)
    if not cfg.tie_embeddings:
        layout["head"] = ((D, V), 1.0 / math.sqrt(D))
    fam = cfg.family
    if fam in ("dense", "moe"):
        layout["attn"] = _attn_layout(cfg, L)
        if cfg.moe:
            n_moe = L // cfg.moe.every
            layout["moe"] = _moe_layout(cfg, n_moe,
                                        padded_experts(cfg, model_axis))
            if cfg.moe.every > 1:
                layout["mlp"] = _mlp_layout(cfg, L - n_moe)
        else:
            layout["mlp"] = _mlp_layout(cfg, L)
    elif fam == "ssm":
        layout["ssm"] = _ssm_layout(cfg, L)
    elif fam == "encdec":
        Le = cfg.n_encoder_layers
        layout["enc_attn"] = _attn_layout(cfg, Le)
        layout["enc_mlp"] = _mlp_layout(cfg, Le)
        layout["dec_attn"] = _attn_layout(cfg, L)
        layout["dec_cross"] = _attn_layout(cfg, L)
        layout["dec_mlp"] = _mlp_layout(cfg, L)
    elif fam == "vlm":
        nx = L // cfg.cross_attn_every
        layout["attn"] = _attn_layout(cfg, L)
        layout["mlp"] = _mlp_layout(cfg, L)
        layout["cross"] = _attn_layout(cfg, nx) | {"gate": ((nx,), None)}
    elif fam == "hybrid":  # period-long superblocks
        period = cfg.hybrid_period
        nsb = L // period
        n_mamba = period - 1
        n_moe_sb = period // cfg.moe.every  # MoE slots per superblock
        n_dense_sb = period - n_moe_sb
        layout["attn"] = _attn_layout(cfg, nsb)
        layout["ssm"] = _restack(_ssm_layout(cfg, nsb * n_mamba), nsb,
                                 n_mamba)
        layout["moe"] = _restack(
            _moe_layout(cfg, nsb * n_moe_sb,
                        padded_experts(cfg, model_axis)),
            nsb, n_moe_sb)
        if n_dense_sb:  # none where every position has MoE (every 1)
            layout["mlp"] = _restack(_mlp_layout(cfg, nsb * n_dense_sb),
                                     nsb, n_dense_sb)
    else:
        raise ValueError(fam)
    return layout


def leaves(tree: Tree, prefix: str = ""):
    """(key path, leaf) pairs of a nested dict, depth first in key order."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v


def leaf_dtype(path: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if path in F32_LEAVES else dtype


def _draw(generator: torch.Generator, shape, scale: float, dtype, device):
    """N(0, scale^2) in f32 on the generator's device, cast to `dtype` on
    `device`: a stacked leaf one matrix (its last two axes) at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out.view(-1, *shape[-2:]) if len(shape) >= 3 else out[None]
    for part in parts:
        z = torch.randn(part.shape, generator=generator,
                        device=generator.device)
        part.copy_(z.mul_(scale))
    return out


def _fill(shape, init, dtype, device) -> torch.Tensor:
    if init is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "a_log":
        H = shape[-1]
        row = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(shape).to(dtype).contiguous()
    raise ValueError(init)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device=None,
                model_axis: int = 1, mesh=None, specs: Tree = None) -> Tree:
    """Random parameters of a config on `device` (the card unless the
    caller names another), every leaf in `dtype` but `F32_LEAVES`.  The
    generator's device need not be `device`: draws move across.  With a
    `mesh` and the `specs` tree, each leaf is drawn whole (every rank
    draws the same numbers from the same seed) and this rank keeps its
    block."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def build(layout: Tree, prefix: str = "") -> Tree:
        out: Tree = {}
        for k, v in layout.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = build(v, path)
                continue
            shape, init = v
            dt = leaf_dtype(path, dtype)
            out[k] = (_draw(generator, shape, init, dt, dev)
                      if isinstance(init, float)
                      else _fill(shape, init, dt, dev))
            if mesh is not None:
                out[k] = local_shard(out[k], mesh,
                                     spec_at(specs, path)).clone()
        return out

    return build(param_layout(cfg, model_axis))


def spec_at(tree: Tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# the rule field (or the fixed spec) of each leaf name
_REPLICATED2 = P(None, None)
_ROLE = {
    "embed": "embed", "head": "head", "final_norm": "norm_scale",
    "final_norm_b": "norm_scale", "norm": _REPLICATED2,
    "norm_b": _REPLICATED2, "wq": "wq", "wk": "wkv", "wv": "wkv",
    "wo": "wo", "bq": "qkv_bias", "bk": "qkv_bias", "bv": "qkv_bias",
    "w_in": "w_in", "b_in": "qkv_bias", "w_out": "w_out",
    "b_out": _REPLICATED2, "w_gate": "w_in", "w_up": "w_in",
    "w_down": "w_out", "router": "router", "e_gate": "expert_in",
    "e_up": "expert_in", "e_down": "expert_out", "in_proj": "ssm_in",
    "conv_w": "conv_kernel", "conv_b": "ssm_small", "A_log": _REPLICATED2,
    "dt_bias": _REPLICATED2, "D": _REPLICATED2, "out_proj": "ssm_out",
    "gate": P(None), "s_gate": "w_in", "s_up": "w_in", "s_down": "w_out",
    "out_norm": _REPLICATED2,
}


def param_specs(cfg: ModelConfig, rules: Optional[ShardingRules] = None,
                model_axis: int = 1) -> Tree:
    """The spec tree of `param_layout`'s tree (the reference's
    `init_params` second value): the hybrid family's two-axis SSD, MoE and
    MLP leaves take a leading None."""
    rules = rules or ShardingRules()

    def build(layout: Tree, prefix: str = "") -> Tree:
        out: Tree = {}
        for k, v in layout.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = build(v, path)
                continue
            role = _ROLE[k]
            spec = getattr(rules, role) if isinstance(role, str) else role
            if cfg.family == "hybrid" and path.split("/")[0] in (
                    "ssm", "moe", "mlp"):
                spec = P(None, *spec)
            out[k] = spec
        return out

    return build(param_layout(cfg, model_axis))
