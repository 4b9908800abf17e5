"""Decode caches and the steps' input trees: their shapes for every family,
zero caches on a device, and shape-only stand-ins for the dry run.

Counterpart of src/repro/models/io.py.  `_cache_shapes` is the reference's
shape arithmetic for all six families; `init_caches` builds real zero
caches (bf16 by default, as the reference's) on `device`, the card unless
the caller names another.  `cache_specs` and `input_specs` are the
reference's `ShapeDtypeStruct` trees as tensors on the `meta` device: the
same shapes and dtypes, no storage (`launch/dryrun.py` takes each rank's
block of them as a fake tensor).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import local_shape
from repro_torch.utils.hostsync import resolve_device

Tree = Dict[str, Any]


def _cache_shapes(cfg: ModelConfig, B: int, S_max: int,
                  dtype=torch.bfloat16, kv_int8: bool = False) -> Tree:
    """Family-specific cache tree of (shape, dtype) tuples."""
    hd = cfg.resolved_head_dim
    Hkv = cfg.n_kv_heads
    fam = cfg.family
    out: Tree = {}
    if fam in ("dense", "moe"):
        kv_dtype = torch.int8 if kv_int8 else dtype
        out["k"] = ((cfg.n_layers, B, S_max, Hkv, hd), kv_dtype)
        out["v"] = ((cfg.n_layers, B, S_max, Hkv, hd), kv_dtype)
        if kv_int8:
            out["k_scale"] = ((cfg.n_layers, B, S_max, Hkv), torch.bfloat16)
            out["v_scale"] = ((cfg.n_layers, B, S_max, Hkv), torch.bfloat16)
    elif fam == "ssm":
        s = cfg.ssm
        H = s.d_inner // s.head_dim
        conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
        out["ssm_h"] = ((cfg.n_layers, B, H, s.d_state, s.head_dim),
                        torch.float32)
        out["ssm_conv"] = ((cfg.n_layers, B, s.d_conv - 1, conv_ch),
                           torch.float32)
    elif fam == "hybrid":
        s = cfg.ssm
        H = s.d_inner // s.head_dim
        conv_ch = s.d_inner + 2 * s.n_groups * s.d_state
        nsb = cfg.n_layers // cfg.hybrid_period
        nm = cfg.hybrid_period - 1
        out["k"] = ((nsb, B, S_max, Hkv, hd), dtype)
        out["v"] = ((nsb, B, S_max, Hkv, hd), dtype)
        out["ssm_h"] = ((nsb, nm, B, H, s.d_state, s.head_dim), torch.float32)
        out["ssm_conv"] = ((nsb, nm, B, s.d_conv - 1, conv_ch), torch.float32)
    elif fam == "encdec":
        Ld = cfg.n_layers
        S_enc = S_max  # encoder context sized like the cell's seq_len
        out["k"] = ((Ld, B, S_max, Hkv, hd), dtype)
        out["v"] = ((Ld, B, S_max, Hkv, hd), dtype)
        out["xk"] = ((Ld, B, S_enc, Hkv, hd), dtype)
        out["xv"] = ((Ld, B, S_enc, Hkv, hd), dtype)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        ng = cfg.n_layers // k
        out["k"] = ((ng, k, B, S_max, Hkv, hd), dtype)
        out["v"] = ((ng, k, B, S_max, Hkv, hd), dtype)
        out["xk"] = ((ng, B, cfg.n_image_tokens, Hkv, hd), dtype)
        out["xv"] = ((ng, B, cfg.n_image_tokens, Hkv, hd), dtype)
    else:
        raise ValueError(fam)
    return out


def init_caches(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
                kv_int8: bool = False, device=None, mesh=None,
                specs: Tree = None) -> Tree:
    """Zero decode caches of `B` rows and `S_max` positions on `device`;
    with a `mesh` and the caches' spec tree (`train.steps.batch_spec_tree`
    of a decode shape, its "caches"), this rank's blocks, on the mesh's
    device."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    out = {}
    for name, (shape, dt) in _cache_shapes(cfg, B, S_max, dtype,
                                           kv_int8).items():
        if mesh is not None:
            shape = local_shape(shape, mesh, specs[name])
        out[name] = torch.zeros(shape, dtype=dt, device=dev)
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cache_specs(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
                kv_int8: bool = False) -> Tree:
    """`init_caches`' tree as `meta` tensors."""
    return {name: _meta(shape, dt) for name, (shape, dt)
            in _cache_shapes(cfg, B, S_max, dtype, kv_int8).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                kv_int8: bool = False) -> Tree:
    """The step function's input tree as `meta` tensors: tokens (and
    labels to train) of the global batch, the enc-dec family's
    `enc_embeds` and the VLM's `image_embeds`, and to decode the lengths
    and caches (int8 K/V only for the dense and moe families)."""
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model

    def tok(*s):
        return _meta(s, torch.int32)

    def emb(*s):
        return _meta(s, torch.bfloat16)

    if shape.kind in ("train", "prefill"):
        batch: Tree = {"tokens": tok(B, S)}
        if shape.kind == "train":
            batch["labels"] = tok(B, S)
        if cfg.family == "encdec":
            batch["enc_embeds"] = emb(B, S, D)  # conv frontend stubbed
        if cfg.family == "vlm":
            batch["image_embeds"] = emb(B, cfg.n_image_tokens, D)
        return batch
    if shape.kind == "decode":
        use_int8 = kv_int8 and cfg.family in ("dense", "moe")
        return {"tokens": tok(B, 1), "lengths": tok(B),
                "caches": cache_specs(cfg, B, S, kv_int8=use_int8)}
    raise ValueError(shape.kind)
