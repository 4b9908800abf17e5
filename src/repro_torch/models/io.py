"""Decode caches: their shapes for every family, and zero caches on a device.

Counterpart of src/repro/models/io.py.  `_cache_shapes` is the reference's
shape arithmetic for all six families; `init_caches` builds real zero
caches (bf16 by default, as the reference's) on `device`, the card unless
the caller names another.  The dry-run stand-ins (`cache_specs`,
`input_specs`) wait for `launch/dryrun.py`'s slice (ROADMAP queue 1 item
8.6).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
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
