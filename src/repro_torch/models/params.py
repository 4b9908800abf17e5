"""Parameter initialization for the dense family.

Counterpart of src/repro/models/params.py: nested dicts with layer-stacked
leaves (a leading layer axis), the reference's key paths, shapes and
scales (0.02; ``wo`` and ``w_down`` over sqrt(2L); ``embed`` and ``head``
over sqrt(D); norms and biases zero).  The draws come from an explicit
`torch.Generator`, whose stream is not `jax.random`'s: a test that needs
the reference's numbers converts its tree (`convert.params_from_numpy`).
The leaves are stored in the compute dtype, so no f32 copy stays on the
card; a stacked leaf is drawn in f32 and cast one layer at a time, which
keeps the peak near the stored total.  The spec tree of `PartitionSpec`s
waits for the sharding slice (ROADMAP queue 1 item 8.5).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import pad_to_multiple
from repro_torch.utils.hostsync import resolve_device

Tree = Dict[str, Any]

VOCAB_PAD = 128  # pad vocab to multiples of 128

# The families whose modules are still to port, with their ROADMAP items.
NOT_PORTED = {
    "moe": "ROADMAP queue 1 item 8.1 (MoE: layers/moe.py, _moe_ffn)",
    "ssm": "ROADMAP queue 1 item 8.2 (SSM and hybrid: layers/ssm.py)",
    "hybrid": "ROADMAP queue 1 item 8.2 (SSM and hybrid: layers/ssm.py)",
    "encdec": "ROADMAP queue 1 item 8.3 (enc-dec and VLM)",
    "vlm": "ROADMAP queue 1 item 8.3 (enc-dec and VLM)",
}

# Leaves the reference reads without casting to the compute dtype
# (model.py's `_unembed` passes `final_norm_b` as stored): kept in f32.
F32_LEAVES = ("final_norm_b",)


def padded_vocab(cfg: ModelConfig) -> int:
    return pad_to_multiple(cfg.vocab, VOCAB_PAD)


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"({NOT_PORTED[cfg.family]}); the dense family is")
    if cfg.family != "dense":
        raise ValueError(cfg.family)


# (shape, scale): scale None is a zero leaf.
Leaf = Tuple[Tuple[int, ...], Optional[float]]


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


def param_layout(cfg: ModelConfig) -> Tree:
    """The parameter tree as (shape, scale) leaves, in the reference's
    key order (which is also its draw order)."""
    require_ported(cfg)
    V = padded_vocab(cfg)
    D = cfg.d_model
    layout: Tree = {
        "embed": ((V, D), 1.0 / math.sqrt(D)),
        "final_norm": ((D,), None),
    }
    if cfg.norm == "layer":
        layout["final_norm_b"] = ((D,), None)
    if not cfg.tie_embeddings:
        layout["head"] = ((D, V), 1.0 / math.sqrt(D))
    layout["attn"] = _attn_layout(cfg, cfg.n_layers)
    layout["mlp"] = _mlp_layout(cfg, cfg.n_layers)
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
    `device`: a stacked (3-D) leaf one layer at a time."""
    out = torch.empty(shape, dtype=dtype, device=device)
    parts = out if len(shape) == 3 else out[None]
    for part in parts:
        z = torch.randn(part.shape, generator=generator,
                        device=generator.device)
        part.copy_(z.mul_(scale))
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.bfloat16, device=None) -> Tree:
    """Random parameters of a dense config on `device` (the card unless the
    caller names another), every leaf in `dtype` but `F32_LEAVES`.  The
    generator's device need not be `device`: draws move across."""
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
            shape, scale = v
            dt = leaf_dtype(path, dtype)
            out[k] = (torch.zeros(shape, dtype=dt, device=dev)
                      if scale is None
                      else _draw(generator, shape, scale, dt, dev))
        return out

    return build(param_layout(cfg))
