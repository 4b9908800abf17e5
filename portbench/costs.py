"""Work counted from shapes and sizes, whatever kernels do it: a dense
decoder's FLOPs and least bytes for a decode step.  The per-layer readers
divide these by device time at the card's peaks (`harness.PEAK_*`)."""

from __future__ import annotations

from typing import Sequence


def dense_token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one decoded token of a dense decoder at `context`
    positions attended (the new one included): 2 per weight of every
    matrix it multiplies (the projections, the gated MLP and the
    unembedding; the embedding is a lookup), plus 4 per head-dimension per
    attended position and query head (QK^T and PV)."""
    D, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    hd = cfg["head_dim"]
    Hq, Hkv, F = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    per_layer = D * hd * (2 * Hq + 2 * Hkv) + 3 * D * F
    return 2.0 * (L * per_layer + D * V) + 4.0 * L * Hq * hd * context


def dense_weight_bytes(cfg: dict, dtype_bytes: int = 2) -> int:
    """Bytes of the weights a decode step reads: every layer's matrices,
    the norms' scales and the unembedding; of the embedding only the rows
    looked up, which `dense_step_bytes` counts."""
    D, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    hd = cfg["head_dim"]
    Hq, Hkv, F = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    per_layer = D * hd * (2 * Hq + 2 * Hkv) + 3 * D * F + 2 * D
    head = 0 if cfg.get("tie_embeddings") else D * V
    return dtype_bytes * (L * per_layer + head + D)


def kv_row_bytes(cfg: dict, dtype_bytes: int = 2) -> int:
    """Bytes of one position's K and V over every layer."""
    return 2 * cfg["n_layers"] * cfg["n_kv_heads"] * cfg["head_dim"] \
        * dtype_bytes


def dense_step_bytes(cfg: dict, contexts: Sequence[int], slots: int,
                     dtype_bytes: int = 2) -> int:
    """The least bytes of one decode step over `slots` rows, of which the
    active ones attend `contexts` positions (the new one included): the
    weights once, each active row's valid K/V prefix read once, each
    row's new K/V written once, each row's embedding read once and its
    logits (f32... in the compute dtype) written once."""
    D, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    kv_row = kv_row_bytes(cfg, dtype_bytes)
    prefix = sum(max(int(c) - 1, 0) for c in contexts) * kv_row
    return (dense_weight_bytes(cfg, dtype_bytes) + prefix
            + slots * kv_row + slots * D * dtype_bytes
            + slots * V * dtype_bytes)
