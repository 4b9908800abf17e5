"""The Mamba-2/attention hybrid with sparse experts (granite-4.0-h-small,
`model_type` granitemoehybrid), as `systems/serve.py` takes it.  The
configuration's file holds the model's own config.json keys (catalog
names); from them come the program's `ModelConfig` (the port-only fields:
dropless routing, the shared expert, the µP multipliers, NoPE, the gated
SSD norm, the norm eps), the weights in the program's tree, the float32
reference and its float8 control (`portbench.ref.hybrid`), the FLOPs and
least bytes of a decode step, a position's cache bytes and the attention
call the traced windows label.  The limit of the served-token check is the
configuration's own (`logit_gap_limit`), set from its readings.
"""

from __future__ import annotations

import math
from typing import Sequence

from portbench.ref import hybrid as RH

# (module, attribute) of the attention layers' call, which the traced
# windows label `serve.attention`.
ATTENTION = ("repro_torch.models.model", "attend_chunked")

forward = RH.forward
control_transform = RH.quantize_fp8


def layout(cfg: dict) -> tuple:
    """(superblocks, period, attention position) of the kept layers:
    attention at a, a + p, ... and the SSD elsewhere, whole periods."""
    kinds = RH.layer_kinds(cfg)
    at = [i for i, k in enumerate(kinds) if k == "attention"]
    if not at:
        raise ValueError("no attention layer among the kept layers")
    p = at[1] - at[0] if len(at) > 1 else len(kinds)
    if len(kinds) % p or at != list(range(at[0], len(kinds), p)) \
            or any(k not in ("attention", "mamba") for k in kinds):
        raise ValueError(f"layer_types {kinds} is not whole periods")
    return len(kinds) // p, p, at[0]


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

    _, period, attn_pos = layout(cfg)
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    return ModelConfig(
        name=cfg["arch"], family="hybrid",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        act="silu", norm="rms", tie_embeddings=cfg["tie_word_embeddings"],
        rope_theta=float(cfg["rope_theta"]),
        moe=MoEConfig(n_experts=cfg["num_local_experts"],
                      top_k=cfg["num_experts_per_tok"], every=1,
                      dropless=True,
                      shared_d_ff=cfg["shared_intermediate_size"]),
        ssm=SSMConfig(d_inner=H * P, head_dim=P,
                      d_state=cfg["mamba_d_state"],
                      n_groups=cfg["mamba_n_groups"],
                      d_conv=cfg["mamba_d_conv"],
                      chunk=cfg["mamba_chunk_size"], gated_norm=True),
        hybrid_period=period, hybrid_attn_pos=attn_pos,
        max_position=cfg["max_position_embeddings"],
        norm_eps=cfg["rms_norm_eps"],
        rope=cfg["position_embedding_type"] != "nope",
        attn_scale=cfg["attention_multiplier"],
        embed_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=cfg["residual_multiplier"],
        logits_divisor=float(cfg["logits_scaling"]))


def make_weights(cfg: dict, seed: int, device, dtype=None):
    """The hybrid's weights in the program's tree (`attn` by superblock;
    `ssm` and `moe` by superblock and position), from one generator on
    `device`: N(0, s^2) with s = init_std for the matrices (out_std for
    wo, out_proj, e_down and s_down), embed_std for the tied embedding,
    norm_init_std for the norms' scales (around the 1 + scale form) and
    the conv's bias, conv_std for its taps; the SSD's
    A = -exp(A_log) uniform in [1, 16], dt_bias the inverse softplus of a
    dt log-uniform in [0.001, 0.1] (Mamba-2's initialization), D one."""
    import torch

    if not cfg["tie_word_embeddings"] or cfg["vocab_size"] % 128:
        raise ValueError("the family serves a tied embedding whose rows are "
                         "a multiple of 128 (the program's padding)")
    dtype = dtype or getattr(torch, cfg["dtype"])
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    nsb, period, _ = layout(cfg)
    nm = period - 1
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    hd = D // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    H, P, N, G = cfg["mamba_n_heads"], cfg["mamba_d_head"], \
        cfg["mamba_d_state"], cfg["mamba_n_groups"]
    di = H * P
    conv_ch = di + 2 * G * N
    E, F, Fs = cfg["num_local_experts"], cfg["intermediate_size"], \
        cfg["shared_intermediate_size"]
    s, sn, so = cfg["init_std"], cfg["norm_init_std"], cfg["out_std"]

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo

    dt = torch.exp(uniform((nsb, nm, H), math.log(1e-3), math.log(0.1)))
    params = {
        "embed": draw((V, D), cfg["embed_std"]),
        "final_norm": draw((D,), sn),
        "attn": {"norm": draw((nsb, D), sn), "wq": draw((nsb, D, q), s),
                 "wk": draw((nsb, D, kv), s), "wv": draw((nsb, D, kv), s),
                 "wo": draw((nsb, q, D), so)},
        "ssm": {
            "norm": draw((nsb, nm, D), sn),
            "in_proj": draw((nsb, nm, D, 2 * di + 2 * G * N + H), s),
            "conv_w": draw((nsb, nm, cfg["mamba_d_conv"], conv_ch),
                           cfg["conv_std"]),
            "conv_b": draw((nsb, nm, conv_ch), sn),
            "A_log": torch.log(uniform((nsb, nm, H), 1.0, 16.0)).to(dtype),
            "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
            "D": torch.ones((nsb, nm, H), device=device, dtype=dtype),
            "out_proj": draw((nsb, nm, di, D), so),
            "out_norm": draw((nsb, nm, di), sn),
        },
        "moe": {
            "norm": draw((nsb, period, D), sn),
            "router": draw((nsb, period, D, E), s),
            "e_gate": draw((nsb, period, E, D, F), s),
            "e_up": draw((nsb, period, E, D, F), s),
            "e_down": draw((nsb, period, E, F, D), so),
            "s_gate": draw((nsb, period, D, Fs), s),
            "s_up": draw((nsb, period, D, Fs), s),
            "s_down": draw((nsb, period, Fs, D), so),
        },
    }
    return params


def _sizes(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    hd = D // cfg["num_attention_heads"]
    kinds = RH.layer_kinds(cfg)
    H, P, N, G = cfg["mamba_n_heads"], cfg["mamba_d_head"], \
        cfg["mamba_d_state"], cfg["mamba_n_groups"]
    di = H * P
    return dict(
        D=D, V=cfg["vocab_size"], hd=hd, Hq=cfg["num_attention_heads"],
        Hkv=cfg["num_key_value_heads"], n_attn=kinds.count("attention"),
        n_ssm=kinds.count("mamba"), n_moe=len(kinds), H=H, P=P, N=N,
        di=di, conv_ch=di + 2 * G * N, in_out=2 * di + 2 * G * N + H,
        Kc=cfg["mamba_d_conv"], E=cfg["num_local_experts"],
        K=cfg["num_experts_per_tok"], F=cfg["intermediate_size"],
        Fs=cfg["shared_intermediate_size"])


def token_flops(cfg: dict, context: int) -> float:
    """Model FLOPs of one decoded token at `context` positions attended
    (the new one included): 2 per weight of every matrix it multiplies
    (the attention projections, in_proj and out_proj, the router, its
    top-k experts, the shared expert and the unembedding; the embedding is
    a lookup), 4 per head-dimension per attended position and query head
    of each attention layer (QK^T and PV), and 5 per element of each SSD
    layer's state (the decay, the input's outer product and its add, and
    C.h's multiply-add)."""
    z = _sizes(cfg)
    D = z["D"]
    attn = D * z["hd"] * (2 * z["Hq"] + 2 * z["Hkv"])
    ssm = D * z["in_out"] + z["di"] * D
    moe = D * z["E"] + z["K"] * 3 * D * z["F"] + 3 * D * z["Fs"]
    state = z["H"] * z["N"] * z["P"]
    return (2.0 * (z["n_attn"] * attn + z["n_ssm"] * ssm + z["n_moe"] * moe
                   + D * z["V"])
            + 4.0 * z["n_attn"] * z["Hq"] * z["hd"] * context
            + 5.0 * z["n_ssm"] * state)


def weight_bytes(cfg: dict, dtype_bytes: int = 2) -> int:
    """Bytes of the weights a decode step reads: every layer's matrices,
    the norms' scales, the conv's taps and bias, the SSD's per-head
    vectors, every routed expert of every layer (at 64 tokens and top-10
    of 72, an expert is untouched by a step's 640 assignments with
    probability (62/72)^64, about 7e-5), the shared expert, and the tied
    embedding whole as the unembedding; of the embedding's lookup only the
    rows, which `step_bytes` counts."""
    z = _sizes(cfg)
    D = z["D"]
    attn = D * z["hd"] * (2 * z["Hq"] + 2 * z["Hkv"]) + D
    ssm = (D * z["in_out"] + z["di"] * D + D + z["Kc"] * z["conv_ch"]
           + z["conv_ch"] + 3 * z["H"] + z["di"])
    moe = D + D * z["E"] + z["E"] * 3 * D * z["F"] + 3 * D * z["Fs"]
    return dtype_bytes * (z["n_attn"] * attn + z["n_ssm"] * ssm
                          + z["n_moe"] * moe + D * z["V"] + D)


def state_row_bytes(cfg: dict, dtype_bytes: int = 2) -> int:
    """Bytes of one position's K and V over the attention layers."""
    z = _sizes(cfg)
    return 2 * z["n_attn"] * z["Hkv"] * z["hd"] * dtype_bytes


def step_bytes(cfg: dict, contexts: Sequence[int], slots: int,
               dtype_bytes: int = 2) -> int:
    """The least bytes of one decode step over `slots` rows, of which the
    active ones attend `contexts` positions (the new one included): the
    weights once (`weight_bytes`); each SSD layer's f32 state and conv
    window of every row read once and written once; each active row's
    valid K/V prefix read once and each row's new K/V written once; each
    row's embedding read once and its logits written once."""
    z = _sizes(cfg)
    kv_row = state_row_bytes(cfg, dtype_bytes)
    prefix = sum(max(int(c) - 1, 0) for c in contexts) * kv_row
    state = z["n_ssm"] * slots * 4 * (z["H"] * z["N"] * z["P"]
                                      + (z["Kc"] - 1) * z["conv_ch"])
    return (weight_bytes(cfg, dtype_bytes) + 2 * state + prefix
            + slots * kv_row + slots * z["D"] * dtype_bytes
            + slots * z["V"] * dtype_bytes)
