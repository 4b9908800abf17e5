"""granite-4.0-h-small [hybrid] — Mamba-2/attention 9:1, MoE 72e top-10 +
a shared expert in every layer.  A port-only architecture: the JAX package
has no counterpart.

40L d_model=4096 32H (GQA kv=8) expert width 768, shared expert 1536,
vocab 100352, tied  [hf:ibm-granite/granite-4.0-h-small config.json,
model_type granitemoehybrid]

Layout: period-10 superblocks (4 of them), NoPE attention at in-block
position 5 (layers 5, 15, 25, 35), Mamba-2 (SSD) elsewhere: 128 heads of
64 (d_inner 8192, expand 2), d_state 128, one group, conv 4 with bias,
chunk 256, the gated RMSNorm before out_proj.  Every layer's FFN is the
dropless top-10 of 72 SwiGLU experts of 768 (`intermediate_size`) plus a
shared SwiGLU expert of 1536 (`shared_intermediate_size`).  µP multipliers:
embeddings x 12, softmax scale 1/128 (`attention_multiplier`), each
sublayer's output x 0.22 before its residual add, logits / 16.  RMSNorm
eps 1e-5.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,  # one routed expert's width
    vocab=100352,
    head_dim=128,
    act="silu",
    norm="rms",
    tie_embeddings=True,
    rope_theta=10000.0,  # published, unused: the attention is NoPE
    moe=MoEConfig(n_experts=72, top_k=10, every=1, dropless=True,
                  shared_d_ff=1536),
    ssm=SSMConfig(d_inner=8192, head_dim=64, d_state=128, n_groups=1,
                  d_conv=4, chunk=256, gated_norm=True),
    hybrid_period=10,
    hybrid_attn_pos=5,
    max_position=131072,
    norm_eps=1e-5,
    rope=False,
    attn_scale=0.0078125,
    embed_multiplier=12.0,
    residual_multiplier=0.22,
    logits_divisor=16.0,
)
