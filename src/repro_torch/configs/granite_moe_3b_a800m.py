"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

40 experts pad to 48 for the 16-wide expert-parallel axis (router pins the
8 pad experts to -inf; DESIGN.md).

Copy of src/repro/configs/granite_moe_3b_a800m.py.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    act="silu",
    norm="rms",
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, every=1),
)
