"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Copy of src/repro/configs/granite_moe_1b_a400m.py.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    act="silu",
    norm="rms",
    rope_theta=10000.0,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=32, top_k=8, every=1),
)
