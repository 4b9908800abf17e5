"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536  [arXiv:2403.19887; hf]

Layout: period-8 superblocks (9 of them), attention at in-block position 4,
SSD elsewhere; MoE FFN every 2nd layer (odd positions), dense FFN otherwise
— the Jamba paper's a=1/m=8, e=2 configuration.  Jamba's Mamba layers are
Mamba-1; implemented with the SSD layer (DESIGN.md hardware-adaptation note).

Copy of src/repro/configs/jamba_1_5_large_398b.py.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    act="silu",
    norm="rms",
    rope_theta=10000.0,  # Jamba attention layers use no RoPE in-paper; kept
    moe=MoEConfig(n_experts=16, top_k=2, every=2),
    ssm=SSMConfig(d_inner=16384, head_dim=64, d_state=16, n_groups=8, chunk=128),
    hybrid_period=8,
    hybrid_attn_pos=4,
)
