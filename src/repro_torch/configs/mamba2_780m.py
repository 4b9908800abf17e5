"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 d_ff=0 vocab=50280, ssm_state=128  [arXiv:2405.21060; unverified]

Pure SSD stack: each layer is norm -> SSD -> residual (no attention, no MLP
— d_ff=0 per the pool spec).  d_inner = 2*d_model = 3072, headdim 64.

Copy of src/repro/configs/mamba2_780m.py.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    act="silu",
    norm="rms",
    tie_embeddings=True,
    ssm=SSMConfig(d_inner=3072, head_dim=64, d_state=128, n_groups=1, chunk=256),
)
