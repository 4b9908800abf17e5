"""llama-3.2-vision-11b [vlm] — cross-attention image layers; frontend STUBBED.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Cross-attention layers every 5th layer (8 total) attend to stubbed patch
embeddings (input_specs() provides (B, n_image_tokens, d_model)); the ViT
tower is out of scope per the pool instructions (backbone only).

Copy of src/repro/configs/llama3_2_vision_11b.py.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    act="silu",
    norm="rms",
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1024,
)
