"""whisper-base [audio] — encoder-decoder; conv frontend STUBBED.

6L (decoder; +6L encoder) d_model=512 8H (kv=8) d_ff=2048 vocab=51865
[arXiv:2212.04356; unverified]

The conv1d x2 audio stem is a stub per the pool instructions: input_specs()
provides precomputed frame embeddings (B, S, 512) for the encoder; shape
cells size the encoder sequence = the cell's seq_len.

Copy of src/repro/configs/whisper_base.py.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,  # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    act="gelu_mlp",  # plain GELU MLP with biases
    norm="layer",
    qkv_bias=True,
    rope_theta=10000.0,  # whisper uses learned/sinusoidal pos; RoPE stands in
    tie_embeddings=True,
)
