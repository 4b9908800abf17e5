"""The dense decoder family (the llama architecture granite-8b follows), as
`systems/serve.py` takes it: the program's `ModelConfig` and the weights
from the configuration's sizes, the float32 reference and its float8
control (`portbench.ref.dense`), the FLOPs and least bytes of a decode
step (`portbench.costs`), and the program's attention call, which the
traced windows label.  The limit of the served-token check is the
configuration's own (`logit_gap_limit`), set from its readings.
"""

from __future__ import annotations

import math

from portbench import costs
from portbench.ref import dense as RD

# (module, attribute) of every layer's attention call, which the traced
# windows label `serve.attention`.
ATTENTION = ("repro_torch.models.model", "attend_chunked")

forward = RD.forward
control_transform = RD.quantize_fp8
token_flops = costs.dense_token_flops
step_bytes = costs.dense_step_bytes
state_row_bytes = costs.kv_row_bytes


def model_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=cfg["arch"], family=cfg["family"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"],
        n_kv_heads=cfg["n_kv_heads"], d_ff=cfg["d_ff"], vocab=cfg["vocab"],
        head_dim=cfg["head_dim"], act=cfg["act"], norm=cfg["norm"],
        rope_theta=cfg["rope_theta"], tie_embeddings=cfg["tie_embeddings"])


def make_weights(cfg: dict, seed: int, device, dtype=None):
    """The dense decoder's weights, layer-stacked, from one generator on
    `device`: N(0, s^2) with s = init_std for the projections
    (init_std / sqrt(2 L) for wo and w_down), 1 / sqrt(D) for the
    embedding and the unembedding, norm_init_std for the norm scales."""
    import torch

    dtype = dtype or getattr(torch, cfg["dtype"])
    g = torch.Generator(device=device).manual_seed(seed % 2**63)
    D, L, V = cfg["d_model"], cfg["n_layers"], cfg["vocab"]
    hd, F = cfg["head_dim"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    s, sn = cfg["init_std"], cfg["norm_init_std"]
    so = s / math.sqrt(2 * L)
    se = 1.0 / math.sqrt(D)

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    params = {
        "embed": draw((V, D), se),
        "final_norm": draw((D,), sn),
        "attn": {"norm": draw((L, D), sn), "wq": draw((L, D, q), s),
                 "wk": draw((L, D, kv), s), "wv": draw((L, D, kv), s),
                 "wo": draw((L, q, D), so)},
        "mlp": {"norm": draw((L, D), sn), "w_gate": draw((L, D, F), s),
                "w_up": draw((L, D, F), s), "w_down": draw((L, F, D), so)},
    }
    if not cfg["tie_embeddings"]:
        params["head"] = draw((D, V), se)
    return params
