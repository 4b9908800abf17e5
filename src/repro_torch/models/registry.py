"""Model construction from configs (counterpart of
src/repro/models/registry.py).

The reference's `mesh`, `rules`, `model_axis_size` and `cast_before_scan`
shape its XLA program and sharding; the port has no counterpart for them
and takes none.  `remat` (on by default, as the reference's) recomputes
each layer body in the backward pass; `kv_int8` decodes int8 K/V caches
(`io.init_caches(kv_int8=True)`).  It pads the experts as the
reference's `build_model` does with no mesh (`params.MODEL_AXIS`).
`device` is the port's own: the card unless the caller names another.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model

MODEL_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def build_model(cfg: ModelConfig, compute_dtype=None, kv_chunk: int = 2048,
                remat: bool = True, kv_int8: bool = False,
                device=None) -> Model:
    """The `Model` of a config of any family."""
    return Model(cfg, compute_dtype=compute_dtype or torch.bfloat16,
                 kv_chunk=kv_chunk, device=device, remat=remat,
                 kv_int8=kv_int8)
