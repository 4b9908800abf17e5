"""Model construction from configs (counterpart of
src/repro/models/registry.py).

`mesh` and `rules` place the model on a `Mesh` (ZeRO-3 + tensor
parallelism, `models.model`); `model_axis_size` defaults to the mesh's
model axis (1 with no mesh), which pads the experts as the reference's
`build_model` does.  The reference's `cast_before_scan` shapes its XLA
program and has no counterpart.  `remat` (on by default, as the
reference's) recomputes each layer body in the backward pass; `kv_int8`
decodes int8 K/V caches (`io.init_caches(kv_int8=True)`).  `device` is
the port's own: the card unless the caller names another (on a mesh, the
mesh's device).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model

MODEL_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


def build_model(cfg: ModelConfig, mesh=None, compute_dtype=None,
                kv_chunk: int = 2048, remat: bool = True,
                model_axis_size: Optional[int] = None, rules=None,
                kv_int8: bool = False, device=None, obs=None) -> Model:
    """The `Model` of a config of any family; `obs` is the observability
    bundle whose tracer records its decode steps."""
    if model_axis_size is None:
        model_axis_size = mesh.shape.get("model", 1) if mesh is not None \
            else 1
    return Model(cfg, compute_dtype=compute_dtype or torch.bfloat16,
                 kv_chunk=kv_chunk, device=device, remat=remat,
                 kv_int8=kv_int8, mesh=mesh, rules=rules,
                 model_axis_size=max(model_axis_size, 1), obs=obs)
