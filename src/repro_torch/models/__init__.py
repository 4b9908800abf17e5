"""The model path of the port (counterpart of src/repro/models): the
attention, MLP, MoE, SSD, norm and RoPE layers, parameter init, caches,
`Model` (prefill and decode of the dense, MoE, SSM and hybrid families)
and `build_model`."""

from repro_torch.models.registry import (  # noqa: F401
    MODEL_FAMILIES, build_model)
