"""The dense model path of the port (counterpart of src/repro/models): the
attention, MLP, norm and RoPE layers, parameter init, KV caches, `Model`
(prefill and decode) and `build_model`."""

from repro_torch.models.registry import (  # noqa: F401
    MODEL_FAMILIES, build_model)
