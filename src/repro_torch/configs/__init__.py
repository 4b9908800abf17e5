"""Model configurations of the port: a copy of src/repro/configs (data
only; the port imports nothing of the JAX package)."""

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES  # noqa: F401
from repro_torch.configs.registry import get_config, list_configs, reduced_config  # noqa: F401
