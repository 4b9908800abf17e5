"""--arch <id> resolution + reduced smoke-test variants (copy of
src/repro/configs/registry.py).  `list_configs` names the architectures
the JAX package shares; `port_only_configs` those only the port has,
which `get_config` and `reduced_config` resolve alike."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_ARCH_MODULES: Dict[str, str] = {
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "llama-3.2-vision-11b": "repro_torch.configs.llama3_2_vision_11b",
}
_PORT_ONLY_MODULES: Dict[str, str] = {
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
}


def list_configs():
    return sorted(_ARCH_MODULES)


def port_only_configs():
    return sorted(_PORT_ONLY_MODULES)


def get_config(arch: str) -> ModelConfig:
    module = _ARCH_MODULES.get(arch) or _PORT_ONLY_MODULES.get(arch)
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{list_configs() + port_only_configs()}")
    return importlib.import_module(module).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: few layers, narrow
    width, small vocab/experts — preserves every structural property
    (GQA ratios, MoE routing, hybrid period, enc-dec, cross-attn)."""
    cfg = get_config(arch)
    updates = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, cfg.hybrid_period or 4),
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads > 1 else 1,
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab=1024,
        n_image_tokens=32 if cfg.cross_attn_every else 1024,
        max_position=65536,
    )
    if cfg.family == "encdec":
        updates["n_encoder_layers"] = 2
        updates["n_layers"] = 2
    if cfg.cross_attn_every:
        updates["n_layers"] = 2 * cfg.cross_attn_every  # keep 2 cross layers
    if cfg.moe:
        updates["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), every=cfg.moe.every,
            capacity_factor=2.0, dropless=cfg.moe.dropless,
            shared_d_ff=256 if cfg.moe.shared_d_ff else 0,
        )
    if cfg.ssm:
        updates["ssm"] = SSMConfig(
            d_inner=512, head_dim=64, d_state=16, n_groups=2, chunk=32,
            gated_norm=cfg.ssm.gated_norm,
        )
    if cfg.family == "hybrid":
        updates["n_layers"] = cfg.hybrid_period
    return dataclasses.replace(cfg, **updates)
