"""Per-architecture parallelism policy.

Counterpart of src/repro/distributed/policy.py (`tp_starved`,
`replicated_block_rules`, `apply_policy`): pure functions of the config
and the mesh's shape.  When a model's feature dims are too small for the
model axis (d_model / model_axis under 128) and its block weights are tiny
anyway (at most 512 MiB replicated in bf16), the block weights are
replicated over 'model' and the idle model axis joins the batch group of
every activation spec; the padded-vocab embedding and unembedding keep
vocab@model.  The ssm and hybrid families (SSD head sharding) and MoE
(expert parallelism) keep the model axis.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.mesh import AXIS_DATA, AXIS_MODEL
from repro_torch.distributed.sharding import P, ShardingRules, _keep, _map_fields

# Fields that stop being model-sharded under the replicated policy.
_BLOCK_PARAM_FIELDS = (
    "wq", "wkv", "wo", "qkv_bias", "w_in", "w_out",
    "ssm_in", "ssm_out", "ssm_small", "conv_kernel",
)
_WIDENED_ACT_FIELDS = ("act_btd", "act_seq", "act_ffn", "tokens")


def tp_starved(cfg: ModelConfig, model_axis: int) -> bool:
    """True when a device's tensor-parallel tile is under 128 lanes AND the
    replicated block weights stay tiny."""
    if cfg.family in ("ssm", "hybrid"):
        return False  # SSD head sharding wants the model axis
    if cfg.moe is not None:
        return False  # expert parallelism owns the model axis
    if cfg.d_model / model_axis >= 128:
        return False
    hd = cfg.resolved_head_dim
    per_layer = (
        cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
        + cfg.n_heads * hd * cfg.d_model
        + 3 * cfg.d_model * cfg.d_ff
    )
    total = per_layer * (cfg.n_layers + cfg.n_encoder_layers) * 2  # bytes
    return total <= 512 * 2**20


def replicated_block_rules(rules: ShardingRules) -> ShardingRules:
    """Drop 'model' from the block parameter specs and widen the batch group
    of the activation specs to ('pod', 'data', 'model')."""

    def drop_model(spec: P) -> P:
        return P(*(_keep(e, lambda a: a != AXIS_MODEL) for e in spec))

    def widen_batch(spec: P) -> P:
        out = []
        for e in spec:
            if isinstance(e, tuple) and AXIS_DATA in e:
                out.append(tuple(e) + (AXIS_MODEL,))
            elif e == AXIS_DATA:
                out.append((AXIS_DATA, AXIS_MODEL))
            elif e == AXIS_MODEL:
                out.append(None)  # the model entry moves to the batch group
            else:
                out.append(e)
        return P(*out)

    rules = _map_fields(rules, drop_model, _BLOCK_PARAM_FIELDS)
    return _map_fields(rules, widen_batch, _WIDENED_ACT_FIELDS)


def apply_policy(cfg: ModelConfig, mesh, rules: ShardingRules,
                 global_batch: int | None = None) -> ShardingRules:
    model_axis = mesh.shape.get(AXIS_MODEL, 1)
    n_dev = 1
    for v in mesh.shape.values():
        n_dev *= v
    if global_batch is not None and global_batch % n_dev != 0:
        return rules  # the widened batch group would not divide
    if tp_starved(cfg, model_axis):
        return replicated_block_rules(rules)
    return rules
