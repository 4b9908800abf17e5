"""Config system: architectures, input shapes, run settings.

Copy of src/repro/configs/base.py, field for field, plus the port-only
fields of `PORT_ONLY_FIELDS` (granite-4.0-h-small's shared expert,
dropless routing, gated SSD norm, µP multipliers, NoPE and norm eps),
whose defaults give the reference's arithmetic: every architecture the
two packages share leaves them at their defaults.  Every architecture
has one `configs/<id>.py` exporting CONFIG with the exact published
dimensions; `registry.py` resolves `--arch <id>` strings and builds
reduced smoke variants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    every: int = 1  # MoE ffn every `every` layers (others dense)
    capacity_factor: float = 1.25
    # port-only: every token keeps all its top_k experts (capacity T);
    # a shared SwiGLU expert of this width (0: none) beside the routed ones
    dropless: bool = False
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    head_dim: int = 64
    d_state: int = 128
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128
    # port-only: Mamba-2's gated RMSNorm of y * silu(z) before out_proj
    gated_norm: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp (plain)
    norm: str = "rms"  # rms | layer
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 500000.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (jamba): period layout; attention at `attn_pos`, SSD elsewhere
    hybrid_period: int = 0
    hybrid_attn_pos: int = 0
    # encdec (whisper)
    n_encoder_layers: int = 0
    # vlm: cross-attention every k-th layer; stubbed image tokens
    cross_attn_every: int = 0
    n_image_tokens: int = 1024
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    max_position: int = 1 << 20
    # port-only (granite-4.0-h-small): the RMS norms' eps, RoPE on or off,
    # the attention's softmax scale (None: 1/sqrt(head_dim)), and the µP
    # multipliers: embeddings times `embed_multiplier`, each sublayer's
    # output times `residual_multiplier` before its residual add, logits
    # over `logits_divisor`
    norm_eps: float = 1e-6
    rope: bool = True
    attn_scale: Optional[float] = None
    embed_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_divisor: float = 1.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (reported in DESIGN/EXPERIMENTS)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd = self.resolved_head_dim
        attn = D * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * D
        if self.act in ("silu", "gelu"):
            ffn_dense = 3 * D * F
        else:
            ffn_dense = 2 * D * F
        total = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            per = (
                D * (2 * s.d_inner + 2 * s.n_groups * s.d_state + s.d_inner // s.head_dim)
                + s.d_inner * D
            )
            return total + L * per
        n_attn_layers = L
        n_ffn = L
        if self.family == "hybrid":
            n_attn_layers = L // self.hybrid_period
            s = self.ssm
            per_ssm = (
                D * (2 * s.d_inner + 2 * s.n_groups * s.d_state + s.d_inner // s.head_dim)
                + s.d_inner * D
            )
            total += (L - n_attn_layers) * per_ssm
        total += n_attn_layers * attn
        if self.moe:
            n_moe = n_ffn // self.moe.every
            total += n_moe * (self.moe.n_experts * 3 * D * F + D * self.moe.n_experts)
            total += n_moe * 3 * D * self.moe.shared_d_ff
            total += (n_ffn - n_moe) * ffn_dense
        else:
            total += n_ffn * ffn_dense
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn + ffn_dense)
        if self.cross_attn_every:
            total += (L // self.cross_attn_every) * attn
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        D, F = self.d_model, self.d_ff
        n_ffn = self.n_layers if self.family != "hybrid" else self.n_layers
        n_moe = n_ffn // self.moe.every
        moe_total = n_moe * self.moe.n_experts * 3 * D * F
        moe_active = n_moe * self.moe.top_k * 3 * D * F
        return full - moe_total + moe_active


# The fields the JAX package's dataclasses lack, by class.
PORT_ONLY_FIELDS = {
    "MoEConfig": ("dropless", "shared_d_ff"),
    "SSMConfig": ("gated_norm",),
    "ModelConfig": ("norm_eps", "rope", "attn_scale", "embed_multiplier",
                    "residual_multiplier", "logits_divisor"),
}


def port_only_changes(cfg) -> list:
    """The port-only fields of `cfg` (and of its `moe` and `ssm`) set away
    from their defaults, as "Class.field"."""
    out = []
    for obj in (cfg, getattr(cfg, "moe", None), getattr(cfg, "ssm", None)):
        if obj is None:
            continue
        name = type(obj).__name__
        defaults = {f.name: f.default for f in dataclasses.fields(obj)}
        out += [f"{name}.{k}" for k in PORT_ONLY_FIELDS.get(name, ())
                if getattr(obj, k) != defaults[k]]
    return out


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def step_fn(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}[
            self.kind
        ]


SHAPES: dict = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# long_500k needs sub-quadratic token mixing -> SSM / hybrid only.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, "full-attention arch: 500k decode is quadratic — skipped (DESIGN.md)"
    return True, ""
