"""Gated MLPs (SwiGLU / GeGLU) and the plain GELU MLP (whisper).

Counterpart of src/repro/models/layers/mlp.py; GELU is the tanh
approximation, as the reference's ``approximate=True``.  Both activations
are written op by op, rounded as XLA rounds them (`silu`, `gelu`).
"""

from __future__ import annotations

import math

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as XLA rounds it: ``x * (1 / (1 + exp(-x)))``, each op
    rounded to the input dtype (bit-equal in bf16, where `F.silu` rounds
    once).  Every silu of the port is this one."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(approximate=True)` as XLA rounds it: ``x * (0.5 * (1 +
    tanh(c * (x + k * x^3))))``, each op rounded to the input dtype and the
    constants ``c = sqrt(2 / pi)`` and ``k = 0.044715`` rounded to it first
    (the reference's weakly typed scalars; PyTorch would multiply by the
    f32 value).  Bit-equal in bf16, where `F.gelu` rounds once.  Every
    gelu of the port is this one."""
    c = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    k = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * (0.5 * (1 + torch.tanh(c * (x + k * (x * x * x)))))


def gated_mlp(
    x: torch.Tensor,  # (B, S, D)
    w_gate: torch.Tensor,  # (D, F)
    w_up: torch.Tensor,  # (D, F)
    w_down: torch.Tensor,  # (F, D)
    act: str = "silu",
) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    if act == "silu":
        h = silu(g) * u
    elif act == "gelu":  # GeGLU (gemma)
        h = gelu(g) * u
    else:
        raise ValueError(act)
    return h @ w_down


def dense_mlp(
    x: torch.Tensor,
    w_in: torch.Tensor,  # (D, F)
    b_in: torch.Tensor,  # (F,)
    w_out: torch.Tensor,  # (F, D)
    b_out: torch.Tensor,  # (D,)
) -> torch.Tensor:
    h = gelu(x @ w_in + b_in)
    return h @ w_out + b_out
