"""Gated MLPs (SwiGLU / GeGLU) and the plain GELU MLP (whisper).

Counterpart of src/repro/models/layers/mlp.py; GELU is the tanh
approximation, as the reference's ``approximate=True``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as XLA rounds it: ``x * (1 / (1 + exp(-x)))``, each op
    rounded to the input dtype (bit-equal in bf16, where `F.silu` rounds
    once).  Every silu of the port is this one."""
    return x * (1 / (1 + torch.exp(-x)))


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
        h = F.gelu(g, approximate="tanh") * u
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
    h = F.gelu(x @ w_in + b_in, approximate="tanh")
    return h @ w_out + b_out
