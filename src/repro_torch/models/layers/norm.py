"""Normalization layers (fp32 statistics, input-dtype outputs).

Counterpart of src/repro/models/layers/norm.py: the scale is applied as
``1 + scale`` and the inverse root as ``reciprocal(sqrt(.))``, not
``rsqrt``, as the reference rounds them.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * scale.float() + bias.float()).to(x.dtype)
