"""Rotary position embeddings (half-rotation layout, LLaMA convention).

Counterpart of src/repro/models/layers/rope.py: f32 frequencies, the
positions cast to f32, the two halves of the head split (not interleaved).
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(
    x: torch.Tensor,  # (..., S, H, head_dim)
    positions: torch.Tensor,  # (..., S) int32 absolute positions
    theta: float = 10000.0,
) -> torch.Tensor:
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs  # (...,S,1,hd/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
