"""Plain float32 reference of a dense decoder (the llama architecture that
granite-8b follows), in plain PyTorch: token embedding; per layer an RMS
norm (x / sqrt(mean(x^2) + eps) * (1 + scale)), grouped-query attention
with rotary embeddings (half-rotation layout, theta from the
configuration) and a causal softmax over q.k / sqrt(head_dim), and an RMS
norm with a SwiGLU MLP (silu(x W_gate) * (x W_up) W_down), each added to
the residual; a final RMS norm and the unembedding.

It imports nothing of the program.  It takes the weights the benchmark
made (the same tensors the program serves, in their bf16 values) and
computes in float32 with TF32 off, layer by layer over whole sequences, so
only one layer's float32 weights are on the card at a time.

`quantize` gives the control: every matrix rounded to float8 (e4m3) with a
scale per output column, the step below bf16 that would tempt a server.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch

MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def quantize_fp8(w: torch.Tensor) -> torch.Tensor:
    """w (in, out) rounded to float8 e4m3 with an absmax scale per output
    column, returned in float32."""
    w = w.float()
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale.float())


def rope(x, theta: float):
    """x (L, H, hd) at positions 0..L-1, halves rotated (not
    interleaved)."""
    L, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v):
    """Causal GQA: q (L, Hq, hd), k and v (L, Hkv, hd); query head h reads
    KV head h // (Hq / Hkv)."""
    L, Hq, hd = q.shape
    G = Hq // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)


def layer_weights(params: Dict, i: int,
                  transform: Optional[Callable] = None) -> Dict:
    """Layer i's weights in float32 (through `transform` for matrices)."""
    out = {}
    for group in ("attn", "mlp"):
        for k, w in params[group].items():
            x = w[i]
            if transform is not None and k in MATRICES:
                out[f"{group}/{k}"] = transform(x)
            else:
                out[f"{group}/{k}"] = x.float()
    return out


def forward(cfg: dict, params: Dict, sequences: List[torch.Tensor],
            transform: Optional[Callable] = None) -> List[torch.Tensor]:
    """Float32 logits (L, V) of each token sequence, every position
    attending to itself and the positions before it."""
    D, hd = cfg["d_model"], cfg["head_dim"]
    Hq, Hkv, eps = cfg["n_heads"], cfg["n_kv_heads"], cfg["norm_eps"]
    theta = cfg["rope_theta"]
    with no_tf32(), torch.no_grad():
        xs = [params["embed"][s.long()].float() for s in sequences]
        for i in range(cfg["n_layers"]):
            w = layer_weights(params, i, transform)
            for j, x in enumerate(xs):
                L = x.shape[0]
                h = rms_norm(x, w["attn/norm"], eps)
                q = rope((h @ w["attn/wq"]).view(L, Hq, hd), theta)
                k = rope((h @ w["attn/wk"]).view(L, Hkv, hd), theta)
                v = (h @ w["attn/wv"]).view(L, Hkv, hd)
                x = x + attention(q, k, v).reshape(L, Hq * hd) @ w["attn/wo"]
                h = rms_norm(x, w["mlp/norm"], eps)
                g = h @ w["mlp/w_gate"]
                x = x + (torch.nn.functional.silu(g) * (h @ w["mlp/w_up"])) \
                    @ w["mlp/w_down"]
                xs[j] = x
            del w
        head = params["head"] if "head" in params else params["embed"].t()
        head = transform(head) if transform is not None else head.float()
        fn = params["final_norm"]
        return [rms_norm(x, fn, eps) @ head for x in xs]

