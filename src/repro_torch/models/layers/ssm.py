"""Mamba-2 SSD (state-space duality) block: the chunked scan.

Counterpart of src/repro/models/layers/ssm.py (`SSMDims`, `SSMState`,
`_causal_conv`, `_split_proj`, `ssd_forward`, `ssd_decode_step`), with the
reference's arithmetic and dtypes: the chunk einsums run in the input
dtype, the decays, `dA`, its within-chunk cumsum and the state `h` stay
f32, the conv tail is f32, and in decode the conv window (the f32 state
beside the new input) is f32.  `jax.nn.softplus` is ``logaddexp(x, 0)``
(not `F.softplus`, which returns x above its threshold), `jnp.repeat`
over groups is `repeat_interleave`, and the inter-chunk `lax.scan` is a
Python loop over the chunks.

The two three-operand einsums contract in the order XLA's einsum takes
(opt_einsum's "auto" path): the chunk states weight `xs` first and then
contract over the chunk; the inter-chunk output weights `C` first when
N < P, and otherwise contracts over N first and weights the result.
Each pairwise step rounds to the input dtype, so in bf16 the order is
part of the result.

The reference's head-axis sharding callback (`cstr`) pins the chunk
tensors' heads to the model axis for XLA.  The port shards the SSD by
heads explicitly (`Model._ssm_params`): each model rank calls
`ssd_forward` and `ssd_decode_step` with its heads' columns of `in_proj`
and of the conv, its heads' `A_log`, `dt_bias` and `D` and `SSMDims` of
its heads and their B/C groups, which is the same per-head arithmetic.

Port-only (`SSMDims.gated_norm`, granite-4.0-h-small): Mamba-2's gated
RMSNorm replaces the output gate ``y * silu(z)`` before `out_proj`, in
both the chunked forward and the decode step (`gated_norm`): y * silu(z)
in f32, normalized over each of the `n_groups` groups of d_inner /
n_groups channels with `norm_eps`, times ``1 + out_norm`` (the port's
norm form), under a ``model.ssm.norm`` span of the `obs` given.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.mlp import silu
from repro_torch.obs import NULL


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int  # = expand * d_model
    head_dim: int  # P
    d_state: int  # N
    n_groups: int  # G (B/C shared across heads within a group)
    d_conv: int = 4
    chunk: int = 128
    gated_norm: bool = False  # port-only (module docstring)
    norm_eps: float = 1e-6

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_out(self) -> int:
        # [z, x, B, C, dt]
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


class SSMState(NamedTuple):
    h: torch.Tensor  # (B, H, N, P) recurrent state
    conv: torch.Tensor  # (B, K-1, conv_channels) conv tail


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0), with no linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _clip(x: torch.Tensor) -> torch.Tensor:
    """`jnp.clip(x, -60, 0)`, the exponent bound of the segment sums, as
    ``minimum(maximum(x, -60), 0)``: where x sits on a bound (the diagonal's
    exact 0), both halves of a tie take half the gradient, as in the
    reference; `torch.clamp` would pass all of it.  Values are the same."""
    return torch.minimum(torch.maximum(x, x.new_tensor(-60.0)),
                         x.new_tensor(0.0))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via K shifted multiply-adds.  x: (B, S, C),
    w: (K, C), b: (C,)."""
    K = w.shape[0]
    out = x * w[-1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1], :]
        out = out + shifted * w[K - 1 - i]
    return silu(out + b)


def _split_proj(zxbcdt: torch.Tensor, dims: SSMDims):
    d = dims.d_inner
    z = zxbcdt[..., :d]
    xbc = zxbcdt[..., d : d + dims.conv_channels]
    dt = zxbcdt[..., d + dims.conv_channels :]  # (..., H)
    return z, xbc, dt


def gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               dims: SSMDims) -> torch.Tensor:
    """Mamba-2's gated RMSNorm of y (..., d_inner) by the gate z, in f32
    (module docstring)."""
    g = y.float() * silu(z.float())
    gs = g.reshape(*g.shape[:-1], dims.n_groups, -1)
    var = torch.mean(gs * gs, dim=-1, keepdim=True)
    gs = gs * torch.reciprocal(torch.sqrt(var + dims.norm_eps))
    return gs.reshape(g.shape) * (1.0 + scale.float())


def _gate(y, z, params, dims: SSMDims, obs):
    """The output gate: ``y * silu(z)`` (f32), or the gated norm."""
    if not dims.gated_norm:
        return y * silu(z.float())
    with obs.tracer.span("model.ssm.norm", "model"):
        return gated_norm(y, z, params["out_norm"], dims)


def ssd_forward(
    x_in: torch.Tensor,  # (B, S, D)
    params: dict,
    dims: SSMDims,
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P) initial state
    obs=NULL,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence SSD.  Returns (y (B, S, D), final_state (B, H, N, P)
    f32, conv_tail (B, K-1, conv_channels) f32): the tail feeds decode."""
    B, S, D = x_in.shape
    H, P, N, G = dims.n_heads, dims.head_dim, dims.d_state, dims.n_groups
    Q = dims.chunk
    assert S % Q == 0, (S, Q)
    NC = S // Q
    ed = x_in.dtype
    f32 = torch.float32

    zxbcdt = x_in @ params["in_proj"]  # (B, S, in_proj_out)
    z, xbc, dt = _split_proj(zxbcdt, dims)
    conv_tail = xbc[:, S - (dims.d_conv - 1):, :].to(f32)
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., : dims.d_inner].reshape(B, S, H, P)
    Bm = xbc[..., dims.d_inner : dims.d_inner + G * N].reshape(B, S, G, N)
    Cm = xbc[..., dims.d_inner + G * N :].reshape(B, S, G, N)

    A = -torch.exp(params["A_log"].to(f32))  # (H,) negative
    dt = softplus(dt.to(f32) + params["dt_bias"])  # (B, S, H)

    # -- chunk views ---------------------------------------------------------
    xs_c = xs.reshape(B, NC, Q, H, P).to(ed)
    B_c = Bm.reshape(B, NC, Q, G, N).to(ed)
    C_c = Cm.reshape(B, NC, Q, G, N).to(ed)
    dt_c = dt.reshape(B, NC, Q, H)
    dA = dt_c * A  # (B, NC, Q, H)
    dA_cum = torch.cumsum(dA, dim=2)  # within-chunk

    hpg = H // G  # heads per B/C group

    # Intra-chunk: scores[i,j] = C_i·B_j * exp(Acum_i - Acum_j) * dt_j, j <= i
    CB = torch.einsum("bcqgn,bckgn->bcgqk", C_c, B_c)  # (B, NC, G, Q, Q)
    CB = CB.repeat_interleave(hpg, dim=2)  # (B, NC, H, Q, Q)
    seg = dA_cum.transpose(2, 3)  # (B, NC, H, Q)
    L = torch.exp(_clip(seg[..., :, None] - seg[..., None, :]))
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x_in.device))
    scores = (torch.where(causal, CB.to(f32) * L, torch.zeros_like(L))
              * dt_c.transpose(2, 3)[..., None, :])
    scores = scores.to(ed)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores, xs_c)

    # Chunk states: S_c = sum_j exp(Acum_Q - Acum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(_clip(dA_cum[:, :, -1:, :] - dA_cum))  # (B, NC, Q, H)
    wgt = (decay_to_end * dt_c).to(ed)
    B_h = B_c.repeat_interleave(hpg, dim=3)  # (B, NC, Q, H, N)
    chunk_state = torch.einsum("bcqhn,bcqhp->bchnp", B_h,
                               xs_c * wgt[..., None]).to(f32)  # (B,NC,H,N,P)

    # Inter-chunk recurrence over NC chunks.
    chunk_decay = torch.exp(_clip(dA_cum[:, :, -1, :]))
    h = (h0.to(f32) if h0 is not None
         else torch.zeros((B, H, N, P), dtype=f32, device=x_in.device))
    h_in = []
    for c in range(NC):
        h_in.append(h)  # the state ENTERING chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, NC, H, N, P)

    # Inter-chunk output: y_i += C_i · exp(Acum_i) h_in
    C_h = C_c.repeat_interleave(hpg, dim=3)  # (B, NC, Q, H, N)
    in_decay = torch.exp(_clip(dA_cum)).to(ed)
    if N < P:
        y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                               C_h * in_decay[..., None], h_in.to(ed))
    else:
        y_inter = (torch.einsum("bcqhn,bchnp->bcqhp", C_h, h_in.to(ed))
                   * in_decay[..., None])

    y = (y_intra.to(f32) + y_inter.to(f32)).reshape(B, S, H, P)
    y = y + params["D"].to(f32)[None, None, :, None] * xs.to(f32)
    y = y.reshape(B, S, dims.d_inner)
    y = _gate(y, z, params, dims, obs)
    return y.to(x_in.dtype) @ params["out_proj"], h, conv_tail


def ssd_decode_step(
    x_in: torch.Tensor,  # (B, 1, D)
    state: SSMState,
    params: dict,
    dims: SSMDims,
    obs=NULL,
) -> Tuple[torch.Tensor, SSMState]:
    """One-token recurrent update."""
    B = x_in.shape[0]
    H, P, N, G = dims.n_heads, dims.head_dim, dims.d_state, dims.n_groups

    zxbcdt = x_in[:, 0, :] @ params["in_proj"]  # (B, F)
    z, xbc, dt = _split_proj(zxbcdt, dims)

    # Conv tail update: window = [conv_state, xbc], promoted as the
    # reference's concatenate promotes it
    wdt = torch.promote_types(state.conv.dtype, xbc.dtype)
    window = torch.cat([state.conv.to(wdt), xbc[:, None, :].to(wdt)], dim=1)
    w = params["conv_w"]  # (K, C)
    cdt = torch.promote_types(wdt, w.dtype)
    conv_out = silu(torch.einsum("bkc,kc->bc", window.to(cdt), w.to(cdt))
                      + params["conv_b"])
    new_conv = window[:, 1:, :]

    xs = conv_out[..., : dims.d_inner].reshape(B, H, P)
    Bm = conv_out[..., dims.d_inner : dims.d_inner + G * N].reshape(B, G, N)
    Cm = conv_out[..., dims.d_inner + G * N :].reshape(B, G, N)

    A = -torch.exp(params["A_log"].float())
    dt_v = softplus(dt.float() + params["dt_bias"])  # (B, H)
    decay = torch.exp(dt_v * A)  # (B, H)

    hpg = H // G
    B_h = Bm.repeat_interleave(hpg, dim=1)  # (B, H, N)
    C_h = Cm.repeat_interleave(hpg, dim=1)
    h = state.h * decay[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", B_h * dt_v[..., None], xs.float())
    y = torch.einsum("bhn,bhnp->bhp", C_h, h)
    y = y + params["D"].float()[None, :, None] * xs
    y = _gate(y.reshape(B, dims.d_inner), z, params, dims, obs)
    out = y.to(x_in.dtype) @ params["out_proj"]
    return out[:, None, :], SSMState(h=h, conv=new_conv)
