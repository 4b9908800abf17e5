"""Plain float32 reference of granite-4.0-h-small (IBM Granite 4.0-H,
`model_type` granitemoehybrid), in plain PyTorch, from the published
description and the configuration's keys (the model's own config.json
names):

  x = embed[tokens] * embedding_multiplier
  per layer, of the kind `layer_types` gives:
    x = x + mixer(rms_norm(x)) * residual_multiplier
        mixer: "attention": grouped-query attention with no position
               embedding ("nope"), causal softmax of q.k * attention_
               multiplier; "mamba": Mamba-2 (below)
    h = rms_norm(x)
    x = x + (routed(h) + shared(h)) * residual_multiplier
        routed: the softmax over each token's top `num_experts_per_tok`
                router logits weights the SwiGLU experts it picked, every
                assignment kept (no capacity at all)
        shared: a SwiGLU expert of `shared_intermediate_size`
  logits = rms_norm(x) @ embed^T / logits_scaling

Mamba-2: in_proj gives [z, xBC, dt]; a causal depthwise conv of
`mamba_d_conv` taps with bias over xBC, then silu, gives x (heads of
`mamba_d_head`), B and C (`mamba_n_groups` groups of `mamba_d_state`);
dt = softplus(dt + dt_bias), A = -exp(A_log); the state of each head runs
the sequential recurrence h <- h * exp(dt A) + dt B x^T from zero, and
y = C.h + D x; the gated RMSNorm takes y * silu(z), normalizes each of the
n_groups groups of channels with eps, scales it, and out_proj follows.

It imports nothing of the program.  It takes the weights the benchmark
made (the same tensors the program serves, in their bf16 values, stored
layer-stacked as the program's tree: `attn` by attention layer, `ssm` and
`moe` by superblock and position, which flattened are layer order) and
computes in float32 with TF32 off, layer by layer over whole sequences, so
only one layer's float32 weights are on the card at a time.  The tokens of
all sequences go through the matrices together; attention runs a sequence
at a time; the recurrence steps the sequences together, longest first, a
position at a time, each over the sequences that long.

Departures from the published model, none of which changes what is
computed from the stored numbers: every norm's scale is stored as its
offset from one (``x_hat * (1 + scale)``, the program's form); the SSD
state and every product are float32.

`quantize_fp8` gives the control: every matrix (attention, in_proj and
out_proj, router, experts, shared expert, the tied embedding as the
unembedding) rounded to float8 (e4m3) with a scale per output column; the
conv's taps and the norms' scales stay.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from portbench.ref.dense import no_tf32, rms_norm

MATRICES = ("wq", "wk", "wv", "wo", "in_proj", "out_proj", "router",
            "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")


def quantize_fp8(w: torch.Tensor) -> torch.Tensor:
    """w (..., in, out) rounded to float8 e4m3 with an absmax scale per
    output column (and leading index), returned in float32."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def silu(x):
    return x * torch.sigmoid(x)


def swiglu(h, w_gate, w_up, w_down):
    return (silu(h @ w_gate) * (h @ w_up)) @ w_down


def layer_kinds(cfg: dict) -> List[str]:
    return list(cfg["layer_types"][:cfg["num_hidden_layers"]])


def _weights(group: Dict, i: int, transform) -> Dict:
    """Layer i (in layer order) of a stacked group in float32, matrices
    through `transform`: attention's leaves are stacked by layer, the SSD's
    and the MoE's by superblock and position."""
    out = {}
    for k, w in group.items():
        x = w[i] if "wq" in group else w.flatten(0, 1)[i]
        out[k] = transform(x) if transform is not None and k in MATRICES \
            else x.float()
    return out


def attention(cfg, w, h, starts, lengths):
    """Causal NoPE GQA of each sequence's rows of h."""
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // Hq
    q = (h @ w["wq"]).view(-1, Hq, hd)
    k = (h @ w["wk"]).view(-1, Hkv, hd).repeat_interleave(Hq // Hkv, dim=1)
    v = (h @ w["wv"]).view(-1, Hkv, hd).repeat_interleave(Hq // Hkv, dim=1)
    out = torch.empty_like(q)
    for s, n in zip(starts, lengths):
        sl = slice(s, s + n)
        sc = torch.einsum("qhd,khd->hqk", q[sl], k[sl]) \
            * cfg["attention_multiplier"]
        mask = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()
        sc = sc.masked_fill(~mask, float("-inf"))
        out[sl] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1), v[sl])
    return out.reshape(h.shape[0], Hq * hd) @ w["wo"]


def mamba(cfg, w, h, starts, lengths, pos):
    """Mamba-2 over each sequence's rows of h, from a zero state."""
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N, G, Kc = cfg["mamba_d_state"], cfg["mamba_n_groups"], \
        cfg["mamba_d_conv"]
    di = H * P
    zxbcdt = h @ w["in_proj"]
    z, xbc = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * G * N]
    dt = zxbcdt[:, 2 * di + 2 * G * N:]
    # causal depthwise conv: tap j reads the row j positions back
    conv = xbc * w["conv_w"][Kc - 1] + w["conv_b"]
    for j in range(1, Kc):
        back = torch.zeros_like(xbc)
        back[j:] = xbc[:-j]
        conv = conv + torch.where((pos >= j)[:, None], back, 0.0) \
            * w["conv_w"][Kc - 1 - j]
    xbc = silu(conv)
    x = xbc[:, :di].view(-1, H, P)
    Bm = xbc[:, di:di + G * N].view(-1, G, N).repeat_interleave(H // G, 1)
    Cm = xbc[:, di + G * N:].view(-1, G, N).repeat_interleave(H // G, 1)
    dt = torch.logaddexp(dt + w["dt_bias"], torch.zeros_like(dt))
    A = -torch.exp(w["A_log"])
    y = torch.empty_like(x)
    order = sorted(range(len(lengths)), key=lambda j: -lengths[j])
    first = torch.tensor([starts[j] for j in order], device=h.device)
    longest = [lengths[j] for j in order]
    state = torch.zeros(len(order), H, N, P, device=h.device)
    for t in range(longest[0] if longest else 0):
        n = sum(1 for m in longest if m > t)
        rows = first[:n] + t
        dtr = dt[rows]
        state[:n] = state[:n] * torch.exp(dtr * A)[:, :, None, None] \
            + (dtr[:, :, None] * Bm[rows])[..., None] * x[rows][:, :, None]
        y[rows] = torch.einsum("bhn,bhnp->bhp", Cm[rows], state[:n]) \
            + w["D"][:, None] * x[rows]
    g = y.reshape(-1, di) * silu(z)
    gs = g.view(-1, G, di // G)
    gs = gs * torch.rsqrt(torch.mean(gs * gs, -1, keepdim=True)
                          + cfg["rms_norm_eps"])
    g = gs.reshape(-1, di) * (1.0 + w["out_norm"])
    return g @ w["out_proj"]


def experts(cfg, w, h):
    """The routed experts, every assignment kept, plus the shared one."""
    K = cfg["num_experts_per_tok"]
    logits = h @ w["router"]
    top, sel = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(top[:, :K], dim=-1)
    sel = sel[:, :K]
    out = swiglu(h, w["s_gate"], w["s_up"], w["s_down"])
    for e in range(w["e_gate"].shape[0]):
        rows, slot = (sel == e).nonzero(as_tuple=True)
        if rows.numel():
            ye = swiglu(h[rows], w["e_gate"][e], w["e_up"][e],
                        w["e_down"][e])
            out.index_add_(0, rows, ye * gates[rows, slot][:, None])
    return out


def forward(cfg: dict, params: Dict, sequences: List[torch.Tensor],
            transform: Optional[Callable] = None) -> List[torch.Tensor]:
    """Float32 logits (L, V) of each token sequence, every position
    attending to itself and the positions before it."""
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    dev = params["embed"].device
    lengths = [int(s.numel()) for s in sequences]
    starts = [sum(lengths[:j]) for j in range(len(lengths))]
    pos = torch.cat([torch.arange(n, device=dev) for n in lengths])
    tokens = torch.cat([s.reshape(-1).long() for s in sequences])
    counts = {"attention": 0, "mamba": 0}
    with no_tf32(), torch.no_grad():
        x = params["embed"][tokens].float() * cfg["embedding_multiplier"]
        for i, kind in enumerate(layer_kinds(cfg)):
            j = counts[kind]
            counts[kind] += 1
            if kind == "attention":
                w = _weights(params["attn"], j, transform)
                y = attention(cfg, w, rms_norm(x, w["norm"], eps), starts,
                              lengths)
            else:
                w = _weights(params["ssm"], j, transform)
                y = mamba(cfg, w, rms_norm(x, w["norm"], eps), starts,
                          lengths, pos)
            x = x + y * r
            del w
            w = _weights(params["moe"], i, transform)
            x = x + experts(cfg, w, rms_norm(x, w["norm"], eps)) * r
            del w
        head = params["embed"].t()
        head = transform(head) if transform is not None else head.float()
        logits = rms_norm(x, params["final_norm"], eps) @ head \
            / cfg["logits_scaling"]
        return list(logits.split(lengths))
