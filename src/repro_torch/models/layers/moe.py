"""Top-k MoE with capacity-based dispatch.

Counterpart of src/repro/models/layers/moe.py (`MoEDims`, `moe_block`),
step for step: f32 router logits with the pad experts pinned to -1e30,
softmax, top-k and renormalised gates, the Switch aux loss over the real
experts, the capacity ``cap = min(int(max(1, T*K/E*cf)), T)``, k-major
positions-in-expert (slot 0 wins capacity over slot 1, and so on), the
(E, cap, D) expert buffer, three batched expert products and the
per-slot f32 combine.  Overflow drops the assignment.

Where PyTorch's primitives differ from the reference's:

- `jax.lax.top_k` breaks ties toward the lower expert; `torch.topk`
  promises no order, so the top k come from a stable descending sort.
- The reference's buffer write `.at[e_safe, p_safe].set(xt, mode="drop")`
  drops the writes aimed at row E; the port's buffer has a spare row E
  that takes them and is sliced off.
- The reference's combine gathers `out_buf[e_safe, p_safe]`, which clamps
  row E to row E - 1; the port clamps the same way, so a non-finite
  expert output times a zero gate gives the reference's NaN.

`cap` is a Python int from static shapes and nothing here reads the
device, so a decode step stays capturable in a CUDA graph.  The
expert-parallel `moe_block_ep` (`shard_map` over the model axis) waits
for the sharding slice (ROADMAP queue 1 item 8.5).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models.layers.mlp import silu


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int  # real experts
    n_experts_pad: int  # padded to model-axis multiple
    top_k: int
    capacity_factor: float = 1.25


def capacity(T: int, dims: MoEDims) -> int:
    """Slots an expert holds for `T` tokens (the reference's `cap`)."""
    cap = int(max(1, (T * dims.top_k / dims.n_experts_pad)
                  * dims.capacity_factor))
    return min(cap, T)


def route(xt: torch.Tensor, router_w: torch.Tensor, dims: MoEDims):
    """(probs (T, E) f32, gate values (T, K) renormalised, experts (T, K)
    int64): the reference's routing, ties toward the lower expert."""
    E, K = dims.n_experts_pad, dims.top_k
    logits = xt.float() @ router_w.float()
    real = torch.arange(E, device=xt.device) < dims.n_experts
    logits = torch.where(real[None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, sel = vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, sel


def dispatch(sel: torch.Tensor, dims: MoEDims, cap: int):
    """Per top-k slot, (expert row, position, kept): the k-major
    positions-in-expert of the reference, overflow sent to row E."""
    E = dims.n_experts_pad
    base = torch.zeros(E, dtype=torch.int64, device=sel.device)
    slots = []
    for k in range(dims.top_k):
        onehot = one_hot(sel[:, k], E)  # (T, E)
        within = torch.cumsum(onehot, dim=0) - onehot  # exclusive
        pos_k = (within * onehot).sum(1) + base[sel[:, k]]
        base = base + onehot.sum(0)
        keep = pos_k < cap
        e_safe = torch.where(keep, sel[:, k], torch.full_like(pos_k, E))
        p_safe = torch.where(keep, pos_k, torch.zeros_like(pos_k))
        slots.append((e_safe, p_safe, keep))
    return slots


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """`F.one_hot` without its range checks, which read the tensor back to
    the host on the CPU: (T,) -> (T, n) int64."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).long()


def balance_loss(probs: torch.Tensor, sel: torch.Tensor,
                 dims: MoEDims) -> torch.Tensor:
    """The load-balancing aux loss over the REAL experts (Switch §2.2)."""
    E = dims.n_experts_pad
    me = probs[:, : dims.n_experts].mean(0)
    occ = torch.zeros(E, dtype=torch.float32, device=probs.device)
    for k in range(dims.top_k):
        occ = occ + one_hot(sel[:, k], E).float().mean(0)
    return dims.n_experts * torch.sum(me * occ[: dims.n_experts])


def experts(xt: torch.Tensor, slots, cap: int, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The (E, cap, D) expert buffer filled from the kept assignments (a
    spare row E takes the dropped ones) and the three batched expert
    products.  Returns the (E, cap, D) outputs."""
    E = w_gate.shape[0]
    buf = torch.zeros((E + 1, cap, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    for e_safe, p_safe, _ in slots:
        buf.index_put_((e_safe, p_safe), xt)
    buf = buf[:E]
    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    return torch.bmm(silu(g) * u, w_down)


def combine(out_buf: torch.Tensor, slots, gate_vals: torch.Tensor):
    """Per slot, the token-aligned gather (row E clamped to E - 1) weighted
    by its gate (0 where dropped), accumulated in f32.  Returns (T, D)."""
    E = out_buf.shape[0]
    T, D = gate_vals.shape[0], out_buf.shape[2]
    out = torch.zeros((T, D), dtype=torch.float32, device=out_buf.device)
    for k, (e_safe, p_safe, keep) in enumerate(slots):
        gathered = out_buf[e_safe.clamp(max=E - 1), p_safe].float()
        w = gate_vals[:, k].float() * keep
        out = out + gathered * w[:, None]
    return out


def moe_block(
    x: torch.Tensor,  # (B, S, D)
    router_w: torch.Tensor,  # (D, E_pad)
    w_gate: torch.Tensor,  # (E_pad, D, F)
    w_up: torch.Tensor,  # (E_pad, D, F)
    w_down: torch.Tensor,  # (E_pad, F, D)
    dims: MoEDims,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux_loss ()): aux is the standard
    load-balancing loss (Switch §2.2)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    probs, gate_vals, sel = route(xt, router_w, dims)
    aux = balance_loss(probs, sel, dims)
    cap = capacity(T, dims)
    slots = dispatch(sel, dims, cap)
    out_buf = experts(xt, slots, cap, w_gate, w_up, w_down)
    out = combine(out_buf, slots, gate_vals)
    return out.reshape(B, S, D).to(x.dtype), aux
