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
device, so a decode step stays capturable in a CUDA graph.

Port-only (granite-4.0-h-small): `MoEDims.dropless` sets ``cap = T``, so
no assignment is dropped whatever the load (an expert takes each token at
most once, so it holds at most T) and the batched design stays, each
expert's weights read once; `moe_block`'s `shared` weights add a shared
SwiGLU expert, computed for every token and added to the routed output in
the compute dtype.  With an `obs`, `moe_block` records spans
``model.moe.route`` (router, top-k, aux loss), ``model.moe.experts``
(dispatch, buffer, products), ``model.moe.combine`` and
``model.moe.shared``, and counters ``moe.buffer_rows`` (E x cap) and
``moe.assignments`` (T x K), host values from static shapes.

`moe_block_ep` is the reference's expert-parallel block (its `shard_map`
over the model axis), run on each rank of a `Mesh`: the tokens are
replicated over the model axis, so each model column routes its local
batch rows to the E_pad / n_model experts it owns with no dispatch
traffic, and the columns' partial outputs are summed over the model axis.
The slot budget is per (column, batch rows), ``cap = T_loc*K/E_pad*cf``:
overflow is decided locally (the reference's documented divergence from
`moe_block`), and a dropped slot combines the value 0 (the reference's
``mode="fill"`` gather).  The aux loss is computed on every column and
`pmean`'d over the batch axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.distributed.collectives import enter, leave
from repro_torch.models.layers.mlp import gated_mlp, silu
from repro_torch.obs import NULL


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int  # real experts
    n_experts_pad: int  # padded to model-axis multiple
    top_k: int
    capacity_factor: float = 1.25
    dropless: bool = False  # port-only: cap = T (module docstring)


def capacity(T: int, dims: MoEDims) -> int:
    """Slots an expert holds for `T` tokens (the reference's `cap`; T when
    dropless)."""
    if dims.dropless:
        return T
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
    shared: Optional[Tuple[torch.Tensor, ...]] = None,  # (D,Fs),(D,Fs),(Fs,D)
    obs=NULL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D), aux_loss ()): aux is the standard
    load-balancing loss (Switch §2.2).  `shared`: the shared expert's
    (gate, up, down) weights (module docstring)."""
    B, S, D = x.shape
    T = B * S
    tr = obs.tracer
    xt = x.reshape(T, D)
    with tr.span("model.moe.route", "model"):
        probs, gate_vals, sel = route(xt, router_w, dims)
        aux = balance_loss(probs, sel, dims)
    cap = capacity(T, dims)
    obs.metrics.inc("moe.buffer_rows", n=dims.n_experts_pad * cap)
    obs.metrics.inc("moe.assignments", n=T * dims.top_k)
    with tr.span("model.moe.experts", "model"):
        slots = dispatch(sel, dims, cap)
        out_buf = experts(xt, slots, cap, w_gate, w_up, w_down)
    with tr.span("model.moe.combine", "model"):
        out = combine(out_buf, slots, gate_vals).reshape(B, S, D).to(x.dtype)
    if shared is not None:
        with tr.span("model.moe.shared", "model"):
            out = out + gated_mlp(x, *shared)
    return out, aux


def moe_block_ep(
    x: torch.Tensor,  # (B_loc, S, D): this rank's rows, replicated over model
    router_w: torch.Tensor,  # (D, E_pad) whole
    w_gate: torch.Tensor,  # (E_loc, D, F): this column's experts
    w_up: torch.Tensor,  # (E_loc, D, F)
    w_down: torch.Tensor,  # (E_loc, F, D)
    dims: MoEDims,
    mesh,
    batch_axes: Tuple[str, ...],
    model_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank of `mesh`.  Returns (output
    (B_loc, S, D), the same on every column; aux (), the same on every
    rank).  Autograd: `x`'s gradient is summed over the model axis here;
    `router_w`'s is this column's share, which the caller sums over the
    model axis (a `collectives.gather` of the router)."""
    B, S, D = x.shape
    E, K = dims.n_experts_pad, dims.top_k
    n_cols = mesh.axis_size(model_axis)
    assert E % n_cols == 0, (E, n_cols)
    E_loc = E // n_cols
    x = enter(x, mesh, model_axis)
    T = B * S
    xt = x.reshape(T, D)
    probs, gate_vals, sel = route(xt, router_w, dims)
    aux = balance_loss(probs, sel, dims)
    col = mesh.device_rank(model_axis)
    cap = capacity(T, dims)
    base = torch.zeros(E_loc, dtype=torch.int64, device=x.device)
    slots = []
    for k in range(K):
        ek = sel[:, k]
        is_local = (ek // E_loc) == col
        le = torch.where(is_local, ek % E_loc, torch.full_like(ek, E_loc))
        onehot = one_hot(le, E_loc)  # the spare index E_loc: a zero row
        within = torch.cumsum(onehot, dim=0) - onehot
        pos = (within * onehot).sum(1) + torch.where(
            is_local, base[le.clamp(max=E_loc - 1)], torch.zeros_like(le))
        base = base + onehot.sum(0)
        keep = is_local & (pos < cap)
        e_safe = torch.where(keep, le, torch.full_like(le, E_loc))
        p_safe = torch.where(keep, pos, torch.zeros_like(pos))
        slots.append((e_safe, p_safe, keep))
    out_buf = experts(xt, slots, cap, w_gate, w_up, w_down)
    # the spare row E_loc reads 0 (the reference's fill)
    out_buf = torch.cat([out_buf, out_buf.new_zeros((1,) + out_buf.shape[1:])])
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for k, (e_safe, p_safe, keep) in enumerate(slots):
        w = gate_vals[:, k].float() * keep
        out = out + out_buf[e_safe, p_safe].float() * w[:, None]
    out = leave(out, mesh, model_axis)  # the row-parallel combine
    # every column computes the same aux: its gradient counts once
    aux = aux.detach() + (aux - aux.detach()) / n_cols
    if batch_axes:
        aux = leave(aux / mesh.axis_size(batch_axes), mesh, batch_axes)
    return out.reshape(B, S, D).to(x.dtype), aux
