"""Pod-aware collectives and gradient compression, over a `Mesh`.

Counterpart of src/repro/distributed/collectives.py: cross-pod traffic is
the scarce resource, so (a) reduce within the pod first and send only the
reduced tensor across the pod axis (hierarchical all-reduce), and (b)
optionally compress the cross-pod hop with error-feedback int8, so the slow
tier carries 4x fewer bytes while the fast tier stays exact.

The differentiable collectives of the sharded model follow: the `Mesh`
collectives carry no autograd, so each pair is a `torch.autograd.Function`
whose backward issues the adjoint collective (counted in `Mesh.counts` as
any other): `gather` (all_gather, and psum_scatter of the gradient: the
ZeRO weight gather when the work on the gathered weight is split over the
axes; with ``split=False`` the work is the same on every member and the
gradient is cut to the member's block instead), `enter` (identity, and
psum of the gradient: a replicated activation entering a tensor-parallel
region), `leave` (psum, and identity for the gradient: the partial sums
leaving a row-parallel region) and `scatter` (this member's block of a
replicated tensor, and all_gather of the gradient).  Over an axis tuple of one device each is
the identity.

Where the reference runs inside `shard_map`, these take the `mesh` whose
collectives they issue.  `torch.round` rounds half to even like
`jnp.round`, so `int8_quantize` and `int8_dequantize` are bit-equal to the
reference's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.mesh import Mesh


def hierarchical_psum(x: torch.Tensor, shard_axes, pod_axis: Optional[str],
                      *, mesh: Mesh) -> torch.Tensor:
    """Two-phase all-reduce: the pod-local sum first, so only one
    pre-reduced tensor a pod crosses the slow tier."""
    x = mesh.psum(x, shard_axes)
    if pod_axis is not None:
        x = mesh.psum(x, pod_axis)
    return x


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with a float32 scale."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_cross_pod_psum(
    x: torch.Tensor,
    shard_axes,
    pod_axis: Optional[str],
    error: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical all-reduce with int8 error feedback on the cross-pod
    hop.  Returns (reduced, new_error): the intra-pod sum is exact; the
    cross-pod sum quantizes (x + carried error) and carries the residual to
    the next step."""
    x = mesh.psum(x, shard_axes)
    if pod_axis is None:
        return x, torch.zeros_like(x) if error is None else error
    if error is not None:
        x = x + error
    # One scale shared across pods (a scalar pmax over the slow tier), so
    # the int32 sum of the payloads dequantizes exactly.
    amax = mesh.pmax(torch.max(torch.abs(x)) + 1e-12, pod_axis)
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    summed = mesh.psum(q.to(torch.int32), pod_axis)
    total = summed.to(torch.float32) * scale
    new_error = x - q.to(torch.float32) * scale
    return total, new_error


def reduce_scatter_then_allgather(x: torch.Tensor, axis: str, dim: int = 0,
                                  *, mesh: Mesh) -> torch.Tensor:
    """An all-reduce in two explicit halves (reduce-scatter, then
    all-gather), which a scheduler can overlap with compute."""
    rs = mesh.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)
    return mesh.all_gather(rs, axis, axis=dim, tiled=True)


# ---------------------------------------------------------------------------
# differentiable collectives (the sharded model's)
# ---------------------------------------------------------------------------


def _axes_tuple(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, split):
        ctx.mesh, ctx.axes, ctx.dim, ctx.split = mesh, axes, dim, split
        return mesh.all_gather(x, axes, axis=dim, tiled=True)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.mesh, ctx.axes, ctx.dim
        if ctx.split:
            return (mesh.psum_scatter(g.contiguous(), axes,
                                      scatter_dimension=dim, tiled=True),
                    None, None, None, None)
        n = g.shape[dim] // mesh.axis_size(axes)
        return (g.narrow(dim, mesh.device_rank(axes) * n, n),
                None, None, None, None)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = x.shape[dim] // mesh.axis_size(axes)
        return x.narrow(dim, mesh.device_rank(axes) * n, n)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.axes, axis=ctx.dim,
                                    tiled=True), None, None, None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather(x: torch.Tensor, mesh: Mesh, axes, dim: int,
           split: bool = True) -> torch.Tensor:
    """The members' blocks of `x` concatenated along `dim` (row-major over
    `axes`); the gradient is psum_scatter'd back (`split`: each member
    does its own share of the work on the result) or cut to this member's
    block (the same work everywhere)."""
    axes = _axes_tuple(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _Gather.apply(x, mesh, axes, dim, split)


def scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This member's block of dimension `dim` of a tensor replicated over
    `axes`; the gradient is gathered, so every member holds all of it."""
    axes = _axes_tuple(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    if x.shape[dim] % mesh.axis_size(axes):
        raise ValueError(f"scatter: dimension {dim} of {tuple(x.shape)} does "
                         f"not split {mesh.axis_size(axes)} ways")
    return _Scatter.apply(x, mesh, axes, dim)


def enter(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """Identity; the gradient is summed over `axes`."""
    axes = _axes_tuple(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _Enter.apply(x, mesh, axes)


def leave(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum over `axes`; the gradient passes through."""
    axes = _axes_tuple(axes)
    if not axes or mesh.axis_size(axes) == 1:
        return x
    return _Leave.apply(x, mesh, axes)
