"""AdamW with optional low-precision moments.

Counterpart of src/repro/train/optimizer.py (`AdamWConfig`, `OptState`,
`BLOCK`, `_int8_eligible`, `_q8`, `_dq8`, `_encode`, `_decode`,
`adamw_init`, `adamw_update`), with the reference's arithmetic.

State dtypes:
  fp32 - exact;
  bf16 - both moments stored in bf16;
  int8 - 8-bit-Adam style: the first moment blockwise int8 (symmetric,
         BLOCK values of the last axis share an f32 scale), a plain tuple
         ``(q int8 [param shape], scale f32 [..., n_blocks])``; the second
         moment stays bf16 (its range spans decades, which linear int8
         rounds to zero).  A leaf whose last axis does not divide into
         blocks stays f32.

Where the port differs: `adamw_update` writes the new parameters and
moments into the given tensors (under `torch.no_grad`) and returns the
same trees with a new step, as `Model.decode_step` writes its caches; a
leaf of two or more axes is updated in slices of its first axis of about
`CHUNK` values, so the f32 temporaries stay that size (the update is
elementwise and the int8 blocks lie along the last axis, so the numbers
are the same).  The gradient norm sums over the leaves in the reference's
tree order (dict keys sorted).

`opt_state_specs` is the reference's spec tree of the state: an int8 first
moment's scale replicates over the axes of the (blocked) last dimension.
On a mesh (`adamw_init(mesh=, specs=)`, `adamw_update(mesh=, specs=)`)
every rank updates its blocks of the parameters and moments, which is
elementwise, but for two things.  The gradient norm is the global one:
each leaf's local sum of squares is psum'd over the axes its spec shards
it on (a replicated leaf counts once).  An int8 first moment whose last
dimension is sharded keeps its scales whole, as the spec says
(`_ShardedQ8`): where a rank's block of the last dimension holds whole
256-value blocks, it quantizes them and the scales are gathered over the
last dimension's axes; where a block spans ranks (a local width dividing
256), each rank's |max| is gathered and the block's max taken over the
ranks it spans; where a rank's block straddles the blocks' boundaries
(any other width), each rank's |max| over its part of every block is
pmax'd over the axes.  Every rank quantizes with the scale one process
would.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (P, entry_axes, fit_rank,
                                              spec_axes)
from repro_torch.models.params import spec_at

BLOCK = 256  # int8 quantization block (last-axis groups)
CHUNK = 1 << 26  # values a slice of `adamw_update` holds in f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"  # fp32 | bf16 | int8


class OptState(NamedTuple):
    m: Any  # tree; int8 leaves are (q int8 [param shape], scale f32) pairs
    v: Any
    step: torch.Tensor  # () int32


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict in the reference's order (keys sorted);
    an int8 moment's (q, scale) pair is one leaf here."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """The nested dict of `like`'s structure holding `leaves`, taken in
    `tree_leaves`' order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            built = {k: build(x[k]) for k in sorted(x)}
            return {k: built[k] for k in x}
        return next(it)

    return build(like)


def tree_map(fn, tree):
    """`fn` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _int8_eligible(shape) -> bool:
    return len(shape) >= 1 and shape[-1] % BLOCK == 0


def _blocks(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], x.shape[-1] // BLOCK, BLOCK)


def _q8(x: torch.Tensor):
    blocks = _blocks(x)
    scale = torch.amax(torch.abs(blocks), dim=-1) / 127.0 + 1e-20
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return q.reshape(x.shape).to(torch.int8), scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (_blocks(q).float() * scale[..., None]).reshape(q.shape)


def _encode(x: torch.Tensor, dtype: str, moment: str = "m"):
    if dtype == "bf16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        if moment == "v":
            return x.to(torch.bfloat16)  # see the module doc
        if _int8_eligible(x.shape):
            return _q8(x)
    return x  # fp32 (also the int8 fallback for leaves off the blocks)


def _decode(e, dtype: str) -> torch.Tensor:
    if isinstance(e, tuple):
        return _dq8(*e)
    return e.float()


def tree_paths(tree, prefix: str = ""):
    """The key paths of a nested dict in `tree_leaves`' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}/{k}" if prefix
                                    else k)]
    return [prefix]


def _last_axes(spec, ndim: int):
    return entry_axes(fit_rank(spec, ndim)[-1]) if ndim else ()


def _global_last(p: torch.Tensor, spec, mesh) -> int:
    axes = _last_axes(spec, p.ndim)
    return p.shape[-1] * (mesh.axis_size(axes) if axes else 1)


def adamw_init(params, cfg: AdamWConfig, mesh=None, specs=None) -> OptState:
    """Zero moments of `params`; on a mesh (with the parameters' `specs`),
    of this rank's blocks, an int8 scale whole over the last dimension."""
    def z(moment, spec=None):
        def make(p):
            x = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if mesh is None or moment == "v" or cfg.state_dtype != "int8":
                return _encode(x, cfg.state_dtype, moment)
            full = _global_last(p, spec, mesh)
            if full % BLOCK:
                return x
            scale = torch.zeros(*p.shape[:-1], full // BLOCK,
                                dtype=torch.float32, device=p.device)
            return x.to(torch.int8), scale
        return make

    if mesh is None:
        m = tree_map(z("m"), params)
        v = tree_map(z("v"), params)
    else:
        m = tree_unflatten(params, [z("m", spec_at(specs, path))(p)
                                    for path, p in zip(tree_paths(params),
                                                       tree_leaves(params))])
        v = tree_map(z("v"), params)
    dev = tree_leaves(params)[0].device
    return OptState(m=m, v=v,
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def opt_state_specs(params, param_specs, cfg: AdamWConfig, mesh=None):
    """The spec tree of `OptState`: an int8 leaf's (q, scale) pair takes
    (its parameter's spec, that spec with the last dimension replicated).
    Eligibility is judged on the global shape (`params` are this rank's
    blocks when `mesh` is given)."""
    def leaf_m(p, spec):
        last = _global_last(p, spec, mesh) if mesh is not None else (
            p.shape[-1] if p.ndim else 0)
        if cfg.state_dtype == "int8" and p.ndim >= 1 and last % BLOCK == 0:
            entries = list(spec) + [None] * (p.ndim - len(spec))
            return (spec, P(*(entries[:-1] + [None])))
        return spec

    flat = tree_leaves(params)
    specs = [spec_at(param_specs, path) for path in tree_paths(params)]
    m_specs = tree_unflatten(params, [leaf_m(p, s)
                                      for p, s in zip(flat, specs)])
    return OptState(m=m_specs, v=param_specs, step=P())


def _store(dst, new) -> None:
    """Write an encoded moment (a tensor or an int8 (q, scale) pair) into
    `dst`, of the same form."""
    if isinstance(dst, tuple):
        for d, n in zip(dst, new):
            d.copy_(n)
    else:
        dst.copy_(new)


def _rows(e, sl):
    """Rows `sl` of the first axis of an encoded moment."""
    return tuple(t[sl] for t in e) if isinstance(e, tuple) else e[sl]


class _ShardedQ8:
    """The int8 first moment of a leaf whose last dimension is sharded over
    `axes`: (this rank's int8 values, every block's f32 scale)."""

    def __init__(self, mesh, axes, width: int):
        self.mesh, self.axes = mesh, axes
        self.n, self.r = mesh.axis_size(axes), mesh.device_rank(axes)
        self.width = width
        # a local width that neither holds whole blocks nor divides one
        # (jamba's in_proj: 1040 columns a rank on a 16-wide model axis)
        self.straddles = bool(width % BLOCK and BLOCK % width)

    def _blocks_of(self, x: torch.Tensor) -> torch.Tensor:
        """The global block of each local value of the last dimension."""
        return torch.div(self.r * self.width + torch.arange(
            self.width, device=x.device), BLOCK, rounding_mode="floor")

    def _mine(self, scale):
        """This rank's scales, one a local value's block: (..., 1) or
        (..., nb_local)."""
        if self.width % BLOCK == 0:
            nb = self.width // BLOCK
            return scale.narrow(-1, self.r * nb, nb)
        c = BLOCK // self.width
        return scale.narrow(-1, self.r // c, 1)

    def decode(self, e) -> torch.Tensor:
        q, scale = e
        if self.straddles:
            return q.float() * scale.index_select(-1, self._blocks_of(q))
        mine = self._mine(scale)
        if self.width % BLOCK == 0:
            return _dq8(q, mine)
        return q.float() * mine

    def encode(self, x: torch.Tensor):
        if self.straddles:
            # each rank's |max| over its part of every block, the max over
            # the ranks (a rank's missing parts count 0, under any |x|)
            idx = self._blocks_of(x)
            part = torch.zeros(*x.shape[:-1], self.n * self.width // BLOCK,
                               dtype=torch.float32, device=x.device)
            part = part.scatter_reduce(-1, idx.expand(x.shape),
                                       torch.abs(x), "amax")
            scale = self.mesh.pmax(part, self.axes) / 127.0 + 1e-20
            q = torch.clamp(torch.round(x / scale.index_select(-1, idx)),
                            -127, 127)
            return q.to(torch.int8), scale
        if self.width % BLOCK == 0:
            q, s = _q8(x)
            return q, self.mesh.all_gather(s.contiguous(), self.axes,
                                           axis=s.ndim - 1, tiled=True)
        c = BLOCK // self.width
        amax = self.mesh.all_gather(
            torch.amax(torch.abs(x), dim=-1).contiguous(), self.axes,
            axis=x.ndim - 1)  # (..., n)
        scale = torch.amax(amax.reshape(*amax.shape[:-1], self.n // c, c),
                           dim=-1) / 127.0 + 1e-20
        mine = scale.narrow(-1, self.r // c, 1)
        q = torch.clamp(torch.round(x / mine), -127, 127)
        return q.to(torch.int8), scale


def _update_leaf(p, g, me, ve, scale, bc1, bc2, decay,
                 cfg: AdamWConfig, q8: Optional[_ShardedQ8] = None) -> None:
    g32 = g.float() * scale
    m = cfg.b1 * (q8.decode(me) if q8 else _decode(me, cfg.state_dtype)) + (
        1 - cfg.b1) * g32
    v = cfg.b2 * _decode(ve, cfg.state_dtype) + (1 - cfg.b2) * g32 * g32
    update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    p32 = p32 - cfg.lr * (update + decay * p32)
    p.copy_(p32.to(p.dtype))
    _store(me, q8.encode(m) if q8 else _encode(m, cfg.state_dtype, "m"))
    _store(ve, _encode(v, cfg.state_dtype, "v"))


def _global_sq(flat_g, specs, mesh):
    """The global sum of squares: local sums psum'd over the axes each
    leaf is sharded on, one psum per distinct axis set."""
    groups: dict = {}
    for g, spec in zip(flat_g, specs):
        have = set(spec_axes(spec))
        axes = tuple(a for a in mesh.axis_names
                     if a in have and mesh.axis_size(a) > 1)
        sq = torch.sum(torch.square(g.float()))
        groups[axes] = groups[axes] + sq if axes in groups else sq
    total = torch.zeros((), dtype=torch.float32,
                        device=flat_g[0].device)
    for axes, sq in groups.items():
        total = total + (mesh.psum(sq, axes) if axes else sq)
    return total


@torch.no_grad()
def grad_norm(grads, mesh=None, specs=None) -> torch.Tensor:
    """The global L2 norm of a gradient tree (on a mesh, of every rank's
    blocks under `specs`)."""
    flat_g = tree_leaves(grads)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in flat_g))
    return torch.sqrt(_global_sq(
        flat_g, [spec_at(specs, path) for path in tree_paths(grads)], mesh))


@torch.no_grad()
def adamw_update(params, grads, state: OptState, cfg: AdamWConfig,
                 mesh=None, specs=None,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, OptState]:
    """Returns (params, state) with the parameters and moments written in
    place (the module doc).  Grads may be bf16; the math is f32.  On a
    mesh, every tensor is this rank's block under `specs`.  `gnorm`: the
    gradients' global norm, when the caller has it (`grad_norm`)."""
    step = state.step + 1
    flat_g = tree_leaves(grads)
    leaf_specs = ([spec_at(specs, path) for path in tree_paths(params)]
                  if mesh is not None else [None] * len(flat_g))
    if gnorm is None:
        gnorm = grad_norm(grads, mesh, specs)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, me, ve, spec in zip(tree_leaves(params), flat_g,
                                  tree_leaves(state.m), tree_leaves(state.v),
                                  leaf_specs):
        q8 = None
        if isinstance(me, tuple) and mesh is not None:
            axes = _last_axes(spec, p.ndim)
            if axes and mesh.axis_size(axes) > 1:
                q8 = _ShardedQ8(mesh, axes, p.shape[-1])
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        if p.ndim < 2:
            _update_leaf(p, g, me, ve, scale, bc1, bc2, decay, cfg, q8)
            continue
        n = max(1, CHUNK // (p.numel() // p.shape[0]))
        for r in range(0, p.shape[0], n):
            sl = slice(r, r + n)
            _update_leaf(p[sl], g[sl], _rows(me, sl), _rows(ve, sl), scale,
                         bc1, bc2, decay, cfg, q8)
    return params, OptState(m=state.m, v=state.v, step=step)
