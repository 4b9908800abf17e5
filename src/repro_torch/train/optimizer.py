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
tree order (dict keys sorted).  The sharding spec tree (`opt_state_specs`)
waits for the sharding slice (ROADMAP queue 1 item 8.5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import torch

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


def adamw_init(params, cfg: AdamWConfig) -> OptState:
    def z(moment):
        return lambda p: _encode(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            cfg.state_dtype, moment)

    dev = tree_leaves(params)[0].device
    return OptState(m=tree_map(z("m"), params), v=tree_map(z("v"), params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


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


def _update_leaf(p, g, me, ve, scale, bc1, bc2, decay,
                 cfg: AdamWConfig) -> None:
    g32 = g.float() * scale
    m = cfg.b1 * _decode(me, cfg.state_dtype) + (1 - cfg.b1) * g32
    v = cfg.b2 * _decode(ve, cfg.state_dtype) + (1 - cfg.b2) * g32 * g32
    update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    p32 = p.float()
    p32 = p32 - cfg.lr * (update + decay * p32)
    p.copy_(p32.to(p.dtype))
    _store(me, _encode(m, cfg.state_dtype, "m"))
    _store(ve, _encode(v, cfg.state_dtype, "v"))


@torch.no_grad()
def adamw_update(params, grads, state: OptState,
                 cfg: AdamWConfig) -> Tuple[Any, OptState]:
    """Returns (params, state) with the parameters and moments written in
    place (the module doc).  Grads may be bf16; the math is f32."""
    step = state.step + 1
    flat_g = tree_leaves(grads)
    gsq = sum(torch.sum(torch.square(g.float())) for g in flat_g)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    for p, g, me, ve in zip(tree_leaves(params), flat_g,
                            tree_leaves(state.m), tree_leaves(state.v)):
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        if p.ndim < 2:
            _update_leaf(p, g, me, ve, scale, bc1, bc2, decay, cfg)
            continue
        n = max(1, CHUNK // (p.numel() // p.shape[0]))
        for r in range(0, p.shape[0], n):
            sl = slice(r, r + n)
            _update_leaf(p[sl], g[sl], _rows(me, sl), _rows(ve, sl), scale,
                         bc1, bc2, decay, cfg)
    return params, OptState(m=state.m, v=state.v, step=step)
