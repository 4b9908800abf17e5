"""Sharding rules: logical parameter and activation roles -> PartitionSpec,
and the placement of tensors by those specs on a `Mesh`.

Counterpart of src/repro/distributed/sharding.py (`ShardingRules` with
every field and default, `default_rules`, `strip_pod`, `drop_batch_axes`,
`tp_only_params`, `named`, `constraint`, `pad_to_multiple`).  The port
keeps its own `PartitionSpec` (`P`): a tuple whose entries are None, an
axis name or a tuple of axis names, so ``tuple(spec)`` compares entry for
entry with the reference's.

Scheme: 2D parameter storage over ('data', 'model').  The 'data' factor is
the ZeRO-3 storage shard, gathered at use (`Model._w`); the 'model' factor
is Megatron-style tensor parallelism.  Activations are batch-sharded over
('pod', 'data').

What JAX's `device_put` and `NamedSharding` do implicitly is explicit here:
one process is one device, holding its block of every tensor.
`local_shard(full, mesh, spec)` is this rank's block of a full tensor, and
`gather_full(local, mesh, spec)` the full tensor from the blocks
(`Mesh.all_gather`).  A dimension sharded over an axis tuple splits into
contiguous blocks ranked row-major over the tuple (`Mesh.device_rank`), as
JAX lays out a `NamedSharding`; the dimension must divide evenly, as JAX
requires.  `constraint` re-lays a tensor from one spec to another (the
reference's `with_sharding_constraint`, which moves data only where the
layout changes), right-padding both specs with None to the tensor's rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.distributed.mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD


class PartitionSpec(tuple):
    """A tensor's placement, one entry per leading dimension: None
    (replicated), an axis name, or a tuple of axis names (row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """PartitionSpecs by logical tensor role.  The leading entry of a
    layer-stacked parameter is the (unsharded) layer axis."""

    # -- params --------------------------------------------------------------
    embed: P = P(AXIS_MODEL, AXIS_DATA)  # (V_pad, D)
    head: P = P(AXIS_DATA, AXIS_MODEL)  # (D, V_pad) unembedding
    norm_scale: P = P(None)  # (D,) replicated
    wq: P = P(None, AXIS_DATA, AXIS_MODEL)  # (L, D, Hq*hd)
    wkv: P = P(None, AXIS_DATA, AXIS_MODEL)  # (L, D, Hkv*hd)
    wo: P = P(None, AXIS_MODEL, AXIS_DATA)  # (L, Hq*hd, D) row-parallel
    qkv_bias: P = P(None, AXIS_MODEL)  # (L, F)
    w_in: P = P(None, AXIS_DATA, AXIS_MODEL)  # (L, D, d_ff) column-parallel
    w_out: P = P(None, AXIS_MODEL, AXIS_DATA)  # (L, d_ff, D) row-parallel
    router: P = P(None, AXIS_DATA, AXIS_MODEL)  # (L, D, E_pad)
    expert_in: P = P(None, AXIS_MODEL, AXIS_DATA, None)  # (L, E_pad, D, F)
    expert_out: P = P(None, AXIS_MODEL, None, AXIS_DATA)  # (L, E_pad, F, D)
    ssm_in: P = P(None, AXIS_DATA, AXIS_MODEL)  # (L, D, in_proj_out)
    ssm_out: P = P(None, AXIS_MODEL, AXIS_DATA)  # (L, d_inner, D)
    ssm_small: P = P(None, AXIS_MODEL)  # (L, conv_channels)
    conv_kernel: P = P(None, None, AXIS_MODEL)  # (L, K, conv_channels)

    # -- activations ---------------------------------------------------------
    act_btd: P = P((AXIS_POD, AXIS_DATA), None, None)  # (B, S, D)
    act_seq: P = P((AXIS_POD, AXIS_DATA), AXIS_MODEL, None)  # (B, S, D)
    act_ffn: P = P((AXIS_POD, AXIS_DATA), None, AXIS_MODEL)  # (B, S, d_ff)
    logits: P = P((AXIS_POD, AXIS_DATA), None, AXIS_MODEL)  # (B, S, V_pad)
    tokens: P = P((AXIS_POD, AXIS_DATA), None)  # (B, S)
    # KV cache: batch over the data axes, sequence over model
    kv_cache: P = P(None, (AXIS_POD, AXIS_DATA), AXIS_MODEL, None, None)
    ssm_state: P = P(None, (AXIS_POD, AXIS_DATA), AXIS_MODEL, None)
    scalar: P = P()


def default_rules(single_axis_fallback: bool = False) -> ShardingRules:
    return ShardingRules()


def _keep(entry, keep: Callable[[str], bool]):
    """A spec entry with the axes `keep` rejects dropped (a one-axis tuple
    becomes its axis, an empty one None)."""
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if keep(a))
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return entry if entry is None or keep(entry) else None


@dataclasses.dataclass(frozen=True)
class ReplicatedRules(ShardingRules):
    """`ShardingRules` that also name, in `replicated`, mesh axes over
    which every device holds the same blocks and repeats the same work:
    what a global batch of 1 leaves to no other rule (`replicate_unused`).
    The reference's GSPMD replicates such an axis without being told."""

    replicated: P = P()


def _map_fields(rules: ShardingRules, fix, fields=None) -> ShardingRules:
    """`rules` with `fix` applied to the specs of `fields` (every
    `ShardingRules` field when None)."""
    return dataclasses.replace(rules, **{
        f.name: fix(getattr(rules, f.name))
        for f in dataclasses.fields(ShardingRules)
        if fields is None or f.name in fields})


def strip_pod(rules: ShardingRules, mesh) -> ShardingRules:
    """Drop the pod axis from every spec when the mesh has none."""
    if AXIS_POD in mesh.axis_names:
        return rules
    return _map_fields(rules, lambda s: P(*(_keep(e, lambda a: a != AXIS_POD)
                                            for e in s)))


def check_rules(rules: ShardingRules, mesh) -> ShardingRules:
    """`rules` unchanged if they fit `mesh`; a ValueError if a spec names
    an axis the mesh lacks (placement would fail) or a mesh axis wider
    than 1 is named by no spec (its ranks would repeat each other's
    work) unless `ReplicatedRules.replicated` names it."""
    named_axes = _named_axes(rules)
    missing = sorted(named_axes - set(mesh.axis_names))
    if missing:
        raise ValueError(f"the sharding rules name {missing}, which the mesh "
                         f"{tuple(mesh.axis_names)} lacks")
    unused = _unused_axes(rules, mesh)
    if unused:
        raise ValueError(f"no sharding rule uses the mesh axes {unused}")
    return rules


def _named_axes(rules: ShardingRules) -> set:
    return {a for f in dataclasses.fields(rules)
            for a in spec_axes(getattr(rules, f.name))}


def _unused_axes(rules: ShardingRules, mesh) -> list:
    named = _named_axes(rules)
    return [a for a in mesh.axis_names if mesh.shape[a] > 1
            and a not in named]


def replicate_unused(rules: ShardingRules, mesh) -> ShardingRules:
    """`rules` with the mesh axes wider than 1 that no spec names declared
    replicated (`ReplicatedRules`): `check_rules` then accepts them."""
    unused = _unused_axes(rules, mesh)
    if not unused:
        return rules
    return ReplicatedRules(
        **{f.name: getattr(rules, f.name)
           for f in dataclasses.fields(ShardingRules)},
        replicated=P(*unused))


ACT_FIELDS = ("act_btd", "act_seq", "act_ffn", "logits", "tokens",
              "kv_cache", "ssm_state")
PARAM_FIELDS = ("embed", "head", "wq", "wkv", "wo", "qkv_bias", "w_in",
                "w_out", "router", "expert_in", "expert_out", "ssm_in",
                "ssm_out", "ssm_small", "conv_kernel")


def drop_batch_axes(rules: ShardingRules) -> ShardingRules:
    """Strip the ('pod', 'data') batch group from the ACTIVATION specs (a
    global batch that does not divide the batch devices); parameter specs
    keep their 'data' ZeRO factor."""
    batch = {AXIS_POD, AXIS_DATA}
    return _map_fields(
        rules, lambda s: P(*(_keep(e, lambda a: a not in batch) for e in s)),
        ACT_FIELDS)


def tp_only_params(rules: ShardingRules) -> ShardingRules:
    """Serving placement: drop the 'data' (ZeRO) factor from the PARAMETER
    specs, so weights are stored tensor-parallel and replicated over
    'data' (no optimizer state to shard, no per-step weight gathers)."""
    return _map_fields(
        rules, lambda s: P(*(_keep(e, lambda a: a != AXIS_DATA) for e in s)),
        PARAM_FIELDS)


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement: a mesh and a spec (the counterpart of JAX's)."""

    mesh: Any
    spec: P


def named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fit_rank(spec, ndim: int) -> P:
    """`spec` right-padded with None (or cut) to `ndim` entries."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return P(*entries[:ndim])


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis a spec shards over, in order of appearance."""
    return tuple(a for e in spec for a in entry_axes(e))


def _dims(x: torch.Tensor, mesh, spec):
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has more entries than the "
                         f"{x.ndim}-d tensor")
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec!r}: axis {a!r} is not in the "
                                 f"mesh {mesh.axis_names}")
        if axes:
            yield d, axes


def local_shard(full: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of `full` under `spec` (a view; each sharded
    dimension must divide evenly, as JAX requires)."""
    out = full
    for d, axes in _dims(full, mesh, spec):
        n = mesh.axis_size(axes)
        if full.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(full.shape)} does not "
                             f"split {n} ways over {axes}")
        size = full.shape[d] // n
        out = out.narrow(d, mesh.device_rank(axes) * size, size)
    return out


def local_shape(shape, mesh, spec) -> Tuple[int, ...]:
    """The block shape of a `shape` tensor under `spec`."""
    out = list(shape)
    for d, e in enumerate(spec):
        n = mesh.axis_size(entry_axes(e)) if e is not None else 1
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split {n} ways over {e}")
        out[d] //= n
    return tuple(out)


def gather_full(local: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The full tensor from every rank's block under `spec`
    (`Mesh.all_gather`, one a sharded dimension)."""
    out = local
    for d, axes in _dims(local, mesh, spec):
        if mesh.axis_size(axes) > 1:
            out = mesh.all_gather(out, axes, axis=d, tiled=True)
    return out


def constraint(x: torch.Tensor, mesh, spec, current=P()) -> torch.Tensor:
    """`x`, laid out under `current`, re-laid out under `spec`: the
    dimensions whose entries differ are gathered from `current` and cut to
    `spec`'s block.  Both specs are right-padded with None to x's rank (the
    reference's tolerance of a missing layer dimension)."""
    want, have = fit_rank(spec, x.ndim), fit_rank(current, x.ndim)
    moved = [d for d, (w, h) in enumerate(zip(want, have)) if w != h]
    # every moved dimension whole first, then cut: a dimension cut over an
    # axis would otherwise be gathered across ranks holding other blocks
    x = gather_full(x, mesh, P(*(have[d] if d in moved else None
                                 for d in range(x.ndim))))
    return local_shard(x, mesh, P(*(want[d] if d in moved else None
                                    for d in range(x.ndim))))


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def spec_map(fn, tree, *rest, is_leaf=is_spec):
    """`fn` over the leaves of a tree of dicts, named tuples, tuples and
    lists (`is_leaf` says what a leaf is: by default a PartitionSpec, not
    a tuple to walk; None is a leaf too), with the matching nodes of the
    `rest` trees."""
    if tree is None or is_leaf(tree):
        return fn(tree, *rest)

    def walk(v, *r):
        return spec_map(fn, v, *r, is_leaf=is_leaf)

    if isinstance(tree, dict):
        return {k: walk(v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(walk(v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(walk(v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"spec_map: {type(tree).__name__} is not a leaf or a "
                    f"tree node")


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def gather_tree(tree, mesh, specs):
    """The full tensor of every leaf of a tree of this rank's blocks (a
    collective: every rank of the mesh calls it)."""
    return spec_map(lambda s, x: gather_full(x, mesh, s), specs, tree)
