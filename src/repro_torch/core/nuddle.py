"""Nuddle: the generic delegation engine (paper §2), in PyTorch.

Counterpart of src/repro/core/nuddle.py, whose docstring states the claim:
Nuddle turns ANY concurrent NUMA-oblivious structure into a NUMA-aware one,
because delegation needs only (a) a way for clients to hand compact request
frames to servers and (b) the structure's own operations for the servers to
run.  A structure is delegable if it gives three shard-local callables:

    nominate(local_state, m)        -> frame   shard-local candidate frame
    combine(frame_a, frame_b)       -> frame   associative frame merge
    commit(local_state, verdict, ctx) -> state apply the global verdict

and `delegate_*` run the two-phase reduction: frames combine within the
pod, pod frames combine across pods, and every shard commits the verdict.
The PQ tournament (`pq_tournament_ops`) is one plugin; `sorted_set_ops`
(batch membership) is a structurally different second one.

Where the reference vmaps the callables over the shard axis, the port loops
over the shards and stacks the results, with the same combine order.
`delegate_window`'s `lax.scan` is K host-issued rounds stacking the
verdicts.  A state or frame is a tensor or a dict, list or tuple of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pqueue.local import topk_of_merged
from repro_torch.core.pqueue.state import INF_KEY
from repro_torch.distributed.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class DelegableOps:
    """The structure-specific plugin (the base algorithm's core ops)."""

    nominate: Callable[[Any, int], Any]  # local_state, m -> frame
    combine: Callable[[Any, Any], Any]  # frame, frame -> frame
    commit: Callable[[Any, Any, Any], Any]  # local_state, verdict, ctx -> state


def _map(fn, *trees):
    """`fn` over the tensor leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stacked(fn, n: int, *trees):
    """`fn` on row i of every tree for i < n, the results stacked: the
    reference's vmap."""
    outs = [fn(*(_map(lambda x: x[i], t) for t in trees)) for i in range(n)]
    return _map(lambda *xs: torch.stack(xs), *outs)


def _reduce_frames(ops: DelegableOps, frames, n: int):
    """Pairwise reduction over a leading axis of size n, halving each
    round: row i of the first half combines with row i of the second."""
    while n > 1:
        if n % 2:
            raise ValueError("shard count must be a power of two")
        half, rest = (_map(lambda x: x[: n // 2], frames),
                      _map(lambda x: x[n // 2:], frames))
        frames, n = _stacked(ops.combine, n // 2, half, rest), n // 2
    return _map(lambda x: x[0], frames)


def delegate_single_controller(ops: DelegableOps, local_states, m: int,
                               npods: int, ctx: Any = None):
    """Single-controller path: the two-phase combine tree the distributed
    path performs, over a leading shard axis S.  Returns (new states,
    verdict)."""
    S = _leaves(local_states)[0].shape[0]
    if S % npods:
        raise ValueError(f"{S} shards do not split over {npods} pods")
    frames = _stacked(lambda s: ops.nominate(s, m), S, local_states)
    # Phase 1: per-pod combine.  Phase 2: cross-pod combine.
    per_pod = _map(lambda x: x.reshape(npods, S // npods, *x.shape[1:]),
                   frames)
    pod_frames = _stacked(lambda f: _reduce_frames(ops, f, S // npods),
                          npods, per_pod)
    verdict = _reduce_frames(ops, pod_frames, npods)
    new_states = _stacked(lambda s: ops.commit(s, verdict, ctx), S,
                          local_states)
    return new_states, verdict


def delegate_dist(ops: DelegableOps, local_state, m: int,
                  shard_axes: Tuple[str, ...], pod_axis: str | None,
                  ctx: Any = None, *, mesh: Mesh):
    """Distributed delegation: all_gather and combine within the pod, then
    only the combined pod frames cross `pod_axis`.  Returns (new local
    state, verdict)."""
    frame = ops.nominate(local_state, m)

    def gather_combine(fr, axes):
        gathered = _map(lambda x: mesh.all_gather(x, axes), fr)
        n = _leaves(gathered)[0].shape[0]
        out = _map(lambda x: x[0], gathered)
        for i in range(1, n):
            out = ops.combine(out, _map(lambda x: x[i], gathered))
        return out

    pod_frame = gather_combine(frame, shard_axes)
    verdict = (gather_combine(pod_frame, (pod_axis,)) if pod_axis
               else pod_frame)
    return ops.commit(local_state, verdict, ctx), verdict


def delegate_window(ops: DelegableOps, local_states, m: int, npods: int,
                    ctxs: Any = None, length: int | None = None):
    """K delegation rounds, each the full two-phase reduction of
    `delegate_single_controller`: the window analogue of the paper's
    serve_requests() loop (a server serves a BATCH of requests a wakeup).
    `ctxs` carries a leading round axis K (or is None, with `length`).
    Returns (final states, verdicts stacked over the rounds), equal to K
    sequential calls."""
    K = _leaves(ctxs)[0].shape[0] if ctxs is not None else length
    if K is None:
        raise ValueError("delegate_window needs ctxs or a length")
    states, verdicts = local_states, []
    for t in range(K):
        ctx = None if ctxs is None else _map(lambda x: x[t], ctxs)
        states, verdict = delegate_single_controller(ops, states, m, npods,
                                                     ctx)
        verdicts.append(verdict)
    return states, _map(lambda *xs: torch.stack(xs), *verdicts)


# ---------------------------------------------------------------------------
# Genericity demo #1: the PQ tournament as a DelegableOps plugin.
# ---------------------------------------------------------------------------


def pq_tournament_ops() -> DelegableOps:
    """Priority-queue deleteMin as delegation: nominate = sorted prefix,
    combine = 2-way merge keeping the m smallest (the `topk_smallest`
    kernel), commit = remove the won prefix."""

    def nominate(local_state, m):
        return {"k": local_state["keys"][:m], "v": local_state["vals"][:m]}

    def combine(a, b):
        m = a["k"].shape[0]
        k, v = topk_of_merged(torch.cat([a["k"], b["k"]]),
                              torch.cat([a["v"], b["v"]]), m)
        return {"k": k, "v": v}

    def commit(local_state, verdict, ctx):
        n = torch.as_tensor(ctx["n"], dtype=torch.int32,
                            device=verdict["k"].device)
        m = verdict["k"].shape[0]
        cutoff = verdict["k"][torch.clamp(n - 1, 0, m - 1).to(torch.int64)]
        keys = local_state["keys"]
        take = torch.where(n > 0, torch.sum(keys < cutoff), 0).to(torch.int32)
        C = keys.shape[0]
        col = torch.arange(C, dtype=torch.int32, device=keys.device) + take
        in_rng = col < C
        idx = torch.clamp(col, max=C - 1).to(torch.int64)
        return {
            "keys": torch.where(in_rng, keys[idx], INF_KEY),
            "vals": torch.where(in_rng, local_state["vals"][idx], 0),
        }

    return DelegableOps(nominate, combine, commit)


# ---------------------------------------------------------------------------
# Genericity demo #2: a sorted set (skip-list stand-in) with batch contains:
# frames are hit bitmaps, not runs.
# ---------------------------------------------------------------------------


def sorted_set_ops(query_keys: torch.Tensor) -> DelegableOps:
    """Batch membership: nominate = local hit bitmap for `query_keys`,
    combine = OR, commit = identity (a read-only op)."""

    def nominate(local_state, m):
        return {"hit": torch.isin(query_keys, local_state["keys"])}

    def combine(a, b):
        return {"hit": a["hit"] | b["hit"]}

    def commit(local_state, verdict, ctx):
        return local_state

    return DelegableOps(nominate, combine, commit)
