"""Graph containers for the SSSP workload driver, in numpy and PyTorch.

Counterpart of src/repro/workloads/graphs.py: two views of one random
graph,
  * a host CSR triple ``(indptr, indices, weights)``, which the
    Bellman-Ford oracle iterates over;
  * a padded adjacency ``(n, deg_cap)`` of neighbour ids and weights on the
    graph's device (neighbour ``n`` marks padding), which the relaxation
    step gathers from, so every popped vertex gives exactly ``deg_cap``
    relaxation lanes.
The graph is drawn on the host with the reference's `np.random` calls in
the reference's order, so the arrays are identical.  Degree is capped when
the graph is drawn, so the oracle and the driver see the same edges.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.pqueue.state import INF_KEY
from repro_torch.utils.hostsync import resolve_device


class Graph(NamedTuple):
    """CSR on the host + padded adjacency on the device."""

    n: int
    deg_cap: int
    indptr: np.ndarray  # (n + 1,) int32
    indices: np.ndarray  # (nnz,) int32
    weights: np.ndarray  # (nnz,) int32
    nbr: torch.Tensor  # (n, deg_cap) int32, sentinel n beyond degree
    wgt: torch.Tensor  # (n, deg_cap) int32, 0 beyond degree

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def random_graph(
    n: int = 512, avg_deg: int = 4, deg_cap: int = 8, max_weight: int = 64,
    seed: int = 0, device=None,
) -> Graph:
    """Poisson-degree random digraph with positive int weights, out-degree
    clipped to ``deg_cap``; its padded adjacency goes to `device` (the card
    unless the caller names another)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    indptr = np.zeros(n + 1, np.int32)
    indices, weights = [], []
    for u in range(n):
        deg = min(int(rng.poisson(avg_deg)) + 1, deg_cap, n - 1)
        vs = rng.choice(n, size=deg, replace=False)
        vs = vs[vs != u][:deg_cap]
        for v in vs:
            indices.append(int(v))
            weights.append(int(rng.integers(1, max_weight)))
        indptr[u + 1] = len(indices)
    indices = np.asarray(indices, np.int32)
    weights = np.asarray(weights, np.int32)

    nbr = np.full((n, deg_cap), n, np.int32)  # sentinel n == "no edge"
    wgt = np.zeros((n, deg_cap), np.int32)
    deg = np.diff(indptr)
    col = np.arange(deg_cap)[None, :]
    slot = col < deg[:, None]
    nbr[slot] = indices
    wgt[slot] = weights
    return Graph(
        n=n, deg_cap=deg_cap, indptr=indptr, indices=indices,
        weights=weights, nbr=torch.as_tensor(nbr, device=dev),
        wgt=torch.as_tensor(wgt, device=dev),
    )


def bellman_ford(graph: Graph, src: int = 0) -> np.ndarray:
    """Exact distances — the SSSP oracle: (n,) int32 with unreachable
    vertices at INF_KEY, relaxed in int64 so nothing overflows."""
    n = graph.n
    dist = np.full(n, np.int64(INF_KEY))
    dist[src] = 0
    u_of_edge = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(graph.indptr).astype(np.int64)
    )
    v_of_edge = graph.indices.astype(np.int64)
    w_of_edge = graph.weights.astype(np.int64)
    for _ in range(n):
        cand = dist[u_of_edge] + w_of_edge
        cand[dist[u_of_edge] >= INF_KEY] = INF_KEY
        nd = dist.copy()
        np.minimum.at(nd, v_of_edge, cand)
        if np.array_equal(nd, dist):
            break
        dist = nd
    return dist.astype(np.int32)
