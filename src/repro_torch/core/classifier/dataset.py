"""Training / test workload generation — §3.1.2 (3) of the paper.

Copy of src/repro/core/classifier/dataset.py: a structured grid for
training (so the tree sees the regime boundaries), uniform-random tuples for
testing, and examples derived from operation traces
(`examples_from_trace`), all labelled by the port's copy of the analytic
cost model.  `make_mixed_training_set` folds the trace examples into the
grid, so the tree also sees the correlated feature paths applications walk.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.classifier.cost_model import (
    MeshGeom,
    TPU_V5E,
    Workload,
    best_mode,
    mode_throughputs,
)
from repro_torch.core.classifier.features import featurize

# Paper-aligned sweep values (§4 uses sizes 1K..8M, ranges 2K..200M,
# threads 1..64; rescaled to a 512-chip fleet).
TRAIN_CLIENTS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 384, 512)
TRAIN_SIZES = (256, 1024, 4096, 16384, 65536, 262144, 1048576, 8388608)
TRAIN_RANGES = (2048, 16384, 131072, 1048576, 16777216, 201326592)
TRAIN_MIXES = (0.0, 0.1, 0.25, 0.4, 0.5, 0.6, 0.75, 0.9, 1.0)
# 11 * 8 * 6 * 9 = 4752 training workloads (paper: 5525).


def make_training_set(
    hw=TPU_V5E, geom: MeshGeom = MeshGeom()
) -> Tuple[np.ndarray, np.ndarray]:
    feats, labels = [], []
    for d in TRAIN_CLIENTS:
        for z in TRAIN_SIZES:
            for k in TRAIN_RANGES:
                for p in TRAIN_MIXES:
                    w = Workload(d, z, k, p)
                    feats.append(featurize(d, z, k, p))
                    labels.append(best_mode(w, hw, geom))
    return np.stack(feats), np.asarray(labels, np.int32)


def examples_from_trace(
    trace, window: int = 8, hw=TPU_V5E, geom: MeshGeom = MeshGeom()
) -> Tuple[np.ndarray, np.ndarray]:
    """Labelled classifier examples from a recorded or generated op trace:
    walk it in windows, derive the Table-1 features the device featurizer
    would see (active clients from the trace, queue size from the running
    insert/delete balance clamped at empty, the window's insert fraction
    and key spread) and label each window with the cost model's
    `best_mode`."""
    from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT
    from repro_torch.core.pqueue.state import INF_KEY

    ops, keys, nc = trace.ops, trace.keys, trace.num_clients
    K = ops.shape[0]
    feats, labels = [], []
    # a recorded trace carries its driver's pre-fill: the standing backlog
    # every window's Size feature rides on
    size = int(np.sum(trace.init_keys < INF_KEY)) if trace.init_keys.size \
        else 0
    for lo in range(0, K, window):
        hi = min(lo + window, K)
        o, k = ops[lo:hi], keys[lo:hi]
        ins = (o == OP_INSERT) & (k < INF_KEY)
        n_ins = int(np.sum(ins))
        n_del = int(np.sum(o == OP_DELETE_MIN))
        size = max(size + n_ins - n_del, 0)
        frac = n_ins / max(n_ins + n_del, 1)
        ik = k[ins]
        key_range = int(ik.max()) - int(ik.min()) + 1 if ik.size else 1
        d = max(int(round(float(np.mean(nc[lo:hi])))), 1)
        w = Workload(d, max(size, 1), max(key_range, 1), frac)
        feats.append(featurize(d, max(size, 1), max(key_range, 1), frac))
        labels.append(best_mode(w, hw, geom))
    return np.stack(feats), np.asarray(labels, np.int32)


def _standard_traces(seeds: Tuple[int, ...]):
    """The host generators of `workloads.traces` (no driver runs, so the
    training set stays cheap to build).  Imported lazily: workloads sits
    above the classifier."""
    from repro_torch.workloads import traces as T

    for seed in seeds:
        yield T.phase_flip_trace(seed=seed)
        yield T.size_ramp_trace(seed=seed)
        yield T.mix_drift_trace(seed=seed)
        yield T.bursty_des_trace(seed=seed)


def make_trace_training_set(
    seeds: Tuple[int, ...] = (0, 1, 2, 3, 4, 5), window: int = 4,
    hw=TPU_V5E, geom: MeshGeom = MeshGeom(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Application-shaped examples from the standard workload generators."""
    xs, ys = [], []
    for trace in _standard_traces(seeds):
        X, y = examples_from_trace(trace, window=window, hw=hw, geom=geom)
        xs.append(X)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def make_trace_test_set(
    seeds: Tuple[int, ...] = (101, 102, 103), window: int = 4,
    hw=TPU_V5E, geom: MeshGeom = MeshGeom(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Held-out trace examples (disjoint generator seeds)."""
    return make_trace_training_set(seeds=seeds, window=window, hw=hw,
                                   geom=geom)


def make_mixed_training_set(
    hw=TPU_V5E, geom: MeshGeom = MeshGeom(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Analytic grid + trace-derived examples."""
    Xg, yg = make_training_set(hw=hw, geom=geom)
    Xt, yt = make_trace_training_set(hw=hw, geom=geom)
    return np.concatenate([Xg, Xt]), np.concatenate([yg, yt])


def make_test_set(
    n: int = 10780, seed: int = 7, hw=TPU_V5E, geom: MeshGeom = MeshGeom()
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random off-grid workloads (paper §4.2.1: 10780).  Returns
    (features, labels, misprediction_cost_basis) where the basis row i holds
    the effective throughput of every algorithmic mode (indexed by class id)
    for the paper's misprediction-cost metric ((X - Y)/Y)."""
    rng = np.random.default_rng(seed)
    feats, labels, basis = [], [], []
    for _ in range(n):
        d = int(rng.integers(1, geom.chips + 1))
        z = int(2 ** rng.uniform(6, 24))
        k = int(2 ** rng.uniform(8, 28))
        p = float(rng.uniform(0, 1))
        w = Workload(d, z, k, p)
        feats.append(featurize(d, z, k, p))
        labels.append(best_mode(w, hw, geom))
        basis.append(mode_throughputs(w, hw, geom))
    return np.stack(feats), np.asarray(labels, np.int32), np.asarray(basis)
