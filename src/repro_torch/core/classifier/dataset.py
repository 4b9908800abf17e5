"""Training / test workload generation — §3.1.2 (3) of the paper.

Copy of the grid part of src/repro/core/classifier/dataset.py: a structured
grid for training (so the tree sees the regime boundaries) and uniform-random
tuples for testing, labelled by the port's copy of the analytic cost model.
The reference's trace-derived examples read its `workloads` package, which
the port has not reached yet.
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
