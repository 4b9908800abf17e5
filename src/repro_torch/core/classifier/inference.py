"""Branchless decision-tree inference on tensors.

Counterpart of src/repro/core/classifier/inference.py: the trained tree is
packed into flat arrays and evaluated as `depth` rounds of
gather-compare-select on the queue's device, so a step's decision needs no
host round trip of its own (the step reads the resulting mode once, to pick
its schedule).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.classifier.tree import DecisionTree


class PackedTree(NamedTuple):
    feature: torch.Tensor  # (N,) int32, -1 for leaves
    threshold: torch.Tensor  # (N,) float32
    left: torch.Tensor  # (N,) int32 (self-loop for leaves)
    right: torch.Tensor  # (N,) int32
    label: torch.Tensor  # (N,) int32
    depth: int


def pack_arrays(tree: DecisionTree) -> dict:
    """The packed tree as numpy arrays (and its depth)."""
    n = tree.num_nodes
    feature = np.full(n, -1, np.int32)
    threshold = np.zeros(n, np.float32)
    left = np.arange(n, dtype=np.int32)  # leaves self-loop
    right = np.arange(n, dtype=np.int32)
    label = np.zeros(n, np.int32)
    for i, node in enumerate(tree.nodes):
        label[i] = node.label
        if node.feature >= 0:
            feature[i] = node.feature
            threshold[i] = node.threshold
            left[i] = node.left
            right[i] = node.right
    return dict(feature=feature, threshold=threshold, left=left, right=right,
                label=label, depth=tree.max_depth)


def packed_from_arrays(arrays, device) -> PackedTree:
    """A `PackedTree` on `device` from numpy arrays named like its fields."""
    t = {f: torch.as_tensor(np.asarray(arrays[f]), device=device)
         for f in ("feature", "threshold", "left", "right", "label")}
    if t["threshold"].dtype != torch.float32 or any(
            t[f].dtype != torch.int32
            for f in ("feature", "left", "right", "label")):
        raise TypeError("packed tree: int32 arrays and float32 thresholds")
    return PackedTree(depth=int(arrays["depth"]), **t)


def pack_tree(tree: DecisionTree, device) -> PackedTree:
    return packed_from_arrays(pack_arrays(tree), device)


def tree_predict(packed: PackedTree, features: torch.Tensor) -> torch.Tensor:
    """features: (F,) float32 -> () int32 class: `depth` rounds of
    gather-compare-select; leaves self-loop, so early arrival is harmless."""
    return tree_predict_batch(packed, features[None, :])[0]


def tree_predict_batch(packed: PackedTree,
                       features: torch.Tensor) -> torch.Tensor:
    """(N, F) float32 -> (N,) int32 classes."""
    n = features.shape[0]
    node = torch.zeros((n,), dtype=torch.int64, device=features.device)
    for _ in range(packed.depth):
        f = packed.feature[node]
        thr = packed.threshold[node]
        x = torch.gather(features, 1, torch.clamp(f, min=0).to(torch.int64)
                         [:, None])[:, 0]
        nxt = torch.where(x <= thr, packed.left[node], packed.right[node])
        node = torch.where(f >= 0, nxt, node.to(torch.int32)).to(torch.int64)
    return packed.label[node]
