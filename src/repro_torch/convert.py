"""Carry the JAX package's state across to the port, as numpy arrays.

A PQ state, a SmartPQ carry, a packed decision tree or a model's parameter
tree of the reference becomes the port's counterpart on `device` (the card
unless the caller names another), and back.  Input is numpy arrays named
like the reference's fields (the 11 `PQState` leaves, the 12 `SmartPQStats`
fields, the 5 packed-tree arrays and its depth, the parameter tree's key
paths), so this module never touches a jax array: the caller converts with
`numpy.asarray` (`jax.tree.map(np.asarray, params)` for a parameter tree).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.classifier.inference import PackedTree, packed_from_arrays
from repro_torch.core.pqueue.state import PQState
from repro_torch.core.smartpq import SmartPQCarry, SmartPQStats
from repro_torch.models import params as P
from repro_torch.utils.hostsync import resolve_device

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(PQState))
STATS_FIELDS = SmartPQStats._fields


def _int32(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.int32:
        raise TypeError(f"{name}: expected int32, got {a.dtype}")
    return torch.as_tensor(np.array(a, order="C"), device=device)


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> PQState:
    """`PQState` on `device` from its 11 int32 leaves, by field name."""
    dev = resolve_device(device)
    return PQState(**{f: _int32(f, arrays[f], dev) for f in STATE_FIELDS})


def state_to_numpy(state: PQState) -> Dict[str, np.ndarray]:
    return {f: getattr(state, f).detach().cpu().numpy() for f in STATE_FIELDS}


def carry_from_numpy(state: Mapping[str, np.ndarray],
                     stats: Mapping[str, np.ndarray],
                     device=None) -> SmartPQCarry:
    """`SmartPQCarry` on `device` from the state leaves and the 12 stats
    fields, by name."""
    dev = resolve_device(device)
    return SmartPQCarry(
        state_from_numpy(state, dev),
        SmartPQStats(**{f: _int32(f, stats[f], dev) for f in STATS_FIELDS}),
    )


def carry_to_numpy(carry: SmartPQCarry):
    """(state arrays, stats arrays), by field name."""
    return state_to_numpy(carry.state), {
        f: getattr(carry.stats, f).detach().cpu().numpy()
        for f in STATS_FIELDS}


def packed_tree_from_numpy(arrays: Mapping[str, object],
                           device=None) -> PackedTree:
    """`PackedTree` on `device` from feature, threshold, left, right, label
    and depth."""
    return packed_from_arrays(arrays, resolve_device(device))


def params_from_numpy(tree: Mapping[str, object], cfg, device=None,
                      dtype: torch.dtype = torch.bfloat16,
                      model_axis: int = 1) -> Dict:
    """The port's parameter tree on `device` from the reference's
    `init_params` tree of numpy arrays, leaf for leaf by key path, each in
    `dtype` (but `params.F32_LEAVES`).  Raises unless the key paths and
    shapes are those of `cfg`'s tree."""
    dev = resolve_device(device)
    want = dict(P.leaves(P.param_layout(cfg, model_axis)))
    got = dict(P.leaves(tree))
    if sorted(got) != sorted(want):
        raise KeyError(f"{cfg.name}: key paths {sorted(got)} are not the "
                       f"config's {sorted(want)}")
    out: Dict = {}
    for path in want:
        a = np.asarray(got[path])
        if a.shape != want[path][0]:
            raise ValueError(f"{path}: shape {a.shape}, expected "
                             f"{want[path][0]}")
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = torch.as_tensor(np.array(a, np.float32)).to(
            device=dev, dtype=P.leaf_dtype(path, dtype))
    return out


def params_to_numpy(params: Mapping[str, object]) -> Dict:
    """The nested dict of float32 numpy arrays `params_from_numpy` takes
    (a bf16 leaf widens exactly)."""
    return {k: params_to_numpy(v) if isinstance(v, Mapping)
            else v.detach().float().cpu().numpy() for k, v in params.items()}
