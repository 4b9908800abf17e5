"""Name -> workload-driver registry, in PyTorch.

Counterpart of src/repro/workloads/registry.py: every entry makes a
replayable `Trace` through ``spec.make_trace(quick, seed)`` — the recorders
run their driver (SSSP, the DES hold model) and capture its op log, the
generators synthesize the stream on the host.  A recorder runs on
`device` (the card unless the caller names another) and passes `draws` or
`generator` through to its driver; a generator ignores all three.
`default_pq` caches one trained decision tree, so enumerating the registry
trains it once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.pqueue.schedules import Schedule
from repro_torch.workloads import des, graphs, sssp, traces

_TREE = None


def default_pq(
    num_shards: int = 8,
    capacity: int = 4096,
    head_width: int | None = None,
    npods: int = 2,
    decision_interval: int = 2,
    mode_schedules: Tuple[Schedule, ...] | None = None,
    eliminate: bool = True,
    device=None,
):
    """A SmartPQ on `device` with the module-cached decision tree (trained
    once per process: the tree depends only on the training set)."""
    global _TREE
    from repro_torch.core.smartpq import SmartPQ, SmartPQConfig

    kwargs = dict(
        num_shards=num_shards, capacity=capacity, head_width=head_width,
        npods=npods, decision_interval=decision_interval,
        eliminate=eliminate,
    )
    if mode_schedules is not None:
        kwargs["mode_schedules"] = mode_schedules
    pq = SmartPQ(SmartPQConfig(**kwargs), tree=_TREE, device=device)
    _TREE = pq.tree
    return pq


def _sssp_trace(quick: bool, seed: int, device=None, draws=None,
                generator: Optional[torch.Generator] = None) -> traces.Trace:
    g = graphs.random_graph(n=128 if quick else 512, seed=seed, device=device)
    pq = default_pq(head_width=256, device=device)
    _, trace = sssp.run_sssp_smartpq(g, pq, m=16, seed=seed, record=True,
                                     draws=draws, generator=generator)
    return trace


def _des_hold_trace(quick: bool, seed: int, device=None, draws=None,
                    generator: Optional[torch.Generator] = None
                    ) -> traces.Trace:
    pq = default_pq(device=device)
    res = des.run_hold_model(
        pq, B=32, K=16 if quick else 64, seed=seed, record=True,
        draws=draws, generator=generator,
    )
    return res.trace


def _des_bursty_trace(quick: bool, seed: int, **_) -> traces.Trace:
    phases = traces.BURSTY_PHASES_QUICK if quick else traces.BURSTY_PHASES
    return traces.bursty_des_trace(phases=phases, seed=seed)


def _phase_flip_trace(quick: bool, seed: int, **_) -> traces.Trace:
    return traces.phase_flip_trace(
        steps_per_phase=4 if quick else 12, seed=seed
    )


def _size_ramp_trace(quick: bool, seed: int, **_) -> traces.Trace:
    return traces.size_ramp_trace(
        steps_per_phase=4 if quick else 10, seed=seed
    )


def _mix_drift_trace(quick: bool, seed: int, **_) -> traces.Trace:
    return traces.mix_drift_trace(steps=16 if quick else 48, seed=seed)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    description: str
    kind: str  # "recorder" (runs a driver) | "generator" (host synthesis)
    make_trace: Callable[..., traces.Trace]


WORKLOADS: Dict[str, WorkloadSpec] = {
    s.name: s
    for s in (
        WorkloadSpec(
            "sssp", "adaptive wavefront-Dijkstra op log (recorded)",
            "recorder", _sssp_trace,
        ),
        WorkloadSpec(
            "des_hold", "DES hold-model churn op log (recorded)",
            "recorder", _des_hold_trace,
        ),
        WorkloadSpec(
            "des_bursty", "bursty M/M/1-style DES arrival process",
            "generator", _des_bursty_trace,
        ),
        WorkloadSpec(
            "phase_flip", "insert-storm/delete-storm square wave",
            "generator", _phase_flip_trace,
        ),
        WorkloadSpec(
            "size_ramp", "queue-size ramp up / plateau / drain",
            "generator", _size_ramp_trace,
        ),
        WorkloadSpec(
            "mix_drift", "gradual insert-fraction drift 0.9 -> 0.1",
            "generator", _mix_drift_trace,
        ),
    )
}


def get(name: str) -> WorkloadSpec:
    if name not in WORKLOADS:
        raise KeyError(
            f"unknown workload {name!r}; registered: {sorted(WORKLOADS)}"
        )
    return WORKLOADS[name]


def names() -> Tuple[str, ...]:
    return tuple(sorted(WORKLOADS))
