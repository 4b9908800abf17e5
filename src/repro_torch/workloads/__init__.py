"""Application workloads that drive the port (counterpart of
src/repro/workloads): CSR random graphs and the Bellman-Ford oracle
(`graphs`), the wavefront-Dijkstra SSSP engines (`sssp`), the DES hold
model and its heapq oracle (`des`), the `Trace` format with save, load,
replay and the phased generators (`traces`), and the name -> driver table
(`registry`), and the serving tier's open-loop request streams
(`open_loop_requests`, `bursty_serve_workload`)."""

from repro_torch.workloads.graphs import Graph, bellman_ford, random_graph
from repro_torch.workloads.sssp import (
    SSSPResult,
    make_smartpq_sssp_engine,
    make_sssp_engine,
    run_sssp,
    run_sssp_smartpq,
)
from repro_torch.workloads.des import (
    DESResult,
    hold_model_oracle,
    make_hold_engine,
    run_hold_model,
)
from repro_torch.workloads.traces import (
    Trace,
    bursty_des_trace,
    bursty_serve_workload,
    load_trace,
    mix_drift_trace,
    mmpp_arrival_counts,
    open_loop_requests,
    phase_flip_trace,
    phased_trace,
    poisson_arrival_counts,
    prefill,
    replay,
    save_trace,
    size_ramp_trace,
)
from repro_torch.workloads.registry import WORKLOADS, WorkloadSpec, default_pq

__all__ = [
    "Graph", "bellman_ford", "random_graph",
    "SSSPResult", "make_smartpq_sssp_engine", "make_sssp_engine",
    "run_sssp", "run_sssp_smartpq",
    "DESResult", "hold_model_oracle", "make_hold_engine", "run_hold_model",
    "Trace", "bursty_des_trace", "bursty_serve_workload", "load_trace",
    "mix_drift_trace", "mmpp_arrival_counts", "open_loop_requests",
    "phase_flip_trace", "phased_trace",
    "poisson_arrival_counts", "prefill", "replay", "save_trace",
    "size_ramp_trace",
    "WORKLOADS", "WorkloadSpec", "default_pq",
]
