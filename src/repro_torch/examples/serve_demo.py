"""Serving demo: continuous batching with the SmartPQ scheduler.

Counterpart of examples/serve_demo.py: a reduced llama-family model serves
a bursty multi-tenant workload (interactive, standard and batch SLO
classes) on 4 decode slots with `max_seq` 64: 4 bursts of 6 requests, each
followed by 6 idle ticks, at most 400 steps, every request completed.  The
scheduler's queue flips between oblivious (arrival bursts) and delegation
(drain) modes.  The parameters are drawn from a `torch.Generator` seeded
with 0 unless `params` is given; the scheduler draws from its own
generator unless `draws` (its per-tick draws) is given: a test passes the
reference's converted parameters and `jax.random` draws.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.models.registry import build_model
from repro_torch.serve import EngineConfig, Request, ServeEngine

ARCH = "llama3.2-3b"
ENGINE = dict(batch_size=4, max_seq=64)


def bursty_workload(n_bursts=4, burst=6, seed=0):
    """Bursts of mixed-SLO requests with idle gaps (drain phases)."""
    rng = np.random.default_rng(seed)
    workload, uid = [], 0
    for _ in range(n_bursts):
        arrivals = []
        for _ in range(burst):
            arrivals.append(
                Request(
                    uid=uid,
                    prompt_len=int(rng.integers(4, 16)),
                    max_new_tokens=int(rng.integers(2, 6)),
                    slo_class=int(rng.integers(0, 3)),
                )
            )
            uid += 1
        workload.append(arrivals)
        workload.extend([[]] * 6)  # drain gap
    return workload, uid


def serve_demo(device=None, params=None, tree=None, draws=None,
               log=print) -> dict:
    """Run the example; returns the engine and its run's summary."""
    cfg = reduced_config(ARCH)
    if params is None:
        model = build_model(cfg, remat=False, device=device)
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(0))
    engine = ServeEngine(cfg, params, EngineConfig(**ENGINE), device=device,
                         tree=tree, draws=draws)

    workload, total = bursty_workload()
    log(f"serving {total} requests across {len(workload)} ticks "
        f"(batch slots: {ENGINE['batch_size']})")
    summary = engine.run(workload, max_steps=400)
    trace = "".join(str(m) for m in summary["mode_trace"])
    log(f"completed: {summary['completed']}/{total} in {summary['steps']} "
        f"steps ({summary['wall_s']:.1f}s)")
    log(f"scheduler mode trace (0=oblivious, 1=multiq, 2=Nuddle): {trace}")
    log(f"PQ mode transitions: {summary['pq_transitions']}")
    assert summary["completed"] == total
    sample = next(iter(engine.outputs.items()))
    log(f"sample output (uid {sample[0]}): {sample[1]}")
    log("OK — all requests served under SmartPQ continuous batching.")
    return {"engine": engine, "summary": summary, "total": total}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    serve_demo(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
