"""Single-Source Shortest Paths over the concurrent PQ: the paper's
motivating graph application (§1), a thin wrapper over
`repro_torch.workloads.sssp`.

Counterpart of examples/sssp.py, which compares the schedules on
`random_graph(n=512, seed=0)`:

  * exact mode (HIER / Nuddle): every wavefront is the true global minimum;
    wasted pops are only same-batch collisions, but each step pays the
    hierarchical tournament;
  * relaxed mode (SPRAY / MULTIQ): collective-free deleteMin, but priority
    inversion causes stale pops (wasted re-relaxations);
  * adaptive SmartPQ: the decision tree picks the mode every step, on the
    device.

The oracle is `workloads.graphs.bellman_ford`; every schedule must converge
to its distances bit for bit.  A run draws from a `torch.Generator` seeded
with its seed, or takes `draws[name]` (the engine's per-step draws with a
leading step axis: a test passes the reference's `jax.random` draws).

    PYTHONPATH=src python -m repro_torch.examples.sssp [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.pqueue.schedules import Schedule
from repro_torch.workloads import (bellman_ford, default_pq, random_graph,
                                   run_sssp, run_sssp_smartpq)

FIXED = (
    ("exact/Nuddle(HIER)", Schedule.HIER),
    ("relaxed/SprayList", Schedule.SPRAY_HERLIHY),
    ("relaxed/MultiQueue", Schedule.MULTIQ),
)
ADAPTIVE = "adaptive/SmartPQ"


def sssp_demo(device=None, draws=None, log=print) -> dict:
    """Run the example; returns the Bellman-Ford distances and each run's
    `SSSPResult` by name."""
    draws = draws or {}
    g = random_graph(n=512, seed=0, device=device)
    ref = bellman_ford(g)
    log(f"graph: {g.n} vertices, {g.num_edges} edges")
    runs = {}
    for name, sched in FIXED:
        r = run_sssp(g, sched, m=32, seed=1, draws=draws.get(name))
        ok = np.array_equal(r.dist, ref)
        log(f"{name:22s} correct={ok} steps={r.steps} pops={r.pops} "
            f"wasted={r.wasted} "
            f"({100.0 * r.wasted / max(r.pops, 1):.1f}% overhead)")
        assert ok, f"{name} produced wrong distances"
        runs[name] = r

    pq = default_pq(head_width=256, device=g.nbr.device)
    r, _ = run_sssp_smartpq(g, pq, m=16, seed=1, draws=draws.get(ADAPTIVE))
    ok = np.array_equal(r.dist, ref)
    log(f"{ADAPTIVE:22s} correct={ok} steps={r.steps} "
        f"pops={r.pops} wasted={r.wasted} "
        f"modes={sorted(set(r.modes.tolist()))} "
        f"transitions={r.transitions}")
    assert ok, "adaptive SmartPQ produced wrong distances"
    runs[ADAPTIVE] = r
    log("OK — every mode converges to Bellman-Ford; relaxed modes pay "
        "wasted re-relaxations, exact modes pay collectives: the SmartPQ "
        "trade-off.")
    return {"ref": ref, "runs": runs}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    sssp_demo(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
