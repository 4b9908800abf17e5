"""Quickstart: the adaptive priority queue in 60 lines.

Counterpart of examples/quickstart.py: a 16-shard SmartPQ (capacity 4096,
2 pods, a decision every 4 steps) takes 12 steps of 64 inserts, then 12
steps of 64 deleteMins, with 512 clients, and must change mode at least
once.  The steps' random draws come from a `torch.Generator` seeded with
0, or from `draws` (`SmartPQ.step`'s, with a leading step axis: a test
passes the reference's `jax.random` draws).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT
from repro_torch.core.pqueue.state import INF_KEY
from repro_torch.core.smartpq import SmartPQ, SmartPQConfig

B = 64
STEPS = 12  # a phase


def quickstart(device=None, draws=None, tree=None, log=print) -> dict:
    """Run the example; returns the final carry, the queue's size and mode
    after each phase, the transitions and the drained keys."""
    pq = SmartPQ(SmartPQConfig(num_shards=16, capacity=4096, npods=2,
                               decision_interval=4), tree=tree, device=device)
    dev = pq.device
    carry = pq.init()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)
    lanes = torch.arange(B, **i32)

    def step(t, carry, ops, keys, vals):
        d = None if draws is None else tuple(x[t].to(dev) for x in draws)
        return pq.step(carry, ops, keys, vals, draws=d, num_clients=512,
                       generator=gen)

    log("phase 1: insert burst (low contention -> oblivious mode expected)")
    for i in range(STEPS):
        ops = torch.full((B,), OP_INSERT, **i32)
        keys = torch.as_tensor(rng.integers(0, 1 << 20, B), **i32)
        carry, _ = step(i, carry, ops, keys, lanes)
    inserted = (int(carry.state.total_size), int(carry.stats.mode))
    log(f"  size={inserted[0]} mode={inserted[1]} "
        f"(0=oblivious/spray, 1=multiq, 2=aware/Nuddle)")

    log("phase 2: deleteMin storm (high contention -> aware mode expected)")
    drained = []
    for i in range(STEPS):
        ops = torch.full((B,), OP_DELETE_MIN, **i32)
        carry, res = step(STEPS + i, carry, ops,
                          torch.full((B,), INF_KEY, **i32),
                          torch.zeros(B, **i32))
        drained.extend(res.keys[: int(res.n_out)].tolist())
    size, mode = int(carry.state.total_size), int(carry.stats.mode)
    transitions = int(carry.stats.transitions)
    log(f"  size={size} mode={mode} transitions={transitions}")
    log(f"  first 10 drained keys (ascending-ish): {drained[:10]}")
    assert transitions >= 1, "expected at least one adaptation"
    log("OK — SmartPQ adapted between algorithmic modes with zero data "
        "movement.")
    return {"carry": carry, "inserted": inserted, "size": size,
            "mode": mode, "transitions": transitions, "drained": drained}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    quickstart(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
