"""A durable serving process the supervisor can run.

Counterpart of src/repro/serve/worker.py, with the same command line and
result JSON, plus ``--device`` (the card unless it names another) and a
``recover`` entry in the result.  One incarnation regenerates the
deterministic workload from (seed, steps), builds a durable `ServeEngine`
rooted at ``--dir``, recovers (a directory holding a snapshot and a log
resumes where the previous incarnation died; an empty one is a fresh run)
and runs it.  The incarnation that finishes writes one atomic result JSON:
the summary, `health()`, the completion set, the conservation ledger, the
done steps, a CRC of the outputs and the carry's fingerprint, which the
crash drills compare between an uninterrupted run and a killed and
recovered one.

``--sigkill-at-step N`` arms the `crash_at_step` injector: the process
SIGKILLs itself when the engine-step clock reaches N, after the window's
arrivals reached the log and before its commit.  With ``--crash-marker
PATH`` the kill is one-shot, so the same command line works as a
supervised child: the first incarnation dies, the restart completes.

    python -m repro_torch.serve.worker --dir STORE --out RESULT.json \
        --steps 24 --seed 3 --window 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

from repro_torch.core import persist
from repro_torch.serve.engine import EngineConfig, ServeEngine


def build_engine(args: argparse.Namespace) -> ServeEngine:
    slo = None
    if args.slo_targets:
        slo = tuple(float(x) for x in args.slo_targets.split(","))
    ecfg = EngineConfig(
        batch_size=args.batch,
        sched_window=args.window,
        slo_targets=slo,
        durable_dir=args.dir,
        wal_fsync=not args.no_fsync,
        snapshot_interval=args.snapshot_interval,
        keep_snapshots=args.keep_snapshots,
    )
    return ServeEngine(None, None, ecfg, seed=args.seed, device=args.device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", required=True,
                    help="durable store root (WAL + snapshots + heartbeat)")
    ap.add_argument("--out", default=None,
                    help="result JSON path (atomic write)")
    ap.add_argument("--steps", type=int, default=48,
                    help="workload length in engine steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--window", type=int, default=1,
                    help="scheduler window K (ticks per fused device call)")
    ap.add_argument("--max-steps", type=int, default=10_000)
    ap.add_argument("--snapshot-interval", type=int, default=4)
    ap.add_argument("--keep-snapshots", type=int, default=2)
    ap.add_argument("--no-fsync", action="store_true")
    ap.add_argument("--slo-targets", default="",
                    help="comma-separated p99 targets; empty = open loop")
    ap.add_argument("--sigkill-at-step", type=int, default=-1,
                    help="SIGKILL self at this engine step (fault drill)")
    ap.add_argument("--crash-marker", default="",
                    help="marker file making --sigkill-at-step one-shot")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.workloads.traces import bursty_serve_workload

    workload: List[List] = bursty_serve_workload(
        steps=args.steps, seed=args.seed
    )
    total_requests = sum(len(tick) for tick in workload)

    eng = build_engine(args)
    if args.sigkill_at_step >= 0:
        from repro_torch.faults import FaultSpec, inject

        inject(eng, FaultSpec(
            "crash_at_step",
            magnitude=float(args.sigkill_at_step),
            variant=args.crash_marker,
        ))

    t0 = time.perf_counter()
    recovered = eng.recover()
    recovered["seconds"] = time.perf_counter() - t0
    summary = eng.run(workload, max_steps=args.max_steps)
    health = eng.health()

    # Request conservation: every submitted arrival is accounted for as
    # inserted, still backlogged, shed, or evicted — and every insert is
    # either dispatched or still on device.  The recovery tests assert
    # this ledger matches an uninterrupted run's exactly.
    conservation = {
        "total_requests": total_requests,
        "inserted": health["inserted"],
        "arrival_backlog": health["arrival_backlog"],
        "shed": health["shed"],
        "evicted": health["evicted"],
        "dispatched": health["dispatched"],
        "on_device": health["on_device"],
        "admitted_ok": (
            health["inserted"] + health["arrival_backlog"]
            + health["shed"] + health["evicted"] == total_requests
        ),
        "dispatch_ok": (
            health["inserted"]
            == health["dispatched"] + health["on_device"]
        ),
    }

    from repro_torch.core.smartpq import carry_fingerprint

    done = sorted(eng.done_step)
    result = {
        "summary": {k: v for k, v in summary.items() if k != "wall_s"},
        "wall_s": summary["wall_s"],
        "health": health,
        "conservation": conservation,
        "completions": done,
        "done_step": {str(u): eng.done_step[u] for u in done},
        "outputs_crc": _outputs_crc(eng.outputs),
        "carry_crc": carry_fingerprint(eng.scheduler.carry),
        "recover": recovered,
    }
    if args.out:
        persist.atomic_write_json(args.out, result, indent=2)
    else:
        import json

        print(json.dumps(result["conservation"]))
    eng.durability.close()
    ok = conservation["admitted_ok"] and conservation["dispatch_ok"]
    return 0 if ok else 3


def _outputs_crc(outputs) -> int:
    """Order-insensitive CRC over every request's emitted token list —
    completion CONTENT identity, complementing the carry fingerprint's
    device-state identity."""
    import json
    import zlib

    blob = json.dumps(
        {str(u): outputs[u] for u in sorted(outputs)},
        separators=(",", ":"),
    ).encode()
    return zlib.crc32(blob) & 0xFFFFFFFF


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["build_engine", "main"]
