"""Run one cell of the benchmark of the PyTorch + CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine that holds the cards the cell
asks for.  With ``--trace 0`` the last line of standard output is the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a run with ranges and the profiler on.  Either way the run checks what
the timed path produced against the plain reference under
`portbench/ref/`, prints each number compared beside its limit as the last
lines of standard error, and reports `correct`.  It exits non-zero, with no
result, where there is no card or too few, where the cell is unknown, and
where the process holds the JAX stack or the JAX package once the window
has closed.
"""

import time


def _process_start() -> float:
    """The process's start on `time.perf_counter`'s clock (Linux: its start
    tick in /proc against the uptime; now, where that cannot be read or
    reads no sound age)."""
    now = time.perf_counter()
    try:
        import os

        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - age if 0.0 <= age < 60.0 else now


T0 = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    catalog = harness.Catalog()
    cell = catalog.cell(args.workload)
    harness.cache_env()
    harness.one_thread()

    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card "
              "and does not fall back to the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} cards, the machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"[portbench] card: {harness.card_line()}", flush=True)
    e2e, per = harness.cell_metrics(bench, cell["name"])
    system = catalog.module("systems", cell["config_file"]["system"])
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t0=T0, catalog=catalog)
    out = system.run(run)

    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window",
              file=sys.stderr)
        return 4
    metrics = {}
    if args.trace:
        for m in per:
            value = catalog.module("metrics", m["name"]).read(out.record)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
    else:
        for m in e2e:
            metrics[m["name"]] = (out.e2e[m["name"]], m["unit"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(out.peak_bytes)}
    breakdown = None
    if args.trace:
        trace = out.record["trace"]
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        breakdown = trace["breakdown"]
    for name, value, limit in out.checks:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(out.correct, out.attempted, out.failed,
                              metrics, device, out.checks, breakdown),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
