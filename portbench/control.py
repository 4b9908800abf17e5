"""Readings that set the limits of `correct`: the program's sound runs and
the control, several seeds in one process, on the card at a cell's own
size (the benchmark's own runs do not run them).

    python3 portbench/control.py --workload g8b-decode-4k --seeds 1,2,3 \\
        --seconds 51

Each seed's run prints the program's checks and verdict, and the
control's: the cell's family's float32 reference with every matrix in
float8 (for the dense family e4m3, a scale per output column) put in the
program's place.  The token it puts first at each position of the same
sequences goes through the run's own comparison (`systems/serve.py`'s
`judge`, at the configuration's committed limit), whose verdict has to
come out false.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

from portbench import harness  # noqa: E402


def fp8_control(fam, cfg, params, seqs):
    """The token the family's float8 reference puts first at each
    position."""
    return [lg.argmax(dim=-1) for lg in fam.forward(
        cfg, params, seqs, transform=fam.control_transform)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    print(f"[control] card: {harness.card_line()}", flush=True)
    device = torch.device("cuda", 0)
    catalog = harness.Catalog()
    system = catalog.module(
        "systems", catalog.cell(args.workload)["config_file"]["system"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell=catalog.cell(args.workload), seed=seed,
                          seconds=args.seconds, trace=False, device=device,
                          t0=time.perf_counter(), catalog=catalog)
        out = system.run(run, control=fp8_control)
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "correct": out.correct,
                          "checks": out.checks, "e2e": out.e2e,
                          "checked_tokens": out.record["checked_tokens"],
                          "control": out.record.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
