"""The reference's own dry run of one cell, for tests/test_torch_dryrun.py:
lowers and compiles the cell on the production mesh of 512 virtual CPU
devices (src/repro/launch/dryrun.py's `lower_cell`) and prints its record
as one JSON line.  Run in a fresh interpreter with
XLA_FLAGS=--xla_force_host_platform_device_count=512:

    python tests/torch_dryrun_ref.py gemma-2b decode_32k --serve-tp-only
"""

import argparse
import contextlib
import io
import json
import os

assert "512" in os.environ.get("XLA_FLAGS", "")

from repro.launch.dryrun import lower_cell  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("arch")
ap.add_argument("shape")
ap.add_argument("--multi-pod", action="store_true")
ap.add_argument("--serve-tp-only", action="store_true")
args = ap.parse_args()
with contextlib.redirect_stdout(io.StringIO()):
    rec = lower_cell(args.arch, args.shape, args.multi_pod,
                     serve_tp_only=args.serve_tp_only)
print(json.dumps(rec))
