"""Time the builds of one kernel from several source trees against each
other on one card, in turns.

    PYTHONPATH=src python -m repro_torch.kernels.compare \\
        --tree parent=build/parent \\
        --tree this=. [--kernels elim_sort,merge_sorted] \\
        [--rounds 4] [--json build/compare.json]

Each ``--tree NAME=ROOT`` names a checkout of this repository (relative
paths are taken from the repository root); its kernel sources,
``ROOT/src/repro_torch/kernels/csrc``, are built with `kernels.build`'s
flags into ``build/compare/NAME/``.  The trees' kernels must share the C
interface of this tree's wrappers (`kernels.ops`), which launch each
tree's build in turn (`build.use`).  For every kernel and shape of
`SHAPES` the script makes one input from ``--seed``, checks every tree's
output against the plain version (bit-equal, or it exits 1 without
timing; a tree whose launcher refuses the shape is left out of that
shape's timing), then reads each tree's device time (`timing.graph_ms`, as
`chip_smoke.py`'s phase 2 does) ``--rounds`` times, the trees in order in
even rounds and in reverse in odd ones (A B, B A, ...).  It prints every
reading and each tree's median, in µs, with the card's name and power
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from . import build
from . import ops as KO
from . import ref as KR
from .timing import card_line, graph_ms

INF_KEY = 2**31 - 1
# The label of `merge_sorted`'s case whose rows hold equal (key, val) words
# across buffer and run: all vals 0, keys in [0, 8).
DUPLICATES = "duplicate (key, val) words"

# (shape, label): the main path's shapes, then shapes off it
SHAPES = {
    "windowed_merge": [
        ((16, 256, 64), "step insert"),
        ((16, 256, 57), "path C Fig. 11 step insert"),
        ((16, 256, 22), "path C Fig. 10 c_mix step insert"),
        ((16, 256, 4096), "prefill insert"),
    ],
    "twochoice_pick": [
        ((16, 22), "path C Fig. 10 c_mix"),
        ((16, 57), "path C Fig. 11"),
        ((16, 64), "path D"),
        ((16, 128), "off the main path: m > 64"),
        ((40, 100), "off the main path: S > 32"),
    ],
    "elim_sort": [
        ((64, 64), "paths A, B, D op log"),
        ((84, 57), "path C Fig. 11 op log"),
        ((30, 22), "path C Fig. 10 c_mix op log"),
        ((1, 16), "validation"),
        ((4, 64), "validation"),
        ((6, 37), "validation"),
        ((8, 128), "validation"),
        ((2, 1000), "off the main path: B > 256, block body"),
    ],
    "merge_sorted": [
        ((8, 1024, 128), "tuning shape; no caller on any path"),
        ((4, 64, 16), "validation"),
        ((2, 256, 7), "validation"),
        ((1, 64, 1), "validation"),
        ((4, 256, 64), DUPLICATES),
        ((2, 4096, 4096), "R = C"),
        ((1, 16384, 4), "C = 16384, the widest row"),
    ],
}


def _sorted_rows(rng, S, W, hi=200):
    """Ascending rows of W keys in [0, hi), each INF-padded after a length
    drawn from [0, W], as `chip_smoke.py` makes them."""
    out = np.full((S, W), INF_KEY, np.int32)
    for s in range(S):
        n = rng.integers(0, W + 1)
        out[s, :n] = np.sort(rng.integers(0, hi, n)).astype(np.int32)
    return out


def _case(name, shape, label, rng, dev):
    """(wrapper, its arguments, plain version) of one kernel at one shape,
    on inputs made as `chip_smoke.py`'s phase 2 makes them."""
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    if name == "windowed_merge":
        S, H, R = shape
        args = (
            _sorted_rows(rng, S, H),
            rng.integers(0, 1 << 20, (S, H)).astype(np.int32),
            np.tile(np.arange(H, dtype=np.int32), (S, 1)),
            _sorted_rows(rng, S, R),
            rng.integers(0, 1 << 20, (S, R)).astype(np.int32),
            1000 + np.tile(np.arange(R, dtype=np.int32), (S, 1)),
        )
        return KO.windowed_merge, tuple(t(a) for a in args), \
            KR.windowed_merge_ref
    if name == "twochoice_pick":
        S, m = shape
        head = rng.integers(0, 1 << 20, (S, 256)).astype(np.int32)
        head[:, 0] = rng.integers(0, 2 * S, S)  # close minima: some ties
        a, b = (rng.integers(0, S, m).astype(np.int32) for _ in range(2))
        act = rng.random(m) < 0.8
        return KO.twochoice_counts, (t(head)[:, 0], t(a), t(b), t(act)), \
            KR.twochoice_counts_ref
    if name == "elim_sort":
        R, B = shape
        keys = rng.integers(0, 64, (R, B)).astype(np.int32)
        keys[rng.random((R, B)) < 0.3] = INF_KEY
        tags = np.tile(np.arange(B, dtype=np.int32), (R, 1))
        return KO.elim_sort, (t(keys), t(tags)), KR.elim_sort_ref
    if name == "merge_sorted":
        S, C, R = shape
        if label == DUPLICATES:
            args = (_sorted_rows(rng, S, C, hi=8), np.zeros((S, C), np.int32),
                    _sorted_rows(rng, S, R, hi=8), np.zeros((S, R), np.int32))
        else:
            args = (_sorted_rows(rng, S, C),
                    np.tile(np.arange(C, dtype=np.int32), (S, 1)),
                    _sorted_rows(rng, S, R),
                    (1 << 20) + np.tile(np.arange(R, dtype=np.int32), (S, 1)))
        return KO.merge_sorted_runs, tuple(t(a) for a in args), \
            KR.merge_sorted_runs_ref
    raise ValueError(f"compare: no inputs for kernel {name!r}")


def _same(got, want) -> bool:
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    return all(g.shape == w.shape and torch.equal(g.cpu(), w.cpu())
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    metavar="NAME=ROOT")
    ap.add_argument("--kernels", default=",".join(SHAPES))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 2
    names = args.kernels.split(",")
    trees = []
    for spec in args.tree:
        tag, _, root = spec.partition("=")
        root = Path(root)
        if not root.is_absolute():
            root = build.REPO_ROOT / root
        trees.append((tag, root / "src" / "repro_torch" / "kernels" / "csrc"))
    libs = {}
    for tag, csrc in trees:
        out = build.build_all(csrc, build.REPO_ROOT / "build" / "compare" /
                              tag / build.source_digest(csrc), names)
        for name in names:
            lib = ctypes.CDLL(str(out / f"{name}.so"))
            build.bind(name, lib)
            libs[tag, name] = lib
    card = card_line()
    print(f"compare: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | trees "
          + ", ".join(f"{tag}={csrc}" for tag, csrc in trees), flush=True)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    result = {"card": card, "trees": [t for t, _ in trees], "rows": []}
    for name in names:
        for shape, label in SHAPES[name]:
            kernel, kargs, plain = _case(name, shape, label, rng, dev)
            want = plain(*kargs)
            timed = []
            for tree in trees:
                tag = tree[0]
                with build.use(name, libs[tag, name]):
                    try:
                        got = kernel(*kargs)
                    except RuntimeError as e:  # the launcher refused it
                        print(f"  {name} {shape} [{label}] tree {tag}: {e}",
                              flush=True)
                        continue
                    if not _same(got, want):
                        print(f"compare: {name} {shape} of tree {tag} "
                              f"disagrees with its plain version",
                              file=sys.stderr)
                        return 1
                timed.append(tree)
            reads = {tag: [] for tag, _ in timed}
            for r in range(args.rounds):
                order = timed if r % 2 == 0 else timed[::-1]
                for tag, _ in order:
                    with build.use(name, libs[tag, name]):
                        reads[tag].append(graph_ms(lambda: kernel(*kargs)))
            row = {"kernel": name, "shape": list(shape), "label": label,
                   "device_ms": reads,
                   "median_ms": {k: statistics.median(v)
                                 for k, v in reads.items()}}
            result["rows"].append(row)
            print(f"  {name} {shape} [{label}] device us, median (readings): "
                  + "; ".join(
                      f"{k} {row['median_ms'][k] * 1e3:.3f} ("
                      + ", ".join(f"{x * 1e3:.3f}" for x in v) + ")"
                      for k, v in reads.items()), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
