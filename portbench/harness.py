"""The benchmark's general parts: finding cells, configurations, traffic
generators, systems and per-layer metrics by name; the card's identity;
the profiler's trace reduced to busy time, idle gaps and device time by
range; the card's busy time over a window run in profiled chunks
(`CardClock`); and the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own under the benchmark's folders:

    configs/<config>.json     a deployment: its source, sizes, cuts, the
                              `system` that serves it and, for a model,
                              its `family`
    workloads/<cell>.json     a cell: its configuration, traffic mix,
                              chips and why
    mixes/<mix>.json          a traffic mix: its `kind` and parameters
    traffic/<kind>.py         one generator per traffic kind
    systems/<system>.py       one driver per system kind
    families/<family>.py      one module per model family, all of the
                              model that a system module takes
    metrics/<metric>.py       one reader per per-layer metric

A family module gives only what is the model's: `model_config(cfg)` (the
program's `ModelConfig`), `make_weights(cfg, seed, device, dtype=None)`
(on the device, from the seed), `forward(cfg, params, seqs,
transform=None)` (the plain float32 reference: logits per sequence),
`control_transform` (the control's lower precision, a `transform` of
`forward`), `token_flops(cfg, context)` and `step_bytes(cfg, contexts,
slots)` (a decoded token's FLOPs and a step's least bytes),
`state_row_bytes(cfg)` (a position's cache bytes) and `ATTENTION`, the
(module, attribute) of its attention call.  The comparison that decides
`correct` and the names of the traced ranges are the system module's; the limit
of that comparison is the configuration's own.

A `Catalog` looks each name up in its roots in order, so a cell or a
family added in another directory needs no edit of a file that is here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# Names whose modules the benchmark's process may never hold: the JAX
# stack and the JAX package (compared as whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# One NVIDIA H100 (SXM), NVIDIA's data sheet, dense: bf16 tensor FLOP/s
# and HBM3 bytes/s at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


@dataclasses.dataclass
class Run:
    """What a system's driver is given: the cell (with its configuration
    under ``config_file``), the seed, the window's seconds, whether this is
    the traced run, the device, the process's start on `time.perf_counter`
    and the catalog the cell came from."""

    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    catalog: "Catalog"


@dataclasses.dataclass
class Outcome:
    """What a driver returns: the verdict and its counts, the end-to-end
    values by name, the record the per-layer readers read (in the traced
    run `reduce_trace`'s summary under ``trace``), the numbers compared as
    (name, value, limit) and the peak of allocated device bytes."""

    correct: bool
    attempted: int
    failed: int
    e2e: Dict[str, float]
    record: dict
    checks: List[tuple]
    peak_bytes: int


class Catalog:
    """Name lookup over one or more benchmark roots (default: this
    folder)."""

    def __init__(self, roots: Sequence[Path] = (HERE,)):
        self.roots = [Path(r) for r in roots]

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise KeyError(f"no {kind} entry named {name!r} under "
                       f"{[str(r) for r in self.roots]}")

    def cell(self, name: str) -> dict:
        """The cell's file, with its configuration's file under
        ``config_file`` and its traffic mix's under ``mix``."""
        cell = json.loads(self.path("workloads", name, ".json").read_text())
        cell["name"] = name
        cell["config_file"] = json.loads(
            self.path("configs", cell["config"], ".json").read_text())
        cell["mix"] = json.loads(
            self.path("mixes", cell["traffic"], ".json").read_text())
        return cell

    def module(self, kind: str, name: str):
        return load_module(self.path(kind, name, ".py"))

    def cells(self) -> List[str]:
        out = set()
        for root in self.roots:
            out |= {p.stem for p in (root / "workloads").glob("*.json")}
        return sorted(out)


def load_module(path: Path):
    """Import a file by its path (names may hold dots)."""
    name = "portbench_" + path.parent.name + "_" + path.stem.replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) that `cell` reports, as
    BENCHMARK.json declares them: an entry with `workloads` is reported in
    the cells it lists; a per-layer entry without them in every cell that
    reports its `moves`."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if cell in m.get("workloads", [])
           or ("workloads" not in m and m["moves"] in names)]
    return e2e, per


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Top-level module names in `sys.modules` (or `modules`) that the
    benchmark's process may not hold."""
    names = sys.modules if modules is None else modules
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# ranges and the profiler's trace
# ---------------------------------------------------------------------------

TRACED = "portbench.traced"


@contextlib.contextmanager
def labelled(targets):
    """Each (object, attribute, label) of `targets` runs inside a
    `record_function` range named `label`, so a trace attributes each
    device call to the innermost one.  Restores the attributes after."""
    from torch.profiler import record_function

    saved = []
    for obj, attr, label in targets:
        def wrapped(*a, _fn=getattr(obj, attr), _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)
        saved.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        for obj, attr, own in reversed(saved):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)


def new_profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_events(prof) -> List[dict]:
    """The finished profiler's complete ('X') events, through a Chrome
    trace written to and removed from a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="portbench_") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(events, device_type) -> tuple:
    """(seconds in which a call ran on the device, number of such calls)
    from a finished profiler's events
    (`prof.profiler.kineto_results.events()`): the union of the calls on
    `device_type` (a `torch.autograd.DeviceType`), leaving out the ranges
    the host annotated onto it."""
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
             if e.device_type() == device_type
             and not e.is_user_annotation()]
    return sum(b - a for a, b in _merge(spans)) / 1e9, len(spans)


class CardClock:
    """The card's busy seconds over a timed window that runs in chunks,
    each under a profiler of its own that records the device's calls
    (so that no chunk outgrows the profiler's buffers).  A chunk ends
    with the device synchronized, so every call its work launched lies
    inside it; the chunks' events are reduced once the window has
    closed (`busy`).  The profiler's first start, which loads its tracing
    library, falls in the first chunk: it holds up the host and no device
    call, so it leaves the busy time alone and set-up without it."""

    def __init__(self, device):
        self.device = device
        self._profs = []

    @contextlib.contextmanager
    def chunk(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            yield
            if cuda:
                torch.cuda.synchronize(self.device)
        self._profs.append(prof)

    def busy(self) -> tuple:
        """(busy seconds, device calls) over every chunk so far; forgets
        them.  On the CPU the host's own ops stand in for the device's
        calls."""
        from torch.autograd import DeviceType

        on = DeviceType.CUDA if self.device.type == "cuda" else DeviceType.CPU
        s, n = 0.0, 0
        for prof in self._profs:
            b, k = device_busy(prof.profiler.kineto_results.events(), on)
            s, n = s + b, n + k
        self._profs.clear()
        return s, n


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def innermost(intervals, points) -> List[Optional[str]]:
    """For each point, the name of the innermost of the properly nested
    intervals (start, end, name) that holds it, or None: one sweep in time
    order with a stack of the open intervals."""
    order = sorted(range(len(points)), key=lambda i: points[i])
    iv = sorted(intervals, key=lambda x: (x[0], -x[1]))
    out: List[Optional[str]] = [None] * len(points)
    stack: list = []
    j = 0
    for i in order:
        t = points[i]
        while j < len(iv) and iv[j][0] <= t:
            while stack and stack[-1][1] < iv[j][0]:
                stack.pop()
            stack.append(iv[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def reduce_trace(events: List[dict], top: int = 10) -> Optional[dict]:
    """Reduce a trace whose traced region is a `TRACED` range: window and
    busy seconds (the union of device calls inside it), the device calls,
    device seconds by innermost harness range (matched through each
    call's launch), the busiest device operations and the idle time by
    what the host was doing (the innermost range and host operation of the
    traced thread over each gap's middle).  None when the trace holds no
    traced range."""
    region = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == TRACED]
    if not region:
        return None
    r0 = float(region[0]["ts"])
    r1 = r0 + float(region[0]["dur"])
    thread = (region[0].get("pid"), region[0].get("tid"))

    def host(cat):
        return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]) for e in events
                if e.get("cat") == cat and e["name"] != TRACED
                and (e.get("pid"), e.get("tid")) == thread
                and not e["name"].startswith("ProfilerStep")]

    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and r0 <= float(e["ts"]) < r1]
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    ranges = host("user_annotation")
    at = [launched.get(e.get("args", {}).get("correlation")) for e in dev]
    labels = innermost(ranges, [-1.0 if t is None else t for t in at])
    by_label: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    for e, label in zip(dev, labels):
        label = label or "other"
        by_label[label] = by_label.get(label, 0.0) + float(e["dur"])
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + float(e["dur"])
    busy = _merge((max(float(e["ts"]), r0),
                   min(float(e["ts"]) + float(e["dur"]), r1)) for e in dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], r0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if r1 > t:
        gaps.append((t, r1))
    mids = [0.5 * (a + b) for a, b in gaps]
    in_range = innermost(ranges, mids)
    in_op = innermost(host("cpu_op"), mids)
    idle: Dict[str, float] = {}
    for (a, b), rng, op in zip(gaps, in_range, in_op):
        name = " / ".join(x for x in (rng, op) if x) or "host outside ops"
        idle[name] = idle.get(name, 0.0) + (b - a)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa: E731
    return {
        "window_s": (r1 - r0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device_calls": len(dev),
        "device_s_by_label": {k: v / 1e6 for k, v in by_label.items()},
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in order(by_op)[:top]],
            "idle_gaps": [[k, v / 1e6] for k, v in order(idle)[:top]],
        },
    }


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                checks: List[tuple], breakdown: Optional[dict]) -> str:
    """The run's last line: metrics as {name: (value, unit)}, checks as
    [(name, value, limit)], the checks' key last."""
    out = {
        "correct": bool(correct),
        "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


def one_thread() -> None:
    """Load from one process with few threads: the host's math libraries
    get one thread each, so no idle pool spins beside the thread that
    issues the program's work (set before torch is imported)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def cache_env() -> None:
    """Keep every compiler cache of the run at a fixed place inside the
    checkout (the kernels' own build directory already is)."""
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")
