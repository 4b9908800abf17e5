"""Deterministic fault injection for the port's PQ and serving stack.

Counterpart of src/repro/faults.py, whose docstring gives the design: each
injector is a transform behind a seed-driven `FaultSpec`, so a chaos test
builds the healthy object, injects, drives it and asserts the contract —
the stack absorbs the fault (sanitization, clamping, backlog spill, window
rollback) or surfaces a typed error from `core.errors`.  The injectors are
the reference's twelve, under the same names in `INJECTORS`, on the port's
objects; each draws from ``np.random.default_rng(spec.seed)`` exactly as
the reference's does, so the same spec gives the same fault in both
packages.  `tests/test_torch_hygiene.py` checks that every injector is
named in `tests/test_torch_faults.py`.

  name                 injects into              adversarial condition
  --------------------------------------------------------------------------
  nonfinite_keys       workloads.traces.Trace    NaN/+-inf keys on insert
                                                 lanes (float batch)
  duplicate_keys       workloads.traces.Trace    equal-key storms
  ring_overflow_storm  serve workload            arrivals compressed into
                       (List[List[Request]])     bursts past the ring
  corrupt_trace_npz    saved npz path            truncated or flipped file
  oob_tree_class       SmartPQ                   packed tree labels outside
                                                 [0, NUM_CLASSES)
  forecast_extreme     ServeEngine               service-time estimate
                                                 pinned to an extreme
  corrupt_state        SmartPQCarry              head tier scrambled
                                                 (I1/I2 violations)
  validator_tripwire   (none: returns a hook)    synthetic violations N
                                                 times, then healed
  crash_at_step        ServeEngine               SIGKILL at engine step N
                                                 (one-shot with a marker)
  torn_wal             durable dir / wal path    torn write-ahead log tail
  partial_snapshot     durable dir / snap root   newest snapshot loses or
                                                 truncates a shard
  stale_manifest       durable dir / snap root   manifest garbage, or
                                                 LATEST naming no step
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.errors import InvariantViolation
from repro_torch.core.pqueue.ops import OP_INSERT


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection, fully determined by (kind, seed, rate, magnitude,
    variant) — the same spec always produces the same fault."""

    kind: str
    seed: int = 0
    rate: float = 0.25  # fraction of lanes/steps/bytes affected
    magnitude: float = 1.0  # injector-specific scale (storm factor, trips)
    variant: str = ""  # injector-specific discriminator


INJECTORS: Dict[str, Callable] = {}


def _injector(name: str):
    def reg(fn):
        INJECTORS[name] = fn
        return fn

    return reg


def inject(target, spec: FaultSpec):
    """Dispatch `target` through the injector `spec.kind` names."""
    if spec.kind not in INJECTORS:
        raise KeyError(
            f"unknown fault kind {spec.kind!r}; registered: "
            f"{sorted(INJECTORS)}"
        )
    return INJECTORS[spec.kind](target, spec)


# ---------------------------------------------------------------------------
# trace-level injectors
# ---------------------------------------------------------------------------


@_injector("nonfinite_keys")
def nonfinite_keys(trace, spec: FaultSpec):
    """Poison a `Trace` with non-finite float priority keys.

    Returns an in-memory Trace whose ``keys`` array is float32 with a
    `spec.rate` fraction of insert lanes set to NaN/+inf/-inf (cycled).
    The admission boundary (`ops.sanitize_keys`, run by `SmartPQ.step` /
    `run_window` on float batches) must reject exactly those lanes into
    `stats.rejected` — IEEE sort order never reaches the queue."""
    rng = np.random.default_rng(spec.seed)
    keys = trace.keys.astype(np.float32)
    ins = trace.ops == OP_INSERT
    hit = ins & (rng.random(trace.ops.shape) < spec.rate)
    fills = np.array([np.nan, np.inf, -np.inf], np.float32)
    keys[hit] = fills[np.arange(int(hit.sum())) % 3]
    return trace._replace(keys=keys)


@_injector("duplicate_keys")
def duplicate_keys(trace, spec: FaultSpec):
    """Equal-key storm: a `spec.rate` fraction of insert lanes copy the key
    of another (seed-chosen) insert lane of the same step.  Duplicates are
    legal inputs — the per-shard seq tiebreak must keep the linearization
    stable and every invariant intact; this injector exists to prove the
    path at adversarial density, not to trigger an error."""
    rng = np.random.default_rng(spec.seed)
    keys = trace.keys.copy()
    for t in range(trace.ops.shape[0]):
        lanes = np.flatnonzero(trace.ops[t] == OP_INSERT)
        if lanes.size < 2:
            continue
        victims = lanes[rng.random(lanes.size) < spec.rate]
        if victims.size:
            sources = rng.choice(lanes, victims.size)
            keys[t, victims] = keys[t, sources]
    return trace._replace(keys=keys)


@_injector("corrupt_trace_npz")
def corrupt_trace_npz(path, spec: FaultSpec):
    """Damage a saved trace npz on disk: ``variant='truncate'`` keeps only
    the leading `1 - rate` fraction of the file; ``variant='flip'`` XORs
    random bytes in the middle.  `traces.load_trace` must surface a typed
    `TraceCorruptError` — never a half-loaded trace."""
    from pathlib import Path

    rng = np.random.default_rng(spec.seed)
    p = Path(path)
    blob = bytearray(p.read_bytes())
    if spec.variant == "flip":
        n = max(int(len(blob) * spec.rate), 1)
        for i in rng.integers(len(blob) // 4, len(blob), n):
            blob[int(i)] ^= 0xFF
        p.write_bytes(bytes(blob))
    else:  # truncate
        keep = max(int(len(blob) * (1.0 - spec.rate)), 16)
        p.write_bytes(bytes(blob[:keep]))
    return p


# ---------------------------------------------------------------------------
# serving-workload injectors
# ---------------------------------------------------------------------------


@_injector("ring_overflow_storm")
def ring_overflow_storm(workload, spec: FaultSpec):
    """Compress an open-loop serve workload's arrivals into periodic storms.

    Every `1/rate` steps, all requests that would have arrived over the
    inter-storm span (scaled by `magnitude`, repeating requests with fresh
    uids when magnitude > 1) land in ONE step — sized to blow past the
    admission ring so the host backlog spill + bounded-backlog shed paths
    run.  Steps between storms are empty."""
    period = max(int(round(1.0 / max(spec.rate, 1e-6))), 1)
    flat = [r for step in workload for r in step]
    out: List[List] = [[] for _ in workload]
    if not flat:
        return out
    uid_next = max(r.uid for r in flat) + 1
    reps = max(int(round(spec.magnitude)), 1)
    for t in range(0, len(workload), period):
        lo = (t // period) * len(flat) // ((len(workload) + period - 1)
                                           // period)
        hi = (t // period + 1) * len(flat) // ((len(workload) + period - 1)
                                               // period)
        storm = []
        for rep in range(reps):
            for r in flat[lo:hi]:
                if rep == 0:
                    storm.append(dataclasses.replace(r, arrival_step=t))
                else:
                    storm.append(dataclasses.replace(
                        r, uid=uid_next, arrival_step=t
                    ))
                    uid_next += 1
        out[t] = storm
    return out


@_injector("forecast_extreme")
def forecast_extreme(engine, spec: FaultSpec):
    """Pin the engine's service-time EMA to a pathological extreme:
    ``variant='low'`` (estimate ~0 -> the forecast over-admits maximally,
    flooding the admit backlog), anything else -> `magnitude` steps
    (under-admission starvation when huge).  Correctness must never depend
    on the forecast — every request still completes."""
    engine._service_est = 1e-6 if spec.variant == "low" else float(
        max(spec.magnitude, 1.0)
    )
    return engine


# ---------------------------------------------------------------------------
# core-state / classifier injectors
# ---------------------------------------------------------------------------


@_injector("oob_tree_class")
def oob_tree_class(pq, spec: FaultSpec):
    """Corrupt the packed decision tree so inference emits classes outside
    [0, NUM_CLASSES): alternating negative and huge labels on a `rate`
    fraction of nodes (seeded).  The step's keep-rule + pre-switch clamp
    must degrade this to a valid mode — never an out-of-range
    branch."""
    rng = np.random.default_rng(spec.seed)
    label = pq.packed.label.detach().cpu().numpy().copy()
    hit = rng.random(label.shape) < spec.rate
    if not hit.any():
        hit[rng.integers(label.size)] = True
    n = int(hit.sum())
    label[hit] = np.where(np.arange(n) % 2 == 0, -3, 1 << 20)
    pq.packed = pq.packed._replace(
        label=torch.as_tensor(label, device=pq.packed.label.device))
    return pq


@_injector("corrupt_state")
def corrupt_state(carry, spec: FaultSpec):
    """Scramble one shard's hot head tier in a `SmartPQCarry`: reverse the
    head prefix when the shard is non-empty (breaks I1's ascending order),
    or plant a finite key in the INF padding of an empty shard (breaks I2).
    The `SmartPQConfig.validate` guard tier must detect it; the scheduler's
    window recovery must roll back and — since the corruption predates the
    checkpoint — surface a typed `WindowValidationError`."""
    rng = np.random.default_rng(spec.seed)
    head_keys = carry.state.head_keys
    hk = head_keys.detach().cpu().numpy().copy()
    hs = carry.state.head_size.detach().cpu().numpy()
    s = int(rng.integers(hk.shape[0]))
    n = int(hs[s])
    if n >= 2:
        hk[s, :n] = hk[s, :n][::-1]
        if hk[s, 0] == hk[s, n - 1]:  # all-equal prefix: force descent
            hk[s, 0] = hk[s, n - 1] + 1
    else:
        hk[s, hk.shape[1] - 1] = 5  # finite key inside INF padding (I2)
    return carry._replace(
        state=dataclasses.replace(
            carry.state,
            head_keys=torch.as_tensor(hk, device=head_keys.device))
    )


@_injector("validator_tripwire")
def validator_tripwire(_target, spec: FaultSpec):
    """Return a validation hook that reports a synthetic violation for the
    first `int(magnitude)` calls, then heals.  Wired into
    `SmartPQScheduler.validate_hook`, it deterministically exercises the
    checkpoint -> rollback -> conservative-retry -> SUCCESS path (a real
    corruption predating the checkpoint can only exercise the error
    path)."""
    trips = max(int(spec.magnitude), 1)
    calls = {"n": 0}

    def hook(_state) -> List[InvariantViolation]:
        calls["n"] += 1
        if calls["n"] <= trips:
            return [InvariantViolation(
                "I0", -1,
                f"injected tripwire ({calls['n']}/{trips})",
            )]
        return []

    return hook


# ---------------------------------------------------------------------------
# durability injectors (serve/durability.py + core/persist.py)
# ---------------------------------------------------------------------------


def _durable_paths(target):
    """Resolve a crash-injection target to (wal_path, snapshots_root):
    accepts a DurableStore, a durable directory, or a direct file path."""
    from pathlib import Path

    if hasattr(target, "wal") and hasattr(target, "snap_root"):
        return Path(target.wal.path), Path(target.snap_root)
    p = Path(target)
    if p.is_dir():
        return p / "wal.log", p / "snapshots"
    return p, p.parent / "snapshots"


@_injector("crash_at_step")
def crash_at_step(engine, spec: FaultSpec):
    """Arm a process-suicide tripwire: the wrapped `engine.step` SIGKILLs
    the process the moment the engine-step clock reaches
    ``int(spec.magnitude)`` — after that window's arrivals were WAL-logged
    but before its commit, i.e. exactly the torn mid-window crash the
    recovery path must absorb.  ``spec.variant``, when set, is a marker
    file path making the kill ONE-SHOT: the marker is written (and
    fsynced) immediately before the SIGKILL, so under a supervisor the
    restarted incarnation re-arms the injector, finds the marker, and
    runs through cleanly — the crash-drill harness in one injector."""
    import os
    import signal

    kill_at = max(int(spec.magnitude), 0)
    marker = spec.variant or None
    orig = engine.step

    def step(arrivals, dispatched=None):
        if engine._step >= kill_at:
            if marker is None or not os.path.exists(marker):
                if marker is not None:
                    from repro_torch.core import persist

                    persist.atomic_write_text(marker, "crashed\n")
                os.kill(os.getpid(), signal.SIGKILL)
        return orig(arrivals, dispatched)

    engine.step = step
    return engine


@_injector("torn_wal")
def torn_wal(target, spec: FaultSpec):
    """Tear the write-ahead log's tail the way a crash mid-append does.
    ``variant='flip'`` XORs one byte inside the LAST frame's payload (CRC
    mismatch); ``variant='garbage'`` appends a frame header whose length
    promises bytes that never made it to disk; default truncates a
    `spec.rate` fraction of the final frame.  `WriteAheadLog.recover` must
    return the intact record prefix and truncate the file — never raise,
    never yield a half-parsed record."""
    import struct

    rng = np.random.default_rng(spec.seed)
    wal_path, _ = _durable_paths(target)
    blob = bytearray(wal_path.read_bytes())
    if spec.variant == "garbage":
        blob += struct.pack("<II", 1 << 20, 0xDEADBEEF) + b"\x00" * 7
    elif spec.variant == "flip" and len(blob) > 8:
        blob[len(blob) - 1 - int(rng.integers(min(len(blob) - 8, 16)))] ^= 0xFF
    else:
        # walk frames to find the last one, cut inside it
        off, frames = 0, []
        while off + 8 <= len(blob):
            length = struct.unpack_from("<I", blob, off)[0]
            if off + 8 + length > len(blob):
                break
            frames.append((off, 8 + length))
            off += 8 + length
        if frames:
            start, size = frames[-1]
            cut = start + max(int(size * (1.0 - spec.rate)), 1)
            del blob[cut:]
    wal_path.write_bytes(bytes(blob))
    return wal_path


@_injector("partial_snapshot")
def partial_snapshot(target, spec: FaultSpec):
    """Damage the NEWEST snapshot's payload: ``variant='delete'`` removes a
    seed-chosen shard npz, default truncates it to the leading `1 - rate`
    fraction (the torn write a non-atomic snapshot would leave).
    `validate_step` must raise `SnapshotCorruptError` for this step and
    `load_newest_valid` must fall back to an older snapshot (or fresh
    init) with `snapshots_skipped_invalid` accounting."""
    from repro_torch.core import persist

    rng = np.random.default_rng(spec.seed)
    _, snap_root = _durable_paths(target)
    steps = persist.available_steps(snap_root)
    if not steps:
        raise FileNotFoundError(f"no snapshots under {snap_root}")
    d = persist.step_dir(snap_root, steps[0])
    shards = sorted(d.glob("shard_*.npz"))
    victim = shards[int(rng.integers(len(shards)))]
    if spec.variant == "delete":
        victim.unlink()
    else:
        blob = victim.read_bytes()
        victim.write_bytes(blob[: max(int(len(blob) * (1 - spec.rate)), 8)])
    return d


@_injector("stale_manifest")
def stale_manifest(target, spec: FaultSpec):
    """Damage snapshot METADATA rather than payload: ``variant='garbage'``
    overwrites the newest step's manifest.json with unparseable bytes;
    default rewrites LATEST to point at a step that does not exist on
    disk.  Recovery must shrug — scan the remaining steps newest-first
    and load the newest one that validates."""
    _, snap_root = _durable_paths(target)
    if spec.variant == "garbage":
        from repro_torch.core import persist

        steps = persist.available_steps(snap_root)
        if not steps:
            raise FileNotFoundError(f"no snapshots under {snap_root}")
        d = persist.step_dir(snap_root, steps[0])
        (d / "manifest.json").write_text("{torn json" + "\x00" * 16)
        return d
    latest = snap_root / "LATEST"
    latest.write_text(f"step_{10**9 + spec.seed}")
    return latest


__all__ = [
    "FaultSpec", "INJECTORS", "inject",
    "nonfinite_keys", "duplicate_keys", "corrupt_trace_npz",
    "ring_overflow_storm", "forecast_extreme", "oob_tree_class",
    "corrupt_state", "validator_tripwire",
    "crash_at_step", "torn_wal", "partial_snapshot", "stale_manifest",
]
