"""Keep a durable serving worker alive.

Counterpart of src/repro/serve/supervisor.py (host code, copied), whose
docstring gives the design: the engine runs as a child process; the
supervisor restarts it when it dies and SIGKILLs it when its heartbeat
(``<durable_dir>/heartbeat.json``, rewritten at every window commit) goes
stale, and the restarted child's `ServeEngine.recover()` does the rest.

  death    `Popen.poll()`: any nonzero or signal exit is a crash; exit 0
           means the workload drained.
  hangs    after the first heartbeat, one older than `heartbeat_timeout`
           seconds is a hang; before it, `startup_timeout` covers imports
           and the kernels' build.
  backoff  ``backoff_base * 2**n`` seconds between attempts, capped at
           ``backoff_max``, reset by a crash long after the previous one.
  breaker  more than `max_restarts` crashes within `crash_window` seconds
           raise `CrashLoopError` instead of restarting forever.

    python -m repro_torch.serve.supervisor --heartbeat H -- cmd ...
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.core.errors import CrashLoopError


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    heartbeat_timeout: float = 30.0  # stale-heartbeat kill threshold (s)
    startup_timeout: float = 120.0  # first-heartbeat grace (imports, build)
    poll_interval: float = 0.05  # child/heartbeat polling cadence (s)
    backoff_base: float = 0.2  # first restart delay (s)
    backoff_max: float = 5.0  # exponential backoff cap (s)
    max_restarts: int = 5  # circuit breaker: crashes tolerated ...
    crash_window: float = 120.0  # ... within this sliding window (s)


@dataclasses.dataclass
class SupervisorReport:
    outcome: str  # "completed" | "crash_loop"
    restarts: int
    exit_codes: List[int]
    hang_kills: int
    wall_s: float

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class Supervisor:
    """Run `argv` as a child until it exits 0, restarting on crash/hang.

    `heartbeat` is the path the child's durability layer rewrites at every
    window commit (``<durable_dir>/heartbeat.json``); its mtime is the
    liveness signal.  The supervisor never reads engine internals — the
    heartbeat and the exit code are the whole protocol, which is what lets
    it supervise any worker binary."""

    def __init__(
        self,
        argv: Sequence[str],
        heartbeat: str | Path,
        config: SupervisorConfig = SupervisorConfig(),
        env: Optional[Dict[str, str]] = None,
    ):
        self.argv = list(argv)
        self.heartbeat = Path(heartbeat)
        self.cfg = config
        self.env = env
        self._crash_times: List[float] = []

    # -- internals ---------------------------------------------------------

    def _heartbeat_age(self) -> Optional[float]:
        try:
            return time.time() - self.heartbeat.stat().st_mtime
        except OSError:
            return None

    def _spawn(self) -> subprocess.Popen:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        return subprocess.Popen(self.argv, env=env)

    def _watch(self, child: subprocess.Popen) -> tuple[int, bool]:
        """Wait for exit or hang; returns (exit_code, hang_killed)."""
        t_start = time.time()
        seen_heartbeat = False
        while True:
            code = child.poll()
            if code is not None:
                return code, False
            age = self._heartbeat_age()
            if age is not None and age < self.cfg.startup_timeout:
                # a heartbeat younger than startup grace exists; once one
                # is observed, the (tighter) stale threshold arms
                if age < self.cfg.heartbeat_timeout:
                    seen_heartbeat = True
            if seen_heartbeat and age is not None \
                    and age > self.cfg.heartbeat_timeout:
                self._kill(child)
                return child.wait(), True
            if not seen_heartbeat \
                    and time.time() - t_start > self.cfg.startup_timeout:
                self._kill(child)
                return child.wait(), True
            time.sleep(self.cfg.poll_interval)

    @staticmethod
    def _kill(child: subprocess.Popen) -> None:
        try:
            child.send_signal(signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def _record_crash(self, now: float) -> None:
        self._crash_times.append(now)
        cutoff = now - self.cfg.crash_window
        self._crash_times = [t for t in self._crash_times if t >= cutoff]

    # -- main loop ---------------------------------------------------------

    def run(self) -> SupervisorReport:
        t0 = time.time()
        exit_codes: List[int] = []
        hang_kills = 0
        restarts = 0
        attempt = 0
        while True:
            child = self._spawn()
            code, hanged = self._watch(child)
            exit_codes.append(code)
            hang_kills += int(hanged)
            if code == 0 and not hanged:
                return SupervisorReport(
                    outcome="completed",
                    restarts=restarts,
                    exit_codes=exit_codes,
                    hang_kills=hang_kills,
                    wall_s=time.time() - t0,
                )
            now = time.time()
            self._record_crash(now)
            if len(self._crash_times) > self.cfg.max_restarts:
                from repro_torch.obs import get_default

                get_default().metrics.inc("errors_total", code="CRASH_LOOP")
                raise CrashLoopError(
                    len(self._crash_times), self.cfg.crash_window,
                    exit_codes,
                )
            # healthy stretch resets the exponential ladder: a crash long
            # after the previous one is flapping, not a loop
            if len(self._crash_times) == 1:
                attempt = 0
            delay = min(
                self.cfg.backoff_base * (2 ** attempt),
                self.cfg.backoff_max,
            )
            attempt += 1
            restarts += 1
            time.sleep(delay)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI: ``python -m repro_torch.serve.supervisor --heartbeat H -- cmd
    ...``"""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--heartbeat", required=True)
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0)
    ap.add_argument("--startup-timeout", type=float, default=120.0)
    ap.add_argument("--max-restarts", type=int, default=5)
    ap.add_argument("--crash-window", type=float, default=120.0)
    ap.add_argument("--backoff-base", type=float, default=0.2)
    ap.add_argument("--backoff-max", type=float, default=5.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="child command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no child command given")
    sup = Supervisor(cmd, args.heartbeat, SupervisorConfig(
        heartbeat_timeout=args.heartbeat_timeout,
        startup_timeout=args.startup_timeout,
        max_restarts=args.max_restarts,
        crash_window=args.crash_window,
        backoff_base=args.backoff_base,
        backoff_max=args.backoff_max,
    ))
    report = sup.run()
    print(report.as_dict())
    return 0 if report.outcome == "completed" else 1


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["Supervisor", "SupervisorConfig", "SupervisorReport", "main"]
