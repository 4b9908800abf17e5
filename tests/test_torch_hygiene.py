"""Hygiene of the PyTorch port: it stands apart from JAX and the JAX package,
runs on the card unless told otherwise, and its chip smoke script refuses to
report a result without a card or without the repository beside it."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"\bimport jax\b|\bfrom jax\b|\brepro\.")


def _python(code_or_args, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = code_or_args if isinstance(code_or_args, list) else [
        "-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(len(bad), bad[:5])\n"
        "print(sorted(m for m in sys.modules if m in (\n"
        "    'repro_torch.faults', 'repro_torch.serve.durability',\n"
        "    'repro_torch.serve.supervisor', 'repro_torch.serve.worker')))\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    assert out.stdout.splitlines()[1] == str(sorted([
        "repro_torch.faults", "repro_torch.serve.durability",
        "repro_torch.serve.supervisor", "repro_torch.serve.worker"]))


def test_port_sources_name_no_jax_and_no_jax_package():
    files = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu*")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if FORBIDDEN.search(line)]
    assert not hits, "\n".join(hits)


def test_smartpq_runs_on_the_card_by_default():
    from repro_torch.core.smartpq import SmartPQ, SmartPQConfig
    from repro_torch.core.pqueue.schedules import Schedule

    cfg = SmartPQConfig(num_shards=4, capacity=64,
                        mode_schedules=(Schedule.SPRAY_HERLIHY,) * 2
                        + (Schedule.HIER,))
    if torch.cuda.is_available():
        assert SmartPQ(cfg).init().state.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SmartPQ(cfg)


def test_workloads_run_on_the_card_by_default():
    """A graph, the registry's queue and the recorders (which build both)
    go to the card unless the caller names another device; the drivers and
    `replay` run where their graph or queue lives."""
    from repro_torch.workloads import graphs, registry, sssp

    if torch.cuda.is_available():
        assert graphs.random_graph(n=16).nbr.device.type == "cuda"
        assert registry.default_pq(num_shards=4,
                                   capacity=64).device.type == "cuda"
        return
    for make in (lambda: graphs.random_graph(n=16),
                 lambda: registry.default_pq(num_shards=4, capacity=64),
                 lambda: registry.get("sssp").make_trace(True, 0),
                 lambda: registry.get("des_hold").make_trace(True, 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    g = graphs.random_graph(n=16, device="cpu")
    assert sssp.run_sssp(g, sssp.Schedule.HIER, m=4, num_shards=4,
                         capacity=64).converged


def test_serving_runs_on_the_card_by_default():
    """The scheduler and the engine go to the card unless the caller names
    another device, and raise without one."""
    from repro_torch.serve import EngineConfig, ServeEngine, SmartPQScheduler

    small = dict(batch_size=8, pq_config=None)
    if torch.cuda.is_available():
        assert SmartPQScheduler(**small).carry.state.device.type == "cuda"
        eng = ServeEngine(None, None, EngineConfig(batch_size=2))
        assert eng.tokens.device.type == "cuda"
        assert eng.scheduler.carry.state.device.type == "cuda"
        return
    for make in (lambda: SmartPQScheduler(**small),
                 lambda: ServeEngine(None, None, EngineConfig(batch_size=2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    eng = ServeEngine(None, None, EngineConfig(batch_size=2), device="cpu")
    assert eng.scheduler.carry.state.device.type == "cpu"


def test_worker_and_supervisor_run_on_the_card_by_default(tmp_path):
    """`python -m repro_torch.serve.worker` with no --device runs on the
    card: without one it refuses, and the supervisor's circuit breaker
    opens over the refusing child instead of restarting it forever."""
    from repro_torch.core.errors import CrashLoopError
    from repro_torch.serve import Supervisor, SupervisorConfig

    argv = ["-m", "repro_torch.serve.worker", "--dir", str(tmp_path / "d"),
            "--out", str(tmp_path / "r.json"), "--steps", "4"]
    out = _python(argv, timeout=300)
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
        result = json.loads((tmp_path / "r.json").read_text())
        assert result["conservation"]["admitted_ok"]
        return
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "r.json").exists()
    sup = Supervisor([sys.executable, *argv], tmp_path / "d" / "hb.json",
                     SupervisorConfig(max_restarts=0, backoff_base=0.01,
                                      poll_interval=0.02),
                     env={"PYTHONPATH": str(ROOT / "src")})
    with pytest.raises(CrashLoopError) as err:
        sup.run()
    assert err.value.exit_codes == [1]


def test_port_injectors_are_the_references_and_all_tested():
    """The port's `INJECTORS` has the reference's names, and each is named
    in tests/test_torch_faults.py (the port's tests/test_hygiene.py::
    test_every_fault_injector_is_exercised)."""
    from repro.faults import INJECTORS as JINJECTORS
    from repro_torch.faults import INJECTORS

    assert list(INJECTORS) == list(JINJECTORS)
    chaos_src = (ROOT / "tests" / "test_torch_faults.py").read_text()
    missing = [name for name in INJECTORS if name not in chaos_src]
    assert missing == [], f"injectors no test names: {missing}"


def test_chip_smoke_gives_no_result_without_card_or_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs = [_python(["chip_smoke.py"], cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(_python(["chip_smoke.py"]))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
