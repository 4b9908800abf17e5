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


def test_model_path_runs_on_the_card_by_default():
    """`build_model`, `init_params`, `init_caches`, `params_from_numpy` and
    `ServeEngine` with a dense, MoE or SSM model go to the card unless the
    caller names another device, and raise without one; `python -m
    repro_torch.launch.serve` with no --device refuses to run without a
    card rather than fall back to the CPU."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.io import init_caches
    from repro_torch.models.params import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.serve import EngineConfig, ServeEngine

    small = EngineConfig(batch_size=2, max_seq=8)
    # a dense, a MoE and an SSM config; the launcher runs the first two
    for arch, launch in (("llama3.2-3b", True),
                         ("granite-moe-1b-a400m", True),
                         ("mamba2-780m", False)):
        cfg = reduced_config(arch)
        tree = params_to_numpy(init_params(cfg, device="cpu"))
        cache = "ssm_h" if cfg.family == "ssm" else "k"
        argv = ["-m", "repro_torch.launch.serve", "--arch", arch,
                "--reduced", "--requests", "6"]
        if torch.cuda.is_available():
            assert build_model(cfg).device.type == "cuda"
            assert init_caches(cfg, 2, 8)[cache].device.type == "cuda"
            params = params_from_numpy(tree, cfg)
            assert params["embed"].device.type == "cuda"
            eng = ServeEngine(cfg, params, small)
            assert eng.caches[cache].device.type == "cuda"
            if launch:
                out = _python(argv, timeout=300)
                assert out.returncode == 0, out.stderr
                assert "6/6 requests" in out.stdout
            continue
        for make in (lambda: build_model(cfg), lambda: init_params(cfg),
                     lambda: init_caches(cfg, 2, 8),
                     lambda: params_from_numpy(tree, cfg),
                     lambda: ServeEngine(cfg, None, small)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        if not launch:
            continue
        out = _python(argv)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
        assert "requests" not in out.stdout
        out = _python(argv + ["--device", "cpu"])
        assert out.returncode == 0, out.stderr
        assert "6/6 requests" in out.stdout


def test_training_path_loads_no_jax_and_runs_on_the_card_by_default():
    """`repro_torch.train`, `repro_torch.data` and `repro_torch.launch.train`
    load neither jax nor the JAX package; the train, eval, prefill and
    serve steps and the loop go to the card unless the caller names
    another device, and raise without one; `python -m
    repro_torch.launch.train` with no --device refuses to run without a
    card rather than fall back to the CPU."""
    code = (
        "import sys\n"
        "import repro_torch.train, repro_torch.train.loop, "
        "repro_torch.train.checkpoint, repro_torch.data, "
        "repro_torch.launch.train\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'repro')]\n"
        "print(len(bad), bad[:5])\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    from repro_torch.configs.registry import reduced_config
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.steps import (make_eval_step, make_prefill_step,
                                         make_serve_step, make_train_step)

    cfg = reduced_config("llama3.2-3b")
    argv = ["-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
            "--reduced", "--steps", "2", "--batch", "2", "--seq", "16"]
    makers = (make_train_step, make_eval_step, make_prefill_step,
              make_serve_step)
    if torch.cuda.is_available():
        for make in makers:
            assert make(cfg)[1].device.type == "cuda"
        out = _python(argv, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "steps=2" in out.stdout
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(cfg, LoopConfig(steps=1, batch_size=1))
    out = _python(argv)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "[train]" not in out.stdout


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


def test_mesh_and_spawn_run_on_the_card_by_default():
    """`make_mesh` and `spawn` take the card and NCCL unless the caller names
    another device or backend, and raise without a card rather than run on
    the CPU; gloo on CUDA tensors (payloads staged through host memory) is
    reached only by naming it: the port's one choice of gloo is
    `default_backend`'s for the CPU."""
    import torch.distributed as dist

    from repro_torch.distributed import make_mesh, mesh, spawn

    assert mesh.default_backend(torch.device("cuda")) == "nccl"
    assert mesh.default_backend(torch.device("cpu")) == "gloo"
    if torch.cuda.is_available():
        with make_mesh((1, 1), ("pod", "shard")) as m:
            assert (m.device.type, m.backend, m.staged) == ("cuda", "nccl",
                                                            False)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1, 1), ("pod", "shard"))
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn(test_mesh_and_spawn_run_on_the_card_by_default, (2,),
                  ("dev",))
    with make_mesh((1, 1), ("pod", "shard"), device="cpu") as m:
        assert (m.backend, m.staged, m.transport) == ("gloo", False,
                                                      "gloo on cpu")
    assert not dist.is_initialized()
    named = [f"{f.relative_to(PORT)}: {line.strip()}"
             for f in sorted(PORT.rglob("*.py"))
             for line in f.read_text().splitlines() if '"gloo"' in line]
    assert named == [
        'distributed/mesh.py: self.staged = backend == "gloo" and '
        'device.type == "cuda"',
        'distributed/mesh.py: return "nccl" if device.type == "cuda" else '
        '"gloo"'], named


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


def test_dry_run_and_examples_load_no_jax_and_run_on_the_card_by_default():
    """`repro_torch.launch.dryrun`, `repro_torch.launch.mesh` and the four
    examples load neither jax nor the JAX package; the production mesh, the
    dry run and each example go to the card unless the caller names
    another device, and raise without one rather than fall back to the
    CPU."""
    code = (
        "import sys\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
        "from repro_torch.examples import (quickstart, serve_demo, sssp, "
        "train_demo)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'repro')]\n"
        "print(len(bad), bad[:5])\n"
    )
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("0 "), out.stdout
    from repro_torch.examples import quickstart, serve_demo, sssp, train_demo
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    if torch.cuda.is_available():
        assert make_production_mesh().device.type == "cuda"
        return
    for make in (make_production_mesh,
                 lambda: dryrun.lower_cell("gemma-2b", "decode_32k", False),
                 quickstart.quickstart, sssp.sssp_demo,
                 serve_demo.serve_demo,
                 lambda: train_demo.train_demo(steps=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
