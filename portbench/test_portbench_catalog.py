"""The benchmark's files: cells, configurations, mixes and metrics found by
name; BENCHMARK.json within the contract it is written to; a new cell added
as files alone; no module of the JAX stack or the JAX package imported;
and `run.py` refusing to run without a card."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_is_found_by_name_with_its_configuration_and_mix():
    cat = harness.Catalog()
    names = [w["name"] for w in BENCH["workloads"]]
    assert sorted(names) == cat.cells()
    for w in BENCH["workloads"]:
        cell = cat.cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert cell["config_file"]["system"] == "serve"
        cat.module("systems", cell["config_file"]["system"])
        cat.module("traffic", cell["mix"]["kind"])
    with pytest.raises(KeyError):
        cat.cell("no-such-cell")


def test_each_per_layer_metric_of_benchmark_json_has_its_reader():
    # layer, unit and moves live in BENCHMARK.json alone; a reader only reads
    cat = harness.Catalog()
    declared = sorted(m["name"] for m in BENCH["per_layer"])
    assert declared == sorted(p.stem for p in (HERE / "metrics").glob("*.py"))
    for name in declared:
        mod = cat.module("metrics", name)
        assert not {"LAYER", "UNIT", "MOVES", "SOURCE"} & set(vars(mod))
        assert mod.read({}) is None  # nothing to read: nothing returned


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert len(cells) == len(BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) \
        == len(cells)
    assert {w["config"] for w in cells.values()} == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (CHECKOUT / c["file"]).is_file()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in cells.values()) \
        <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for c in m.get("workloads", []):
            assert c in cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        for c in m["workloads"]:  # every listed cell reports what it moves
            assert c in e2e[m["moves"]].get("workloads", [c])
    for name in cells:  # setup_s, another end-to-end and a per-layer one
        e, p = harness.cell_metrics(BENCH, name)
        assert "setup_s" in [m["name"] for m in e] and len(e) >= 2 and p
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_new_cell_is_new_files_alone(tmp_path):
    before = sorted((p, p.stat().st_mtime_ns) for p in HERE.rglob("*")
                    if p.is_file() and "__pycache__" not in p.parts)
    (tmp_path / "workloads").mkdir()
    (tmp_path / "mixes").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "mixes" / "long-backlog.json").write_text(json.dumps(
        {"kind": "offline_backlog", "requests": 256,
         "max_new_tokens": {"mean": 338, "max": 4000},
         "prompt_len": {"mean": 161, "max": 4000}, "slo_classes": 3,
         "warm_ticks": 1024}))
    (tmp_path / "workloads" / "g8b-decode-long.json").write_text(json.dumps(
        {"config": "granite-8b", "traffic": "long-backlog", "chips": 1,
         "why": "longer outputs"}))
    (tmp_path / "metrics" / "tokens_per_tick.serve.py").write_text(
        'def read(rec):\n    return rec["tokens"] / rec["ticks"]\n')
    cat = harness.Catalog([HERE, tmp_path])
    cell = cat.cell("g8b-decode-long")
    assert cell["config_file"]["n_layers"] == 36
    traffic = cat.module("traffic", cell["mix"]["kind"])
    reqs = traffic.requests(cell["mix"], 3)
    assert len(reqs) == 256 and max(r[2] for r in reqs) > 338
    assert "g8b-decode-long" in cat.cells() and "g8b-decode-4k" in cat.cells()
    metric = cat.module("metrics", "tokens_per_tick.serve")
    assert metric.read({"tokens": 640, "ticks": 10}) == 64.0
    after = sorted((p, p.stat().st_mtime_ns) for p in HERE.rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    assert before == after


FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)
    # whole top-level names: the port's name begins with the JAX package's
    assert harness.forbidden_modules(["repro_torch.core", "portbench"]) == []
    assert harness.forbidden_modules(["repro.core", "jaxlib.xla"]) == [
        "jaxlib", "repro"]


def test_run_gives_no_result_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", "g8b-decode-4k",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=CHECKOUT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
