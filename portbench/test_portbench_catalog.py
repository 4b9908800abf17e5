"""The benchmark's files: cells, configurations, model families, mixes and
metrics found by name; BENCHMARK.json within the contract it is written
to; a new cell and a new model family added as files alone; no module of
the JAX stack or the JAX package imported; and `run.py` refusing to run
without a card."""

import ast
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# What `systems/serve.py` takes from a configuration's family module.
FAMILY_CONTRACT = ("model_config", "make_weights", "forward",
                   "control_transform", "token_flops", "step_bytes",
                   "state_row_bytes", "ATTENTION")


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
        fam = cat.module("families", cell["config_file"]["family"])
        assert [n for n in FAMILY_CONTRACT if not hasattr(fam, n)] == []
        assert len(fam.ATTENTION) == 2
        assert all(isinstance(x, str) for x in fam.ATTENTION)
        # the comparison that decides `correct` is the system's, its limit
        # the configuration's
        assert not {"served_gap", "LOGIT_GAP_LIMIT", "judge"} & set(vars(fam))
        assert cell["config_file"]["logit_gap_limit"] > 0
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


def _benchmark_files():
    return sorted((p, p.stat().st_mtime_ns) for p in HERE.rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def test_a_new_cell_is_new_files_alone(tmp_path):
    before = _benchmark_files()
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
    assert _benchmark_files() == before


TOY_FAMILY = '''"""The dense family's functions, each call logged."""
from portbench import harness

DENSE = harness.Catalog().module("families", "dense")
CALLS = []


def _logged(name):
    def call(*a, **kw):
        CALLS.append(name)
        return getattr(DENSE, name)(*a, **kw)
    return call


for _name in ("make_weights", "forward", "control_transform",
              "token_flops", "step_bytes", "state_row_bytes"):
    globals()[_name] = _logged(_name)


def model_config(cfg):
    CALLS.append("model_config")
    return DENSE.model_config(dict(cfg, family="dense"))  # the program's


def __getattr__(name):  # read on use, so that the read is logged
    if name == "ATTENTION":
        CALLS.append(name)
        return DENSE.ATTENTION
    raise AttributeError(name)
'''


def _toy_cell(tmp_path, family, **config):
    """A cut-down serving cell under `tmp_path` whose configuration names
    `family`, at `test_portbench_faults_serve.small()`'s size, with the
    keys of `config` set."""
    from portbench.test_portbench_faults_serve import small

    base = small()
    for kind in ("configs", "mixes", "workloads"):
        (tmp_path / kind).mkdir(exist_ok=True)
    cfg = dict(base["config_file"], family=family, **config)
    (tmp_path / "configs" / f"{family}-small.json").write_text(
        json.dumps(cfg))
    (tmp_path / "mixes" / "short-backlog.json").write_text(
        json.dumps(base["mix"]))
    (tmp_path / "workloads" / f"{family}-decode.json").write_text(
        json.dumps({"config": f"{family}-small", "traffic": "short-backlog",
                    "chips": 1, "why": "a family added as files"}))
    return f"{family}-decode"


def test_a_new_family_is_new_files_alone(tmp_path, monkeypatch):
    import torch

    before = _benchmark_files()
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "toy.py").write_text(TOY_FAMILY)
    cat = harness.Catalog([HERE, tmp_path])
    name = _toy_cell(tmp_path, "toy", logit_gap_limit=1.0)
    events = []

    def trace_events(prof, _inner=harness.trace_events):
        got = _inner(prof)
        events.extend(got)
        return got

    monkeypatch.setattr(harness, "trace_events", trace_events)
    toy = cat.module("families", "toy")
    try:
        run = harness.Run(cell=cat.cell(name), seed=2**31 + 7, seconds=2.0,
                          trace=True, device=torch.device("cpu"),
                          t0=time.perf_counter(), catalog=cat)
        out = cat.module("systems", "serve").run(run)
    finally:
        sys.modules.pop(toy.__name__)
    assert out.correct, out.checks
    assert ("logit_gap", out.checks[0][1], 1.0) == out.checks[0]
    assert {"model_config", "make_weights", "forward", "token_flops",
            "step_bytes", "state_row_bytes", "ATTENTION"} <= set(toy.CALLS)
    assert out.record["mfu"] > 0 and out.record["traced_min_bytes"] > 0
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    # the system's fixed names, which the per-layer readers read
    assert {"serve.attention", "serve.decode"} <= ranges
    assert _benchmark_files() == before


def test_a_family_the_catalog_lacks_raises_before_any_weights(tmp_path):
    cat = harness.Catalog([HERE, tmp_path])
    name = _toy_cell(tmp_path, "no-such-family")
    # a device any use of which fails: the lookup comes before it is used
    run = harness.Run(cell=cat.cell(name), seed=5, seconds=1.0, trace=False,
                      device=object(), t0=time.perf_counter(), catalog=cat)
    with pytest.raises(KeyError, match="no-such-family"):
        cat.module("systems", "serve").run(run)


def test_a_configuration_without_its_gap_limit_raises_before_any_weights(
        tmp_path):
    cat = harness.Catalog([HERE, tmp_path])
    name = _toy_cell(tmp_path, "dense")
    path = tmp_path / "configs" / "dense-small.json"
    cfg = json.loads(path.read_text())
    del cfg["logit_gap_limit"]
    path.write_text(json.dumps(cfg))
    run = harness.Run(cell=cat.cell(name), seed=5, seconds=1.0, trace=False,
                      device=object(), t0=time.perf_counter(), catalog=cat)
    with pytest.raises(KeyError, match="logit_gap_limit"):
        cat.module("systems", "serve").run(run)


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
