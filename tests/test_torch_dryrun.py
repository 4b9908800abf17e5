"""The port's dry run (`repro_torch.launch.dryrun`, `launch/mesh.py`,
`models.io.input_specs`/`cache_specs`, `distributed.mesh.AbstractMesh`)
against the JAX package's, on the CPU.

- Specs: `input_specs` and `cache_specs` equal the reference's in shape
  and dtype (meta tensors against `ShapeDtypeStruct`s) for every
  applicable (arch, shape) cell and for int8 KV decode; the eight
  long-context cells of the full-attention archs are skipped as
  quadratic (tests/test_models_smoke.py:93-103).
- Argument bytes: every applicable cell on one pod and on two, with and
  without `serve_tp_only`: the port's `argument_bytes` (this device's
  fake blocks of the parameters, the optimizer state to train and the
  batch) equal, byte for byte, the reference's trees
  (`jax.eval_shape` of `init_params` with its spec tree,
  `opt_state_specs`, `batch_spec_tree`, `input_specs`) with every
  dimension divided by its spec's mesh axes.  Where a long_500k batch of
  1 leaves 'pod' (two pods) or, under `serve_tp_only`, 'data' to no rule,
  the port declares the axis replicated (`sharding.replicate_unused`), as
  the reference's GSPMD replicates it; mamba2's such cell traces.
- gemma-2b decode_32k (serve_tp_only, one pod) against the reference's
  own `lower_cell` (a subprocess on 512 virtual CPU devices,
  tests/torch_dryrun_ref.py): argument bytes equal; the ratios of the
  FLOPs and the collective bytes are printed (PERF.md explains them, op
  by op).
- `AbstractMesh`: on a (2, 2) mesh, one train step and one decode step of
  reduced llama3.2-3b and granite-moe-3b-a800m issue the same collectives
  by (kind, axes) as rank 0 of a real gloo mesh (`Mesh.counts`; rank code
  in tests/torch_dist_ranks.py); a real tensor is refused.
- The int8 first moment of a leaf whose rank blocks straddle the 256-value
  blocks (jamba's `in_proj` on a 16-wide model axis, which the dry run
  reached first): the (2, 2) gloo ranks' AdamW steps bit-equal to one
  process's.
- One traced cell (whisper-base train_4k, `--kv-chunk 4096`, which halves
  the attention's chunks to trace), the skips and the refusal of
  `--cast-before-scan`.
"""

import ast
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import shape_applicable as j_applicable
from repro.configs.registry import get_config as j_get_config
from repro.distributed import sharding as JS
from repro.models import io as JIO
from repro.models.params import init_params as j_init_params
from repro.train import optimizer as JO
from repro.train import steps as JSteps
from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.distributed import AbstractMesh, spawn
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import io as TIO
from repro_torch.train import optimizer as TO
from torch_dist_ranks import dryrun_ranks, step_collectives

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_configs()
# the reference's production meshes, as the shapes its rules read
J_MESHES = {
    False: types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model")),
    True: types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                                axis_names=("pod", "data", "model")),
}
JAX_DTYPE = {jnp.int32: torch.int32, jnp.int8: torch.int8,
             jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _ref_state_dtype():
    """The reference dry run's `STATE_DTYPE`, read from its source: the
    module sets XLA_FLAGS when imported, so the test does not import it."""
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "STATE_DTYPE":
            return ast.literal_eval(node.value)
    raise AssertionError("STATE_DTYPE not found")


def _flat_specs(tree, prefix=""):
    """{path: (shape, dtype)} of a tree of meta tensors or
    ShapeDtypeStructs (`jax.tree.map` sorts a dict's keys, so the order is
    not compared)."""
    if isinstance(tree, dict):
        return {p: v for k in tree
                for p, v in _flat_specs(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return {prefix: (tuple(tree.shape), tree.dtype)}
    return {prefix: (tuple(tree.shape), JAX_DTYPE[tree.dtype.type])}


def test_state_dtype_is_the_references():
    assert dryrun.STATE_DTYPE == _ref_state_dtype()


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_jax(arch):
    """The port of tests/test_models_smoke.py:93-103 over every cell."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    skipped = 0
    for name, shape in SHAPES.items():
        ok, why = shape_applicable(cfg, shape)
        assert (ok, why) == j_applicable(jcfg, J_SHAPES[name])
        if not ok:
            assert "quadratic" in why
            skipped += 1
            continue
        for int8 in (False, True):
            got = _flat_specs(TIO.input_specs(cfg, shape, kv_int8=int8))
            want = _flat_specs(JIO.input_specs(jcfg, J_SHAPES[name],
                                               kv_int8=int8))
            assert got == want, (name, int8)
    assert skipped == (0 if cfg.family in ("ssm", "hybrid") else 1)
    got = _flat_specs(TIO.cache_specs(cfg, 3, 40, kv_int8=True))
    want = _flat_specs(JIO.cache_specs(jcfg, 3, 40, kv_int8=True))
    assert got == want


def test_eight_long_context_skips():
    full_attention = [a for a in ARCHS
                      if get_config(a).family not in ("ssm", "hybrid")]
    assert len(full_attention) == 8
    for a in full_attention:
        for mp in (False, True):
            rec = dryrun.lower_cell(a, "long_500k", mp, device="cpu")
            assert rec["status"] == "skipped", a
            assert "quadratic" in rec["reason"]


def _strip(spec_tree, mesh):
    """The reference dry run's `_strip` (src/repro/launch/dryrun.py:76-92):
    the pod axis dropped from a spec tree on a pod-less mesh."""
    if "pod" in mesh.axis_names:
        return spec_tree

    def fix(spec):
        entries = []
        for e in spec:
            if isinstance(e, tuple):
                kept = tuple(a for a in e if a != "pod")
                entries.append(kept if len(kept) > 1 else (
                    kept[0] if kept else None))
            else:
                entries.append(None if e == "pod" else e)
        return JP(*entries)

    return jax.tree.map(fix, spec_tree, is_leaf=lambda x: isinstance(x, JP))


def _local_bytes(sds_tree, spec_tree, mesh):
    """The bytes of a tree's blocks: each dimension divided by the product
    of its spec entry's mesh axes."""
    def one(spec, sd):
        n = 1
        for d, size in enumerate(sd.shape):
            e = spec[d] if d < len(spec) else None
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            div = math.prod(mesh.shape[a] for a in axes)
            assert size % div == 0, (sd.shape, spec)
            n *= size // div
        return n * jnp.dtype(sd.dtype).itemsize

    return sum(jax.tree.leaves(jax.tree.map(
        one, spec_tree, sds_tree, is_leaf=lambda x: isinstance(x, JP))))


def _ref_argument_bytes(arch, shape_name, multi_pod, serve_tp_only):
    """The reference's argument bytes of a cell from its own trees and its
    dry run's rule choices (src/repro/launch/dryrun.py:56-73,128-150)."""
    cfg, shape, mesh = j_get_config(arch), J_SHAPES[shape_name], \
        J_MESHES[multi_pod]
    rules = JS.strip_pod(JS.ShardingRules(), mesh)
    if shape.global_batch % (mesh.shape.get("pod", 1)
                             * mesh.shape["data"]):
        rules = JS.drop_batch_axes(rules)
    if (serve_tp_only and shape.kind in ("prefill", "decode")
            and cfg.param_count() * 2 / mesh.shape["model"] <= 2 * 2**30):
        rules = JS.tp_only_params(rules)
    serving = shape.kind != "train"
    box = {}

    def capture(key):
        p, box["specs"] = j_init_params(cfg, key, rules,
                                        mesh.shape.get("model", 16))
        if serving:
            p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
        return p

    params = jax.eval_shape(capture, jax.random.key(0))
    total = _local_bytes(params, box["specs"], mesh)
    if not serving:
        opt_cfg = JO.AdamWConfig(
            state_dtype=_ref_state_dtype().get(arch, "fp32"))
        opt = jax.eval_shape(lambda p: JO.adamw_init(p, opt_cfg), params)
        total += _local_bytes(opt, JO.opt_state_specs(
            params, box["specs"], opt_cfg), mesh)
    batch_specs = _strip(JSteps.batch_spec_tree(
        cfg, shape, JS.ShardingRules(), mesh), mesh)
    return total + _local_bytes(JIO.input_specs(cfg, shape), batch_specs,
                                mesh)


def _port_argument_bytes(arch, shape_name, multi_pod, serve_tp_only):
    with FakeTensorMode():
        _, args, _ = dryrun.build_cell(arch, shape_name, multi_pod,
                                       serve_tp_only=serve_tp_only,
                                       device="cpu")
        return dryrun.argument_bytes(args)


# The cells whose batch of 1 leaves a mesh axis to no rule, (arch, shape,
# multi_pod, serve_tp_only) -> the axes `cell_rules` declares replicated:
# 'pod' on two pods, and under tp_only_params (mamba2's parameters fit)
# 'data' too; the reference's GSPMD replicates them unasked.
REPLICATED = {("jamba-1.5-large-398b", "long_500k", True, False): ("pod",),
              ("jamba-1.5-large-398b", "long_500k", True, True): ("pod",),
              ("mamba2-780m", "long_500k", True, False): ("pod",),
              ("mamba2-780m", "long_500k", False, True): ("data",),
              ("mamba2-780m", "long_500k", True, True): ("pod", "data")}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_jax_spec_arithmetic(arch, multi_pod):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        for tp in ((False, True) if shape.kind != "train" else (False,)):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            rules = dryrun.cell_rules(cfg, shape, mesh, tp)
            assert tuple(getattr(rules, "replicated", ())) == REPLICATED.get(
                (arch, name, multi_pod, tp), ()), (name, tp)
            got = _port_argument_bytes(arch, name, multi_pod, tp)
            want = _ref_argument_bytes(arch, name, multi_pod, tp)
            assert got == want, (name, tp, got, want)


def test_gemma_decode_cell_against_the_references_compiled_run():
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_ref.py"),
         "gemma-2b", "decode_32k", "--serve-tp-only"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 XLA_FLAGS="--xla_force_host_platform_device_count=512",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = dryrun.lower_cell("gemma-2b", "decode_32k", False,
                            serve_tp_only=True, device="cpu")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    want = json.loads(out.strip().splitlines()[-1])
    assert want["status"] == got["status"] == "ok"
    assert got["n_chips"] == want["n_chips"] == 256
    mem, jmem = got["memory_per_device"], want["memory_per_device"]
    assert mem["argument_bytes"] == jmem["argument_bytes"]
    assert got["params"] == want["params"]
    assert got["active_params"] == want["active_params"]
    assert got["flops_per_device"] > 0
    assert got["collective_bytes_per_device"] > 0
    flops = got["flops_per_device"], want["flops_per_device"]
    coll = (got["collective_bytes_per_device"],
            want["collective_bytes_per_device"])
    print(f"gemma-2b decode_32k serve_tp_only, port / reference: flops "
          f"{flops[0] / flops[1]:.4f} ({flops[0]} / {flops[1]:.0f}); "
          f"collective bytes {coll[0] / coll[1]:.4f} (by op {got['collective_bytes_by_op']} / "
          f"{want['collective_bytes_by_op']}); output bytes "
          f"{mem['output_bytes']} / {jmem['output_bytes']}, alias "
          f"{mem['alias_bytes']} / {jmem['alias_bytes']}")


STEP_ARCHS = ["llama3.2-3b", "granite-moe-3b-a800m"]


def _straddled_case():
    """A 768-column leaf over a 2-wide model axis: 384 columns a rank, so
    the middle 256-value block straddles the two ranks."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(3, 768)).astype(np.float32)
    g = [rng.normal(size=(3, 768)).astype(np.float32) for _ in range(3)]
    return p, g, 2.5


@pytest.fixture(scope="module")
def ranks():
    """One spawn of a (data 2, model 2) gloo mesh for the rank tests."""
    return spawn(dryrun_ranks, (2, 2), ("data", "model"), device="cpu",
                 args=(STEP_ARCHS, *_straddled_case()))


def test_abstract_mesh_issues_the_real_meshs_collectives(ranks):
    with FakeTensorMode():
        mesh = AbstractMesh((2, 2), ("data", "model"), device="cpu")
        got = step_collectives(mesh, STEP_ARCHS)
    want = ranks[0]["collectives"]
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == want[k], k
        assert got[k], k  # every step issues collectives
    with pytest.raises(ValueError, match="fake tensors"):
        mesh.psum(torch.zeros(3), "data")


def test_abstract_mesh_geometry_and_output_shapes():
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    assert (mesh.axis_names, mesh.size) == (("pod", "data", "model"), 512)
    assert mesh.axis_size(("pod", "data")) == 32
    assert mesh.device_rank(("data", "model")) == 0
    with FakeTensorMode():
        x = torch.zeros(4, 32, dtype=torch.bfloat16)
        assert mesh.all_gather(x, "model", axis=1, tiled=True).shape == (
            4, 512)
        assert mesh.all_gather(x, "pod").shape == (2, 4, 32)
        assert mesh.psum_scatter(x, "model", 1).shape == (4, 2)
        assert mesh.psum(x, ("pod", "data")).shape == (4, 32)
        assert mesh.pmax(x, "data").dtype == torch.bfloat16
        assert mesh.all_to_all(torch.zeros(16, 3), "model").shape == (16, 3)
        assert mesh.ppermute(x, "pod", [(0, 1)]).shape == (4, 32)
    assert mesh.op_bytes == {"all-gather": 4 * 512 * 2 + 2 * 4 * 32 * 2,
                             "reduce-scatter": 4 * 2 * 2,
                             "all-reduce": 2 * 4 * 32 * 2,
                             "all-to-all": 16 * 3 * 4,
                             "collective-permute": 4 * 32 * 2}
    assert mesh.counts[("all_gather", ("model",))] == 1
    assert sum(mesh.op_counts.values()) == 7


def test_int8_moment_straddling_blocks_matches_one_process(ranks):
    p, g, gnorm = _straddled_case()
    opt = TO.AdamWConfig(lr=1e-2, state_dtype="int8")
    params = {"w": torch.as_tensor(p).clone()}
    st = TO.adamw_init(params, opt)
    for step, gi in enumerate(g):
        params, st = TO.adamw_update(params, {"w": torch.as_tensor(gi)}, st,
                                     opt, gnorm=torch.tensor(gnorm))
        q, scale = st.m["w"]
        for data in (0, 1):  # ranks (data, model), row-major
            row = [r["straddled"][step] for r in ranks[2 * data:2 * data + 2]]
            np.testing.assert_array_equal(
                np.concatenate([r[0] for r in row], axis=1),
                params["w"].numpy())
            np.testing.assert_array_equal(
                np.concatenate([r[1] for r in row], axis=1), q.numpy())
            for r in row:  # every rank holds every block's scale
                np.testing.assert_array_equal(r[2], scale.numpy())


def test_small_train_cell_traces():
    rec = dryrun.lower_cell("whisper-base", "train_4k", False, device="cpu",
                            kv_chunk=4096, device_memory_bytes=80 * 10**9)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["flops_per_device"] > 0
    mem = rec["memory_per_device"]
    assert 0 < mem["argument_bytes"] <= mem["peak_estimate_bytes"] < 2**50
    assert mem["alias_bytes"] <= mem["output_bytes"]
    # the train step writes the parameters and moments in place: what does
    # not alias is the batch and the int32 step count, returned anew
    assert mem["argument_bytes"] - mem["alias_bytes"] == (
        dryrun.argument_bytes(_batch_of("whisper-base")) + 4)
    assert rec["fits_device_memory"] == (mem["peak_estimate_bytes"]
                                         <= 80 * 10**9)
    assert rec["collective_counts"]["all-gather"] > 0
    assert (rec["device"], rec["device_name"]) == ("cpu", None)


def _batch_of(arch):
    with FakeTensorMode():
        _, args, _ = dryrun.build_cell(arch, "train_4k", False,
                                       device="cpu")
        return args[2]


def test_cli_skips_and_refuses_cast_before_scan(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--cast-before-scan", "--device", "cpu", "--out",
                     str(tmp_path)])
    assert e.value.code == 2
    assert "no scan" in capsys.readouterr().err
    dryrun.main(["--arch", "llama3.2-3b", "--shape", "long_500k",
                 "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "llama3.2-3b_long_500k_1pod.json")
                     .read_text())
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


def test_report_table_and_replication_multiple(tmp_path):
    """The CLI's records give the sweep's table and the replication
    multiple: `--device-memory-bytes` judges the fit off the card, and a
    `--one-device` record is the whole step.  whisper-base's 8 query heads
    do not divide the 16-wide model axis, so its decode attention runs
    replicated over 'model' and a device does more than 1/256 of the
    one-device work."""
    common = ["--arch", "whisper-base", "--shape", "decode_32k", "--device",
              "cpu", "--out", str(tmp_path)]
    dryrun.main(common + ["--device-memory-bytes", str(2**20)])
    dryrun.main(common + ["--one-device"])
    cell = json.loads((tmp_path / "whisper-base_decode_32k_1pod.json")
                      .read_text())
    one = json.loads((tmp_path / "whisper-base_decode_32k_1dev.json")
                     .read_text())
    assert cell["device_memory_bytes"] == 2**20
    assert cell["fits_device_memory"] is False  # 0.44 GiB a device
    assert one["fits_device_memory"] is None and one["n_chips"] == 1
    assert cell["n_chips"] == 256 and "memory_tracker" not in cell
    multiple = cell["flops_per_device"] * cell["n_chips"] / one[
        "flops_per_device"]
    assert multiple > 1.0
    assert one["flops_per_device"] > cell["flops_per_device"] > 0
    assert sum(cell["collective_counts"].values()) == sum(
        cell["collectives_by_axes"].values())


def test_batch_of_one_cell_traces_with_replicated_axes():
    """mamba2-780m long_500k on two pods under `serve_tp_only`: 'pod' and
    'data' replicated, the step traces and issues no collective over
    them."""
    rec = dryrun.lower_cell("mamba2-780m", "long_500k", True,
                            serve_tp_only=True, device="cpu")
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert rec["collectives_by_axes"]
    assert all("pod" not in k and "data" not in k
               for k in rec["collectives_by_axes"])
