"""The sharding slice's rules, spec trees and placement against the JAX
package, on the CPU.

Spec parity is exact, entry for entry (``tuple(spec)``): every
`ShardingRules` field and default, `strip_pod`, `drop_batch_axes`,
`tp_only_params`, `tp_starved`, `replicated_block_rules` and
`apply_policy` for all ten configs on {data, model} and {pod, data,
model} meshes (the reference reads only a mesh's `shape` and
`axis_names`, so a namespace stands in for a JAX mesh); the spec tree of
`init_params` (the reference's captured while `jax.eval_shape` traces it,
so no full-size weights are drawn) at model axes 1 and 16;
`opt_state_specs` (int8, fp32), `batch_spec_tree` (train, prefill,
decode, int8 KV) and `fit_spec_to_mesh`.

On gloo ranks (one process each; rank code in tests/torch_dist_ranks.py,
which loads no jax): `local_shard` is JAX's block layout (contiguous,
row-major over an axis tuple) and `gather_full` inverts it, bit-equal;
`constraint` re-lays a tensor between specs; and the port's version of
tests/device_scripts/elastic_check.py: a (pod=2, data=4) state rescaled
live to four ranks (`sub_mesh`), through a checkpoint saved from the
eight, and one train-like step on both meshes, bit-equal (the step is
elementwise).
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.configs.registry import get_config as j_get_config
from repro.distributed import policy as JPol
from repro.distributed import sharding as JS
from repro.models.params import init_params as j_init_params
from repro.train import elastic as JE
from repro.train import optimizer as JO
from repro.train import steps as JSteps
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.distributed import policy as TPol
from repro_torch.distributed import sharding as TS
from repro_torch.distributed import spawn
from repro_torch.models import params as TP
from repro_torch.train import elastic as TE
from repro_torch.train import optimizer as TO
from repro_torch.train import steps as TSteps
from torch_dist_ranks import elastic, placement

MESHES = {
    "data_model": types.SimpleNamespace(
        shape={"data": 4, "model": 16}, axis_names=("data", "model")),
    "pod_data_model": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}


def _fields(rules):
    return {f.name: tuple(getattr(rules, f.name))
            for f in dataclasses.fields(rules)}


def _flat(tree, is_leaf, prefix=""):
    """(path, spec entries) of a spec tree, dicts and tuples walked."""
    if is_leaf(tree):
        return [(prefix, tuple(tree))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat(tree[k], is_leaf, f"{prefix}/{k}")]
    return [x for i, v in enumerate(tree)
            for x in _flat(v, is_leaf, f"{prefix}[{i}]")]


def _j_flat(tree):
    return _flat(tree, lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _t_flat(tree):
    return _flat(tree, TS.is_spec)


def test_rules_and_transforms_equal_reference():
    assert _fields(TS.ShardingRules()) == _fields(JS.ShardingRules())
    assert _fields(TS.default_rules()) == _fields(JS.default_rules())
    for mesh in MESHES.values():
        for tf, jf in ((TS.strip_pod, JS.strip_pod),):
            assert (_fields(tf(TS.ShardingRules(), mesh))
                    == _fields(jf(JS.ShardingRules(), mesh)))
    pairs = [(TS.drop_batch_axes, JS.drop_batch_axes),
             (TS.tp_only_params, JS.tp_only_params),
             (TPol.replicated_block_rules, JPol.replicated_block_rules)]
    for tf, jf in pairs:
        t, j = tf(TS.ShardingRules()), jf(JS.ShardingRules())
        assert _fields(t) == _fields(j), tf.__name__
        # and composed with strip_pod on the pod-less mesh
        m = MESHES["data_model"]
        assert (_fields(tf(TS.strip_pod(TS.ShardingRules(), m)))
                == _fields(jf(JS.strip_pod(JS.ShardingRules(), m))))
    assert TS.pad_to_multiple(40, 16) == JS.pad_to_multiple(40, 16) == 48


@pytest.mark.parametrize("arch", list_configs())
def test_policy_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for n in (1, 2, 4, 16, 64):
        assert TPol.tp_starved(cfg, n) == JPol.tp_starved(jcfg, n), n
    for mesh in MESHES.values():
        for gb in (None, 7, 256):
            t = TPol.apply_policy(cfg, mesh, TS.strip_pod(
                TS.ShardingRules(), mesh), global_batch=gb)
            j = JPol.apply_policy(jcfg, mesh, JS.strip_pod(
                JS.ShardingRules(), mesh), global_batch=gb)
            assert _fields(t) == _fields(j), (mesh.axis_names, gb)


def _j_specs(arch, model_axis, rules):
    """The reference `init_params`' spec tree, captured while
    `jax.eval_shape` traces it (shapes only)."""
    box = {}

    def f(key):
        params, specs = j_init_params(j_get_config(arch), key, rules,
                                      model_axis)
        box["specs"] = specs
        return params

    shapes = jax.eval_shape(f, jax.random.key(0))
    return box["specs"], shapes


@pytest.mark.parametrize("arch", list_configs())
def test_param_spec_tree_equals_reference(arch):
    cfg = get_config(arch)
    for model_axis in (1, 16):
        jspecs, jshapes = _j_specs(arch, model_axis, JS.ShardingRules())
        tspecs = TP.param_specs(cfg, TS.ShardingRules(), model_axis)
        assert _t_flat(tspecs) == _j_flat(jspecs), model_axis
        # the layouts' shapes too (the padded experts follow the axis)
        got = {p: s for p, (s, _) in TP.leaves(TP.param_layout(
            cfg, model_axis))}
        want = {p: tuple(a.shape) for p, a in TP.leaves(jshapes)}
        assert got == want, model_axis
        if cfg.moe and model_axis == 16 and arch == "granite-moe-3b-a800m":
            assert TP.padded_experts(cfg, 16) == 48


@pytest.mark.parametrize("arch", ["granite-8b", "jamba-1.5-large-398b",
                                  "whisper-base", "mamba2-780m"])
@pytest.mark.parametrize("state_dtype", ["int8", "fp32"])
def test_opt_state_specs_equal_reference(arch, state_dtype):
    jspecs, jshapes = _j_specs(arch, 16, JS.ShardingRules())
    tspecs = TP.param_specs(get_config(arch), TS.ShardingRules(), 16)
    meta = TO.tree_map(lambda s: torch.empty(s[0], device="meta"),
                       TP.param_layout(get_config(arch), 16))
    got = TO.opt_state_specs(meta, tspecs,
                             TO.AdamWConfig(state_dtype=state_dtype))
    want = JO.opt_state_specs(jshapes, jspecs,
                              JO.AdamWConfig(state_dtype=state_dtype))
    for t, j in zip(got, want):
        assert _t_flat(t) == _j_flat(j)


@pytest.mark.parametrize("arch", list_configs())
def test_batch_spec_tree_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for kind, gb in (("train", 256), ("prefill", 32), ("decode", 128),
                     ("train", 1)):
        for kv_int8 in (False, True):
            t = TSteps.batch_spec_tree(
                cfg, ShapeConfig("s", 128, gb, kind), TS.ShardingRules(),
                MESHES["pod_data_model"], kv_int8=kv_int8)
            j = JSteps.batch_spec_tree(
                jcfg, JShape("s", 128, gb, kind), JS.ShardingRules(),
                MESHES["pod_data_model"], kv_int8=kv_int8)
            assert _t_flat(t) == _j_flat(j), (kind, gb, kv_int8)


def test_fit_spec_to_mesh_equals_reference():
    spec = {"w": TS.P(("pod", "data"), None, "model"),
            "m": (TS.P("pod", ("data", "model")), TS.P()),
            "b": TS.P(None, "data")}
    jspec = {"w": JS.P(("pod", "data"), None, "model"),
             "m": (JS.P("pod", ("data", "model")), JS.P()),
             "b": JS.P(None, "data")}
    for names in (("data",), ("data", "model"), ("pod", "model")):
        m = types.SimpleNamespace(axis_names=names)
        assert (_t_flat(TE.fit_spec_to_mesh(spec, m))
                == _j_flat(JE.fit_spec_to_mesh(jspec, m))), names


def test_constraint_pads_the_spec_and_names_mesh_axes():
    class One:
        shape = {"data": 1, "model": 1}
        axis_names = ("data", "model")

        @staticmethod
        def axis_size(axes):
            return 1

        @staticmethod
        def device_rank(axes):
            return 0

    x = torch.arange(24.).reshape(2, 3, 4)
    # a spec shorter than the tensor is right-padded with None
    assert torch.equal(TS.constraint(x, One, TS.P("data")), x)
    assert TS.fit_rank(TS.P("data"), 3) == TS.P("data", None, None)
    with pytest.raises(ValueError, match="not in the mesh"):
        TS.local_shard(x, One, TS.P("pod"))


def test_model_uses_the_mesh_or_raises():
    """A mesh is used or the model refuses it: rules lose 'pod' on a
    pod-less mesh (`strip_pod`), and a rule naming an axis the mesh lacks,
    or a mesh axis wider than 1 that no rule names, raises."""
    from repro_torch.models.registry import build_model

    def mesh(**shape):
        return types.SimpleNamespace(shape=shape, axis_names=tuple(shape),
                                     device=torch.device("cpu"))

    cfg = get_config("llama3.2-3b")
    for m, match in ((mesh(pod=1, shard=2), r"\['data', 'model'\]"),
                     (mesh(data=4), r"\['model'\]"),
                     (mesh(data=1, model=1, extra=2), r"\['extra'\]")):
        with pytest.raises(ValueError, match=match):
            build_model(cfg, m, device="cpu")
    ok = mesh(data=2, model=1)
    assert TS.check_rules(TS.strip_pod(TS.ShardingRules(), ok), ok) == (
        TS.strip_pod(TS.ShardingRules(), ok))
    # a mesh axis of size 1 that no rule names is harmless
    assert TS.check_rules(TS.tp_only_params(TS.strip_pod(
        TS.ShardingRules(), ok)), mesh(data=1, model=2, spare=1))


def test_local_shard_and_gather_full_on_gloo_ranks():
    """JAX's block layout on a (pod=2, data=2, model=2) mesh: each rank's
    block is the slice `jax.device_put` gives its device, and
    `gather_full` rebuilds the array, bit-equal."""
    full = np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4)
    specs = [(("pod", "data"), "model"), ("model", ("data", "pod")),
             (None, ("pod", "data", "model")), (("model", "pod"),)]
    out = spawn(placement, (2, 2, 2), ("pod", "data", "model"),
                device="cpu", args=(full, specs))
    coords = [(p, d, m) for p in range(2) for d in range(2)
              for m in range(2)]
    size = {"pod": 2, "data": 2, "model": 2}
    for r, (p, d, m) in enumerate(coords):
        at = {"pod": p, "data": d, "model": m}
        for i, spec in enumerate(specs):
            want = full
            for dim, e in enumerate(spec):
                axes = () if e is None else (e,) if isinstance(e, str) else e
                if not axes:
                    continue
                n, k = 1, 0
                for a in axes:
                    n, k = n * size[a], k * size[a] + at[a]
                blk = want.shape[dim] // n
                want = np.take(want, range(k * blk, (k + 1) * blk), dim)
            np.testing.assert_array_equal(out[r]["blocks"][i], want)
            np.testing.assert_array_equal(out[r]["round"][i], full)
        np.testing.assert_array_equal(out[r]["moved"], full)


def test_elastic_rescale_on_gloo_ranks(tmp_path):
    state = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
             "m": np.ones((8, 8), np.float32)}
    out = spawn(elastic, (2, 4), ("pod", "data"), device="cpu",
                args=(state, str(tmp_path / "ck")))
    step = {"w": state["w"] - state["w"] * np.float32(0.1),
            "m": state["m"] * np.float32(0.9) + state["w"] * np.float32(0.1)}
    for r in range(8):
        np.testing.assert_array_equal(out[r]["blocks8"]["w"],
                                      state["w"][r:r + 1])
        for k in state:
            np.testing.assert_array_equal(out[r]["step8"][k], step[k])
        if r >= 4:
            assert "live4" not in out[r]
            continue
        assert tuple(out[r]["spec4"]["w"]) == ("data", None)
        np.testing.assert_array_equal(out[r]["rows4"],
                                      state["w"][2 * r:2 * r + 2])
        for k in state:  # live 8 -> 4, checkpoint 8 -> 4, the same step
            np.testing.assert_array_equal(out[r]["live4"][k], state[k])
            np.testing.assert_array_equal(out[r]["ckpt4"][k], state[k])
            np.testing.assert_array_equal(out[r]["step4"][k],
                                          out[r]["step8"][k])
