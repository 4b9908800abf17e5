"""The sharded model (ZeRO-3 + tensor parallel over a `Mesh`), its steps,
checkpoints, loop and engine, on gloo CPU ranks against the one-process
port and against the JAX package's own sharded model, and `moe_block_ep`
against the JAX package's.

One reduced model of each of the six families (and gemma-2b, whose one KV
head does not divide the model axis: its K/V projections are gathered
over it; and three layouts no config reaches on a 2-wide axis: three
query heads, attention replicated over 'model'; three SSD groups over six
heads; `policy.replicated_block_rules`, 'model' carrying batch rows, whose
decode is refused) runs on a (data=2, model=2) mesh of four processes
(rank code in tests/torch_dist_ranks.py, which loads no jax).  The one-process run it is
held to is the port's, which tests/test_torch_grad.py holds to
`jax.value_and_grad`; it runs each data rank's rows on their own, since
the expert-parallel MoE decides capacity per (column, batch rows) and
pmean's the aux loss over the batch axes (the reference's
`moe_block_ep`), and averages the two aux losses.  Tolerances (f32, the
bounds of tests/test_torch_grad.py; the sharded run adds partial sums in
another order):
- the loss within 1e-6 relative [largest seen 2.6e-7];
- the logits within 1e-5 x their largest |value| [5.3e-7];
- every gradient leaf, gathered whole, within 1e-5 x that leaf's largest
  |g| [2.7e-6, jamba's `ssm/dt_bias`], but whisper's cross-attention key
  bias, whose exact gradient is zero (tests/test_torch_grad.py), below
  1e-8 x the tree's largest |g|;
- four greedy decode steps (every head gathered, the cache's positions
  split over 'model', the softmax spread over it): the tokens equal, the
  logits within 1e-5 x their largest |value| on f32 caches and, on the
  dense and moe families' int8 caches, within 2 bf16 ulps of the largest
  (an entry the two runs round an f32 ulp apart may quantize a quantum
  apart: the 3-head variant's second step moved 8e-4).

One arch of each family (not gemma-2b) against the reference's own
sharded model, `build_model(cfg, mesh)` on a (data=2, model=2) mesh of 4
virtual CPU devices under `jax.jit(jax.value_and_grad)` (two
subprocesses, started before the gloo ranks so that they overlap), at
the same bounds: loss [largest seen 6.8e-8], aux [equal], logits [6.9e-7] and
every gradient leaf [4.5e-6, whisper's `dec_attn/wq`].  The reference's
MoE there is its `moe_block_ep`, so the per-column capacity and the aux
mean are held to it directly.

`moe_block_ep` against the reference's on 8 virtual CPU devices (a
subprocess), a (data=2, model=4) mesh at a capacity factor of 0.5, where
tokens drop: outputs within 1e-5 x their largest |value|, aux within 1e-6
relative, the same tokens dropped (the all-zero rows equal).

The train step on the (2, 2) mesh (llama3.2-3b with int8 first moments,
granite-moe-1b with fp32 ones) against one process for two steps, the
one-process gradients taken on each data rank's rows on their own as
above: losses within 1e-5 relative, the global gradient norm within 1e-5
relative, and each step's change of every parameter leaf within 1e-2 of
the one-process change in norm [largest seen 3.7e-4, llama's
`mlp/w_up` in the second step] (AdamW's first steps move every element
by about lr whatever its gradient, so the parameters themselves would
hide a skipped or misscaled update; halving the int8 scales fails it at
0.32); the checkpoint saved from
the mesh restores on one rank (`resume_on_new_mesh`) bit-equal to the
gathered live state.  `train.loop.run(mesh=)` resumes on every rank from
rank 0's checkpoints.  The engine on a (data=1, model=2) mesh: its
dispatch stream equal to the one-rank engine's on every rank, and its
tokens equal to the one-rank engine's in bf16.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import make_mesh, spawn
from repro_torch.models import params as TP
from repro_torch.models.io import init_caches
from repro_torch.models.model import cross_entropy_loss
from repro_torch.models.registry import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as TO
from repro_torch.train.elastic import resume_on_new_mesh
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import make_train_step, training_state_shardings
from torch_dist_ranks import (_specs_of, decode_run, family_batch, moe_ep,
                              redrawn_tree, sharded_engine, sharded_families,
                              sharded_train, variant_config)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-3b", "gemma-2b", "granite-moe-1b-a400m", "mamba2-780m",
         "jamba-1.5-large-398b", "whisper-base", "llama-3.2-vision-11b"]
# Layouts the ten configs do not reach on a 2-wide model axis: three query
# heads (attention replicated over 'model'), three B/C groups over six SSD
# heads (no rank holds whole groups: a group a head), and the policy's
# replicated block weights with 'model' in the batch group (4 rows).
VARIANTS = {
    "llama3.2-3b/3-heads": ("llama3.2-3b", {"cfg": {"n_heads": 3,
                                                     "n_kv_heads": 1}}),
    "mamba2-780m/3-groups": ("mamba2-780m", {"cfg": {"ssm": {
        "d_inner": 384, "n_groups": 3}}}),
    "llama3.2-3b/replicated-blocks": ("llama3.2-3b", {
        "rules": "replicated_blocks"}),
}
CASES = {a: (a, None) for a in ARCHS} | VARIANTS
ND = 2  # the data axis of the (2, 2) mesh


# The reference's own sharded model (`build_model(cfg, mesh)`, GSPMD on a
# (2, 2) mesh of virtual CPU devices) on one arch of each family.
REF_ARCHS = [a for a in ARCHS if a != "gemma-2b"]
_MODEL_REF = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.registry import reduced_config
from repro.distributed.mesh import make_mesh
from repro.models.model import cross_entropy_loss
from repro.models.registry import build_model
with open(sys.argv[1], "rb") as f:
    cases = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch, (tree, batch) in cases.items():
    cfg = reduced_config(arch)
    m = build_model(cfg, mesh, remat=False, compute_dtype=jnp.float32)
    specs = m.init(jax.random.key(0))[1]
    params = jax.tree.map(
        lambda a, s: jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)),
        tree, specs, is_leaf=lambda x: isinstance(x, np.ndarray))

    def loss_fn(params, batch):
        logits, aux = m.train_logits(params, batch)
        loss = cross_entropy_loss(logits, batch["labels"], cfg.vocab)
        return loss + 0.01 * aux, (loss, aux, logits)

    (_, (loss, aux, logits)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    out[arch] = {"loss": float(loss), "aux": float(aux),
                 "logits": np.asarray(logits),
                 "grads": jax.tree.map(np.asarray, grads)}
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's sharded runs in two subprocesses (jamba's compile
    takes as long as the other five), started before the gloo ranks so
    that the three overlap."""
    d = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    hybrid = [a for a in REF_ARCHS if reduced_config(a).family == "hybrid"]
    runs = []
    for i, archs in enumerate((hybrid, [a for a in REF_ARCHS
                                        if a not in hybrid])):
        with open(d / f"in{i}.pkl", "wb") as f:
            pickle.dump({a: (redrawn_tree(a), family_batch(a))
                         for a in archs}, f)
        runs.append((subprocess.Popen(
            [sys.executable, "-c", _MODEL_REF, str(d / f"in{i}.pkl"),
             str(d / f"out{i}.pkl")], env=env, stderr=subprocess.PIPE,
            text=True), d / f"out{i}.pkl"))
    yield runs
    for proc, _ in runs:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    out = {}
    for proc, path in reference_run:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as f:
            out |= pickle.load(f)
    return out


@pytest.fixture(scope="module")
def sharded(reference_run):
    cases = []
    for name, (arch, v) in CASES.items():
        B = 4 if (v or {}).get("rules") else 2
        cases.append((name, arch, redrawn_tree(arch, variant=v),
                      family_batch(arch, B=B, variant=v), v))
    out = spawn(sharded_families, (ND, 2), ("data", "model"), device="cpu",
                args=(cases,))[0]
    return {n: (arch, tree, batch, v, out[n])
            for n, arch, tree, batch, v in cases}


def _rank_rows(model, params, batch):
    """(loss, aux, logits, gradients of loss + 0.01 aux) of the port in
    one process, each data rank's rows on their own (the expert-parallel
    capacity is per rank) and the aux averaged over them, as the mesh's."""
    flat = [w for _, w in TP.leaves(params)]
    for w in flat:
        w.requires_grad_(True)
    n = batch["tokens"].shape[0] // ND
    logits, aux = [], 0.0
    with torch.enable_grad():
        for r in range(ND):
            b = {k: torch.as_tensor(v[r * n:(r + 1) * n]) for k, v in
                 batch.items()}
            lg, a = model.train_logits(params, b)
            logits.append(lg)
            aux = aux + a / ND
        logits = torch.cat(logits)
        loss = cross_entropy_loss(logits, torch.as_tensor(batch["labels"]),
                                  model.cfg.vocab)
        grads = torch.autograd.grad(loss + 0.01 * aux, flat)
    return (loss.detach(), torch.as_tensor(aux).detach(), logits.detach(),
            {p: g for (p, _), g in zip(TP.leaves(params), grads)})


def _one_process(arch, tree, batch, variant=None):
    """The port in one process, each data rank's rows on their own."""
    cfg = variant_config(arch, variant)
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    loss, aux, logits, grads = _rank_rows(model, params, batch)
    return (float(loss), float(aux), logits.numpy(),
            {p: g.numpy() for p, g in grads.items()})


@pytest.mark.parametrize("name", CASES)
def test_sharded_loss_logits_and_grads_match_one_process(sharded, name):
    arch, tree, batch, variant, got = sharded[name]
    loss, aux, logits, grads = _one_process(arch, tree, batch, variant)
    assert np.isfinite(loss) and abs(got["loss"] - loss) <= 1e-6 * loss
    assert abs(got["aux"] - aux) <= 1e-6 * max(abs(aux), 1e-30)
    scale = np.abs(logits).max()
    assert np.abs(got["logits"] - logits).max() <= 1e-5 * scale
    assert sorted(got["grads"]) == sorted(grads)
    top = max(float(np.abs(w).max()) for w in grads.values())
    for path, w in grads.items():
        g = got["grads"][path]
        assert g.shape == w.shape, path
        if path.endswith("cross/bk"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-8 * top
            continue
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path
    counts = got["train_counts"]
    # the ZeRO gathers and their gradients' reduce-scatters over 'data'
    assert counts["all_gather:data"] > 0 and counts["psum_scatter:data"] > 0
    if (variant or {}).get("rules"):
        # 'model' carries batch rows: weights gathered over it, no TP
        assert counts["psum_scatter:model"] > 0 and "pmax:model" not in counts
        assert "prefill and decode" in got["decode_refused"]
    else:  # the row-parallel sums over 'model', the sharded loss's pmax
        assert counts["psum:model"] > 0 and counts["pmax:model"] == 1


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_sharded_loss_logits_and_grads_match_reference_sharded(
        sharded, reference, arch):
    """The port's sharded run against the reference's own on the same
    (2, 2) mesh layout, at the one-process bounds: the MoE's per-column
    capacity and aux mean are the reference's `moe_block_ep`'s."""
    got, want = sharded[arch][4], reference[arch]
    assert np.isfinite(want["loss"])
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * want["loss"]
    assert abs(got["aux"] - want["aux"]) <= 1e-6 * max(abs(want["aux"]),
                                                        1e-30)
    if reduced_config(arch).moe:
        assert want["aux"] > 0
    scale = np.abs(want["logits"]).max()
    assert np.abs(got["logits"] - want["logits"]).max() <= 1e-5 * scale
    grads = dict(TP.leaves(want["grads"]))
    assert sorted(got["grads"]) == sorted(grads)
    top = max(float(np.abs(w).max()) for w in grads.values())
    for path, w in grads.items():
        g = got["grads"][path]
        assert g.shape == w.shape, path
        if path.endswith("cross/bk"):
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-8 * top
            continue
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), path


@pytest.mark.parametrize("name", [n for n, (_, v) in CASES.items()
                                  if not (v or {}).get("rules")])
def test_sharded_decode_matches_one_process(sharded, name):
    arch, tree, _, variant, got = sharded[name]
    cfg = variant_config(arch, variant)
    for int8, res in got["decode"].items():
        model = build_model(cfg, compute_dtype=torch.float32, device="cpu",
                            kv_int8=int8)
        params = params_from_numpy(tree, cfg, device="cpu",
                                   dtype=torch.float32)
        caches = init_caches(cfg, 4, 16, dtype=torch.float32, device="cpu",
                             kv_int8=int8)
        logits, toks = decode_run(model, params, caches, 4, 4)
        for a, b in zip(res["logits"], logits):
            b = b.numpy()
            top = np.abs(b).max()
            # an int8 cache entry whose f32 input the two runs round an ulp
            # apart may land a quantum apart: int8 logits take the bf16
            # bound of 2 ulps of the largest (chip_smoke.py's M3)
            bound = 2 * 2.0 ** (np.floor(np.log2(top)) - 7) if int8 else (
                1e-5 * top)
            assert np.abs(a - b).max() <= bound, int8
        for a, b in zip(res["tokens"], toks):
            np.testing.assert_array_equal(a, b.numpy())


_MOE_REF = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed.mesh import make_mesh
from repro.models.layers.moe import MoEDims, moe_block_ep
a = np.load(sys.argv[1])
dims = MoEDims(**json.loads(sys.argv[2]))
mesh = make_mesh((2, 4), ("data", "model"))
y, aux = jax.jit(lambda *t: moe_block_ep(*t, dims, mesh, ("data",)))(
    *(jnp.asarray(a[k]) for k in ("x", "router", "wg", "wu", "wd")))
np.savez(sys.argv[3], y=np.asarray(y), aux=np.asarray(aux))
"""


def test_moe_block_ep_matches_reference_with_drops(tmp_path):
    rng = np.random.default_rng(3)
    B, S, D, F, E = 4, 16, 32, 48, 8
    arrays = {"x": rng.standard_normal((B, S, D)),
              "router": rng.standard_normal((D, E)),
              "wg": 0.2 * rng.standard_normal((E, D, F)),
              "wu": 0.2 * rng.standard_normal((E, D, F)),
              "wd": 0.2 * rng.standard_normal((E, F, D))}
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    dims = dict(n_experts=7, n_experts_pad=E, top_k=2, capacity_factor=0.5)
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", _MOE_REF, str(tmp_path / "in.npz"),
         json.dumps(dims), str(tmp_path / "out.npz")], env=env,
        stderr=subprocess.PIPE, text=True)
    out = spawn(moe_ep, (2, 4), ("data", "model"), device="cpu",
                args=(arrays["x"], arrays["router"], arrays["wg"],
                      arrays["wu"], arrays["wd"], dims))
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    want = np.load(tmp_path / "out.npz")
    y = np.concatenate([out[0]["y"], out[4]["y"]])  # data rows 0 and 1
    for r in range(8):  # every column holds its data rows' sum
        np.testing.assert_array_equal(out[r]["y"], out[r // 4 * 4]["y"])
        assert abs(float(out[r]["aux"]) - float(want["aux"])) <= (
            1e-6 * abs(float(want["aux"])))
    assert np.abs(y - want["y"]).max() <= 1e-5 * np.abs(want["y"]).max()
    dropped = np.all(want["y"] == 0, axis=-1)
    assert dropped.any()  # the capacity drops tokens
    np.testing.assert_array_equal(np.all(y == 0, axis=-1), dropped)
    assert out[0]["counts"] == {"psum:model": 1, "psum:data": 1}


TRAIN = [("llama3.2-3b", "int8"), ("granite-moe-1b-a400m", "fp32")]


def _train_batches(arch):
    rng = np.random.default_rng(2)
    vocab = reduced_config(arch).vocab
    out = []
    for _ in range(2):
        tok = rng.integers(0, vocab, (2, 17)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    cases = [(a, redrawn_tree(a, seed=2), _train_batches(a), sd)
             for a, sd in TRAIN]
    return d, spawn(sharded_train, (ND, 2), ("data", "model"),
                    device="cpu", args=(cases, str(d)))


def _one_process_steps(cfg, tree, batches, opt):
    """The one-process train step (`make_train_step`'s loss, gradient norm
    and `adamw_update`) on `_rank_rows`' gradients: each step's metrics
    and parameters."""
    model = build_model(cfg, compute_dtype=torch.float32, device="cpu")
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    st = adamw_init(params, opt)
    out = []
    for b in batches:
        loss, aux, _, grads = _rank_rows(model, params, b)
        grads = TO.tree_unflatten(params, [grads[p] for p in
                                           TO.tree_paths(params)])
        gnorm = TO.grad_norm(grads)
        params, st = TO.adamw_update(params, grads, st, opt, gnorm=gnorm)
        out.append(({"loss": float(loss), "total_loss": float(
            loss + 0.01 * aux), "grad_norm": float(gnorm)},
            {p: w.detach().numpy().copy() for p, w in TP.leaves(params)}))
    return params, out


@pytest.mark.parametrize("arch,state_dtype", TRAIN)
def test_sharded_train_step_and_checkpoint(trained, arch, state_dtype):
    ckpt_dir, ranks = trained
    got = ranks[0][arch]
    tree, batches = redrawn_tree(arch, seed=2), _train_batches(arch)
    cfg = reduced_config(arch)
    opt = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    params, want = _one_process_steps(cfg, tree, batches, opt)
    before = {p: w.numpy() for p, w in TP.leaves(params_from_numpy(
        tree, cfg, device="cpu", dtype=torch.float32))}
    got_before = before
    for (wm, wp), m, snap in zip(want, got["metrics"], got["snaps"]):
        for k in ("loss", "total_loss", "grad_norm"):
            assert abs(m[k] - wm[k]) <= 1e-5 * abs(wm[k]), k
        # each step's change of every leaf, which AdamW's first steps make
        # about lr an element whatever the gradient: within 1e-2 of the
        # one-process change's norm
        for path, w in wp.items():
            g = np.asarray(TP.spec_at(snap, path))
            dw, dg = w - before[path], g - got_before[path]
            assert np.linalg.norm(dg - dw) <= 1e-2 * np.linalg.norm(dw), (
                path, np.linalg.norm(dg - dw) / np.linalg.norm(dw))
        before, got_before = wp, {p: np.asarray(TP.spec_at(snap, p))
                                  for p in wp}
    assert all(np.isfinite(m["loss"]) for m in got["metrics"])
    # the (2, 2) checkpoint restores on one rank, bit-equal to the
    # gathered live state
    with make_mesh((1, 1), ("data", "model"), device="cpu") as one:
        _, model = make_train_step(cfg, one, opt, device="cpu",
                                   compute_dtype=torch.float32)
        like = {"params": params, "opt": adamw_init(params, opt)}
        _, o_sh = training_state_shardings(cfg, one, opt, params,
                                           model.specs)
        back = resume_on_new_mesh(str(ckpt_dir / arch), like, one,
                                  {"params": model.specs,
                                   "opt": _specs_of(o_sh)})
    flat_back = ckpt.persist.flatten_with_paths(back)
    flat_live = ckpt.persist.flatten_with_paths(got["state"])
    assert flat_back[0] == flat_live[0]
    for a, b in zip(flat_back[1], flat_live[1]):  # bf16 v exact in f32
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b))


def test_loop_runs_and_resumes_on_a_mesh(trained):
    ckpt_dir, ranks = trained
    first, again = ranks[0]["loop"]
    assert first["resumed_from"] is None and len(first["losses"]) == 2
    assert all(np.isfinite(first["losses"]))
    for r in ranks:  # every rank ran the same loop and resumed at step 2
        assert r["loop"] == ranks[0]["loop"]
    assert again["resumed_from"] == 2 and len(again["losses"]) == 1
    assert ckpt.latest_step(ckpt_dir / "loop") == 3


def test_sharded_engine_matches_the_one_rank_engine():
    from repro_torch.core.classifier.dataset import make_training_set
    from repro_torch.core.classifier.tree import train_tree
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    arch = "llama3.2-3b"
    tree = redrawn_tree(arch, seed=4)
    dtree = train_tree(*make_training_set(), 4, max_depth=8)
    wl = [[dict(uid=t * 3 + i, prompt_len=4, max_new_tokens=3 + i)
           for i in range(3)] for t in range(4)] + [[]] * 4
    got = spawn(sharded_engine, (1, 2), ("data", "model"), device="cpu",
                args=(arch, tree, wl, 4, 16, 12, dtree))
    cfg = reduced_config(arch)
    eng = ServeEngine(cfg, params_from_numpy(tree, cfg, device="cpu"),
                      EngineConfig(batch_size=4, max_seq=16), device="cpu",
                      seed=0, tree=dtree)
    stream = []
    tick = eng.scheduler.tick

    def logged(arrivals, n_dispatch):
        d = tick(arrivals, n_dispatch=n_dispatch)
        stream.append([r.uid for r in d])
        return d

    eng.scheduler.tick = logged
    res = eng.run([[Request(**r) for r in reqs] for reqs in wl],
                  max_steps=12)
    for g in got:
        assert g["stream"] == stream
        assert g["outputs"] == eng.outputs
        assert g["completed"] == res["completed"] > 0
    assert got[0]["counts"]["psum:model"] > 0
