"""The port's examples (`repro_torch.examples`) against the JAX package's
(examples/*.py), on the CPU.

- quickstart: with the reference's `jax.random` draws (its key chain:
  split the running key, the step takes the second half), the carry
  (`carry_fingerprint`), the size and mode after each phase, the
  transitions and the drained keys equal a run of the reference's
  quickstart loop (examples/quickstart.py:20-47); without draws the
  example runs through to its OK line.
- sssp: every schedule's distances equal `bellman_ford`'s and, with the
  reference's draws, the whole `SSSPResult` (steps, pops, wasted pops,
  modes, transitions) equals the reference's runs of
  examples/sssp.py:42-66.
- serve_demo: with the reference's reduced llama3.2-3b parameters
  converted and both engines built in f32 (their `build_model` and
  `init_caches` patched, as tests/test_torch_serve.py's f32 cases do), the
  run summary (completed, steps, mode trace, PQ transitions), the
  completion steps and the outputs equal the reference's engine on
  examples/serve_demo.py:24-62's workload; in bf16 every request
  completes.
- train_demo: a narrowed `CFG_100M` (2 layers x 64) through the example's
  summary function, 4 steps at batch 2 with a checkpoint every 2, from the
  reference's initial parameters (the port's loop draws its own; the test
  patches `train.loop.init_params`): the resume step equals the
  reference's run of the example's two `run` calls, and every loss is
  within 1e-4 relative of the reference's.  Both compute in bf16 from f32
  masters, whose matmuls round apart (measured on the CPU, torch
  2.13.0+cpu and jax 0.9.0: largest 1.3e-5).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.io as JIO
import repro.models.registry as JMR
import repro.serve.scheduler as JSM
import repro.workloads.registry as JR
import repro_torch.models.io as TIO
import repro_torch.models.registry as TMR
import repro_torch.train.loop as TL
import repro_torch.workloads.registry as TR
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.registry import reduced_config as j_reduced_config
from repro.core.classifier.dataset import make_training_set as j_training_set
from repro.core.classifier.tree import train_tree as j_train_tree
from repro.core.pqueue.ops import OP_DELETE_MIN as J_DEL
from repro.core.pqueue.ops import OP_INSERT as J_INS
from repro.core.pqueue.schedules import Schedule as JS
from repro.core.smartpq import SmartPQ as JPQ
from repro.core.smartpq import SmartPQConfig as JCfg
from repro.core.smartpq import carry_fingerprint as j_fingerprint
from repro.data.synthetic import SyntheticLMDataset as JSynthetic
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import run as j_run
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.workloads import graphs as JG
from repro.workloads import sssp as JSS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.tree import train_tree
from repro_torch.core.smartpq import carry_fingerprint
from repro_torch.examples import quickstart, serve_demo, sssp, train_demo
from torch_draws import chunked_keys, draws_from_keys, scheduler_keys

torch.set_num_threads(1)

INF_KEY = 2**31 - 1


@pytest.fixture(scope="module")
def trees():
    """Each package's decision tree (equal: tests/test_torch_smartpq.py),
    trained once; the reference's registry and scheduler queues take it."""
    jtree = j_train_tree(*j_training_set(), 4, max_depth=8)
    ttree = train_tree(*make_training_set(), 4, max_depth=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR, "_TREE", jtree)
        mp.setattr(TR, "_TREE", ttree)
        mp.setattr(JSM, "SmartPQ", functools.partial(JPQ, tree=jtree))
        yield jtree, ttree


def _j_quickstart(jtree):
    """examples/quickstart.py's loop (its lines 20-43), with the carry."""
    pq = JPQ(JCfg(num_shards=16, capacity=4096, npods=2,
                  decision_interval=4), tree=jtree)
    carry = pq.init()
    step = jax.jit(pq.step)
    rng = np.random.default_rng(0)
    key = jax.random.key(0)
    B = 64
    for _ in range(12):
        ops = jnp.full((B,), J_INS, jnp.int32)
        keys = jnp.asarray(rng.integers(0, 1 << 20, B), jnp.int32)
        key, sub = jax.random.split(key)
        carry, _ = step(carry, ops, keys, jnp.arange(B, dtype=jnp.int32),
                        sub, 512)
    inserted = (int(carry.state.total_size), int(carry.stats.mode))
    drained = []
    for _ in range(12):
        ops = jnp.full((B,), J_DEL, jnp.int32)
        key, sub = jax.random.split(key)
        carry, res = step(carry, ops, jnp.full((B,), INF_KEY, jnp.int32),
                          jnp.zeros(B, jnp.int32), sub, 512)
        drained.extend(np.asarray(res.keys)[: int(res.n_out)].tolist())
    return carry, inserted, drained


def test_quickstart_with_jax_draws_matches_jax(trees, capsys):
    jtree, ttree = trees
    jcarry, inserted, drained = _j_quickstart(jtree)
    got = quickstart.quickstart(
        device="cpu", tree=ttree,
        draws=draws_from_keys(scheduler_keys(0, 24), 16, 64, 256))
    assert carry_fingerprint(got["carry"]) == j_fingerprint(jcarry)
    assert got["inserted"] == inserted
    assert (got["size"], got["mode"], got["transitions"]) == (
        int(jcarry.state.total_size), int(jcarry.stats.mode),
        int(jcarry.stats.transitions))
    assert got["drained"] == drained
    assert capsys.readouterr().out.splitlines()[-1].startswith("OK — ")


def test_quickstart_runs_from_a_generator(trees, capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == ("OK — SmartPQ adapted between algorithmic modes "
                       "with zero data movement.")


def _j_sssp():
    """examples/sssp.py's runs (its lines 42-66): name -> SSSPResult."""
    g = JG.random_graph(n=512, seed=0)
    out = {name: JSS.run_sssp(g, JS[sched.name], m=32, seed=1)
           for name, sched in sssp.FIXED}
    out[sssp.ADAPTIVE] = JSS.run_sssp_smartpq(
        g, JR.default_pq(head_width=256), m=16, seed=1)[0]
    return out


def test_sssp_with_jax_draws_matches_jax_and_bellman_ford(trees, capsys):
    want = _j_sssp()
    widths = {sssp.ADAPTIVE: 16 * 8 + 16}  # m * deg_cap + m
    draws = {name: draws_from_keys(chunked_keys(1, r.steps, 8), 8,
                                   widths.get(name, 32), 256)
             for name, r in want.items() if name != "exact/Nuddle(HIER)"}
    got = sssp.sssp_demo(device="cpu", draws=draws)
    np.testing.assert_array_equal(
        got["ref"], JG.bellman_ford(JG.random_graph(n=512, seed=0)))
    assert list(got["runs"]) == list(want)
    for name, r in got["runs"].items():
        w = want[name]
        np.testing.assert_array_equal(r.dist, got["ref"], err_msg=name)
        for f in w._fields:
            a, b = getattr(w, f), getattr(r, f)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f"{name} {f}")
            else:
                assert a == b, (name, f, a, b)
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("OK — every mode converges to Bellman-Ford")


def _j_tree(arch):
    jm = JMR.build_model(j_reduced_config(arch), remat=False)
    return jax.tree.map(np.asarray, jm.init(jax.random.key(0))[0])


def _patch_f32(mp):
    mp.setattr(JMR, "build_model", functools.partial(
        JMR.build_model, compute_dtype=jnp.float32))
    mp.setattr(JIO, "init_caches", functools.partial(
        JIO.init_caches, dtype=jnp.float32))
    mp.setattr(TMR, "build_model", functools.partial(
        TMR.build_model, compute_dtype=torch.float32))
    mp.setattr(TIO, "init_caches", functools.partial(
        TIO.init_caches, dtype=torch.float32))


def test_serve_demo_matches_jax_in_f32_and_completes_in_bf16(trees,
                                                              capsys):
    from repro.serve.scheduler import Request as JRequest

    jtree, ttree = trees
    arch = serve_demo.ARCH
    tree = _j_tree(arch)
    with pytest.MonkeyPatch.context() as mp:
        _patch_f32(mp)
        ref = JServeEngine(j_reduced_config(arch),
                           jax.tree.map(jnp.asarray, tree),
                           JEngineConfig(**serve_demo.ENGINE))
        workload, total = serve_demo.bursty_workload()
        jworkload = [[JRequest(uid=r.uid, prompt_len=r.prompt_len,
                               max_new_tokens=r.max_new_tokens,
                               slo_class=r.slo_class) for r in reqs]
                     for reqs in workload]
        want = ref.run(jworkload, max_steps=400)
        got = serve_demo.serve_demo(
            device="cpu", tree=ttree,
            params=params_from_numpy(tree, reduced_config(arch),
                                     device="cpu", dtype=torch.float32),
            draws=draws_from_keys(scheduler_keys(0, want["steps"] + 1), 16,
                                  64, 256))
    eng, summary = got["engine"], got["summary"]
    assert summary["completed"] == want["completed"] == total == 24
    for k in ("steps", "mode_trace", "pq_transitions"):
        assert summary[k] == want[k], k
    assert eng.done_step == ref.done_step
    assert eng.outputs == ref.outputs
    bf16 = serve_demo.serve_demo(device="cpu", tree=ttree)
    assert bf16["summary"]["completed"] == 24
    assert capsys.readouterr().out.splitlines()[-1] == (
        "OK — all requests served under SmartPQ continuous batching.")


NARROW = dict(name="demo-narrow", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128)


def _j_train_demo(jcfg, steps, batch, ckpt_every, ckpt_dir):
    """examples/train_demo.py's two `run` calls (its lines 56-78) on
    `jcfg`: the phases' summaries."""
    data = JSynthetic(vocab=jcfg.vocab, seq_len=train_demo.SEQ_LEN, seed=0,
                      fixed_map=True)
    opt = JAdamW(lr=6e-4, state_dtype="bf16", weight_decay=0.01)
    res1 = j_run(jcfg, JLoopConfig(steps=steps // 2, batch_size=batch,
                                   ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                                   log_every=20), opt_cfg=opt, data=data)
    res2 = j_run(jcfg, JLoopConfig(steps=steps, batch_size=batch,
                                   ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
                 opt_cfg=opt, data=data)
    return res1, res2


def test_train_demo_resumes_like_jax(tmp_path, capsys, monkeypatch):
    steps, batch, every = 4, 2, 2
    jcfg = dataclasses.replace(
        JModelConfig(**{f.name: getattr(train_demo.CFG_100M, f.name)
                        for f in dataclasses.fields(JModelConfig)
                        if hasattr(train_demo.CFG_100M, f.name)}), **NARROW)
    cfg = dataclasses.replace(train_demo.CFG_100M, **NARROW)
    want1, want2 = _j_train_demo(jcfg, steps, batch, every,
                                 str(tmp_path / "jax"))
    init = jax.tree.map(np.asarray, JMR.build_model(jcfg).init(
        jax.random.key(0))[0])
    monkeypatch.setattr(TL, "init_params", lambda cfg, *a, **k: (
        params_from_numpy(init, cfg, device="cpu", dtype=torch.float32)))
    got = train_demo.train_demo(cfg, steps=steps, batch=batch,
                                ckpt_every=every, device="cpu")
    assert got["phase2"]["resumed_from"] == want2["resumed_from"] == 2
    for g, w in ((got["phase1"], want1), (got["phase2"], want2)):
        assert len(g["losses"]) == len(w["losses"])
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-4)
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "OK — loss ")
