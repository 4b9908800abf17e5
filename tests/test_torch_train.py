"""Parity of the port's training substrate (`repro_torch.train`,
`repro_torch.data`, `cross_entropy_loss`, `launch/train.py`) with the JAX
package's, on the CPU: the loss, AdamW in its three state dtypes,
checkpoints read across packages, the synthetic data and the loader; and
the reference's own training tests (tests/test_train.py) run on the port.

Tolerances, measured on the CPU (torch 2.13.0+cpu, jax 0.9.0):
- `cross_entropy_loss` and its gradient, f32 and bf16 logits: within 1e-6
  relative (of the largest gradient entry; measured 8.0e-8 and 3.4e-7 in
  f32, 0 in bf16);
- `adamw_update`, 5 steps from the same numpy gradients (the clip active):
  every f32 leaf (parameters, fp32 moments) within 2 f32 ulps of the
  largest value of the reference's leaf, bf16 moments within 1 bf16 ulp of
  each value, int8 first moments within one quantum and their scales
  within 1e-6 relative.  The first step is bit-equal; after it the
  gradient's f32 sum of squares, reduced in another order, rounds one ulp
  apart at some steps, and the clip's scale with it (measured: parameters
  within 1 ulp).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLMDataset as JSynthetic
from repro.models.model import cross_entropy_loss as j_cross_entropy
from repro.train import checkpoint as jckpt
from repro.train import optimizer as JO
from repro_torch.configs.registry import reduced_config
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.models.model import cross_entropy_loss
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as TO
from repro_torch.train.fault import FailureInjector, StragglerWatchdog
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STATE_DTYPES = ["fp32", "bf16", "int8"]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32_ulps(got, want) -> float:
    """max |got - want| in f32 ulps of the largest |want| (the model
    tests' convention for bf16)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = float(np.spacing(np.float32(np.abs(want).max())))
    return float(np.max(np.abs(got.astype(np.float64) - want)) / ulp)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


# ---------------------------------------------------------------------------
# cross_entropy_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_entropy_with_padded_vocab_matches_jax(dtype):
    """Pad columns (at -1e30 in the logits' dtype) drop out; the loss equals
    the reference's, and the gradient through the port's is finite and
    zero on the pad columns."""
    rng = _rng(0)
    V, V_pad = 1000, 1024
    logits = (3 * rng.standard_normal((2, 8, V_pad))).astype(np.float32)
    logits[..., V:] = 50.0  # would dominate if not masked
    labels = rng.integers(0, V, (2, 8)).astype(np.int32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = float(j_cross_entropy(jnp.asarray(logits, jd), jnp.asarray(labels),
                                 V))
    tl = torch.tensor(logits).to(td).requires_grad_(True)
    got = cross_entropy_loss(tl, torch.tensor(labels), V)
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - want) <= 1e-6 * want
    (g,) = torch.autograd.grad(got, tl)
    assert g.dtype == td
    assert bool(torch.isfinite(g).all()) and not g[..., V:].any()
    jg = _np(jax.grad(lambda x: j_cross_entropy(x, jnp.asarray(labels), V))(
        jnp.asarray(logits, jd)))
    assert np.abs(_np(g) - jg).max() <= 1e-6 * np.abs(jg).max()


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------


def _opt_params(rng):
    """Leaves of every kind the optimizer treats apart: stacked and 2-D
    block-aligned (int8-eligible), a 1-D block-aligned vector (no decay),
    and leaves off the blocks (f32 in int8 mode)."""
    return {"stack": (0.5 * rng.standard_normal((2, 4, 512))).astype(
                np.float32),
            "w": (0.5 * rng.standard_normal((8, 256))).astype(np.float32),
            "norm": (0.1 * rng.standard_normal((256,))).astype(np.float32),
            "tiny": rng.standard_normal((3,)).astype(np.float32),
            "odd": rng.standard_normal((4, 5)).astype(np.float32)}


def _grads(rng, params, scale):
    return {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
            for k, v in params.items()}


def _flat_state(st, leaves):
    """(name, array) of every state leaf, the int8 pairs split."""
    out = []
    for moment in ("m", "v"):
        tree = getattr(st, moment)
        for k in sorted(tree):
            e = tree[k]
            if isinstance(e, tuple):
                out += [(f"{moment}/{k}/q", leaves(e[0])),
                        (f"{moment}/{k}/scale", leaves(e[1]))]
            else:
                out.append((f"{moment}/{k}", leaves(e)))
    return out


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_update_matches_jax(state_dtype):
    """Five updates from the same numpy gradients (large enough that the
    clip scales them): parameters and moments against the reference's."""
    rng = _rng(1)
    p_np = _opt_params(rng)
    cfg_j = JO.AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    cfg_t = AdamWConfig(lr=1e-2, state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.tensor(v) for k, v in p_np.items()}
    js, ts = JO.adamw_init(jp, cfg_j), adamw_init(tp, cfg_t)
    for _ in range(5):
        g = _grads(rng, p_np, 3.0)
        jp, js = JO.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                 js, cfg_j)
        tp, ts = adamw_update(tp, {k: torch.tensor(v) for k, v in g.items()},
                              ts, cfg_t)
    assert int(ts.step) == int(js.step) == 5
    for k in p_np:
        assert tp[k].dtype == torch.float32
        assert _f32_ulps(_np(tp[k]), jp[k]) <= 2, k
    got = dict(_flat_state(ts, _np))
    want = dict(_flat_state(js, _np))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype or (
            state_dtype != "fp32"), name
        if name.endswith("/q"):
            assert g.dtype == np.int8
            assert np.abs(g.astype(np.int32) - w).max() <= 1, name
        elif name.endswith("/scale"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        elif state_dtype == "bf16" or (state_dtype == "int8"
                                       and name.startswith("v/")):
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                          - 7)
            assert np.all(np.abs(g - w) <= ulp), name
        else:
            assert _f32_ulps(g, w) <= 2, name


def test_adamw_slices_leave_the_numbers_as_they_are(monkeypatch):
    """A leaf updated in slices of its first axis (`CHUNK`) is bit-equal to
    the same leaf updated whole, in every state dtype."""
    rng = _rng(2)
    p_np = {"w": rng.standard_normal((6, 512)).astype(np.float32)}
    g_np = {"w": rng.standard_normal((6, 512)).astype(np.float32)}
    for sd in STATE_DTYPES:
        runs = []
        for chunk in (TO.CHUNK, 1024):
            monkeypatch.setattr(TO, "CHUNK", chunk)
            cfg = AdamWConfig(state_dtype=sd)
            p = {"w": torch.tensor(p_np["w"])}
            st = adamw_init(p, cfg)
            for _ in range(3):
                p, st = adamw_update(p, {"w": torch.tensor(g_np["w"])}, st,
                                     cfg)
            runs.append((p["w"], _flat_state(st, _np)))
        assert torch.equal(runs[0][0], runs[1][0]), sd
        for (n, a), (_, b) in zip(runs[0][1], runs[1][1]):
            np.testing.assert_array_equal(a, b, err_msg=f"{sd} {n}")


# ---------------------------------------------------------------------------
# tests/test_train.py, run on the port
# ---------------------------------------------------------------------------


def _quadratic_params():
    return {"w": torch.tensor(np.linspace(-2, 2, 512),
                              dtype=torch.float32).reshape(2, 256)}


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_converges_quadratic(state_dtype):
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, state_dtype=state_dtype)
    params = _quadratic_params()
    state = adamw_init(params, cfg)

    def loss(p):
        return torch.sum(p["w"] ** 2)

    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), w)
        params, state = adamw_update(params, {"w": g}, state, cfg)
    assert float(loss(params)) < 1e-2, state_dtype


def test_int8_states_memory_shapes():
    cfg = AdamWConfig(state_dtype="int8")
    params = {"big": torch.zeros((8, 512)), "tiny": torch.zeros((3,))}
    st = adamw_init(params, cfg)
    q, scale = st.m["big"]
    assert q.dtype == torch.int8 and q.shape == (8, 512)
    assert scale.shape == (8, 2)
    assert st.m["tiny"].dtype == torch.float32  # non-block-aligned fallback
    # v stays bf16 in int8 mode (dynamic range; see the optimizer's doc)
    assert st.v["big"].dtype == torch.bfloat16


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(10, dtype=torch.float32),
        "n": {"b": torch.ones((3, 4), dtype=torch.bfloat16),
              "c": torch.tensor(7, dtype=torch.int32)},
    }
    ckpt.save(tmp_path, 5, tree)
    assert ckpt.latest_step(tmp_path) == 5
    out = ckpt.restore(tmp_path, tree)
    for a, b in ((tree["a"], out["a"]), (tree["n"]["b"], out["n"]["b"]),
                 (tree["n"]["c"], out["n"]["c"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # newer step wins LATEST
    ckpt.save(tmp_path, 9, tree)
    assert ckpt.latest_step(tmp_path) == 9


def test_train_loss_decreases():
    cfg = reduced_config("llama3.2-3b")
    res = run(cfg, LoopConfig(steps=30, batch_size=4, ckpt_dir=None, seed=0),
              device="cpu")
    first, last = np.mean(res["losses"][:5]), np.mean(res["losses"][-5:])
    assert last < first - 0.1, (first, last)


def _bits(tree):
    return [t.clone() for t in TO.tree_leaves(
        {"params": tree["params"], "m": tree["opt_state"].m,
         "v": tree["opt_state"].v}) for t in
            (t if isinstance(t, tuple) else (t,))]


def test_failure_injection_and_restart(tmp_path):
    """Kill at step 12, restart from the step-10 checkpoint, finish; the
    resumed run ends bit-equal to an uninterrupted one (on the CPU), with
    the same losses from step 10 on."""
    cfg = reduced_config("gemma-2b")
    loop = LoopConfig(steps=20, batch_size=2, ckpt_every=5,
                      ckpt_dir=str(tmp_path))
    injector = FailureInjector(fail_at=(12,))
    with pytest.raises(RuntimeError, match="injected failure"):
        run(cfg, loop, injector=injector, device="cpu")
    assert ckpt.latest_step(tmp_path) == 10

    res = run(cfg, loop, device="cpu")  # restart: resumes from 10
    assert res["resumed_from"] == 10
    assert res["steps_done"] == 20
    whole = run(cfg, LoopConfig(steps=20, batch_size=2, ckpt_dir=None),
                device="cpu")
    assert res["losses"] == whole["losses"][10:]
    for a, b in zip(_bits(res), _bits(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(res["opt_state"].step) == 20


def test_straggler_watchdog():
    w = StragglerWatchdog(threshold=2.0, warmup_steps=1)
    for s in range(5):
        assert w.observe(s, 1.0) is None
    ev = w.observe(5, 5.0)
    assert ev is not None and ev["dt"] == 5.0
    # the straggler didn't poison the EWMA
    assert w.observe(6, 1.1) is None


def test_elastic_restore_dtype_and_structure(tmp_path):
    """Restore onto a differently-typed target (the elastic path's cast),
    and onto a mesh placement: each rank's block, in the target's dtype."""
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8)}
    ckpt.save(tmp_path, 1, tree)
    like = {"w": torch.zeros((4, 8), dtype=torch.bfloat16)}
    out = ckpt.restore(tmp_path, like)
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(out["w"].float().numpy(), tree["w"].numpy())
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import P, named

    with make_mesh((1, 1), ("data", "model"), device="cpu") as mesh:
        placed = ckpt.restore(tmp_path, like, shardings={
            "w": named(mesh, P("data", "model"))})
    assert placed["w"].dtype == torch.bfloat16
    np.testing.assert_allclose(placed["w"].float().numpy(),
                               tree["w"].numpy())


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _train_state(state_dtype, rng):
    p_np = _opt_params(rng)
    g_np = _grads(rng, p_np, 0.5)
    p_np["half"] = rng.standard_normal((2, 256)).astype(np.float32)
    g_np["half"] = rng.standard_normal((2, 256)).astype(np.float32)
    cfg_j = JO.AdamWConfig(state_dtype=state_dtype)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    jp["half"] = jp["half"].astype(jnp.bfloat16)
    js = JO.adamw_init(jp, cfg_j)
    jp, js = JO.adamw_update(jp, {k: jnp.asarray(v) for k, v in g_np.items()},
                             js, cfg_j)
    cfg_t = AdamWConfig(state_dtype=state_dtype)
    tp = {k: torch.tensor(v) for k, v in p_np.items()}
    tp["half"] = tp["half"].to(torch.bfloat16)
    ts = adamw_init(tp, cfg_t)
    tp, ts = adamw_update(tp, {k: torch.tensor(v) for k, v in g_np.items()},
                          ts, cfg_t)
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def _state_arrays(state):
    """Every leaf of a training state as numpy, by name."""
    out = {f"params/{k}": _np(v) for k, v in state["params"].items()}
    out.update(dict(_flat_state(state["opt"], _np)))
    out["step"] = _np(state["opt"].step)
    return out


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_checkpoints_read_across_packages(tmp_path, state_dtype):
    """A training state (parameters, one bf16; `OptState`, the int8 first
    moments as (q, scale) tuples) saved by either package restores in the
    other into the same leaves, dtypes and values; the manifests name the
    same key paths and dtype tags."""
    jstate, tstate = _train_state(state_dtype, _rng(3))
    jckpt.save(tmp_path / "jax", 1, jstate)
    ckpt.save(tmp_path / "torch", 1, tstate)
    mj, mt = (json.loads((tmp_path / d / "step_1" / "manifest.json")
                         .read_text()) for d in ("jax", "torch"))
    assert mj["dtypes"] == mt["dtypes"]
    if state_dtype == "int8":
        assert "['opt']/.m/['w']/[0]" in mt["leaves"]
    got_t = ckpt.restore(tmp_path / "jax", tstate)
    got_j = jckpt.restore(tmp_path / "torch", jstate)
    assert isinstance(got_t["opt"], TO.OptState)
    for got, want in ((_state_arrays(got_t), _state_arrays(jstate)),
                      (_state_arrays(got_j), _state_arrays(tstate))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got_t["params"]["half"].dtype == torch.bfloat16
    assert got_j["params"]["half"].dtype == jnp.bfloat16


# ---------------------------------------------------------------------------
# data and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed_map", [False, True])
def test_synthetic_batches_equal_jax(fixed_map):
    for vocab, seq, seed in ((1000, 16, 0), (128256, 64, 3)):
        t = SyntheticLMDataset(vocab, seq, seed=seed, fixed_map=fixed_map)
        j = JSynthetic(vocab, seq, seed=seed, fixed_map=fixed_map)
        for step in (0, 7):
            a, b = t.batch(step, 4), j.batch(step, 4)
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_sharded_loader_order_device_and_close():
    """Batches come in step order from `start_step`, as tensors on the
    named device (numpy with none); `close` stops the thread."""
    data = SyntheticLMDataset(500, 8, seed=1)
    loader = ShardedLoader(lambda s: data.batch(s, 2), device="cpu", depth=2,
                           start_step=3)
    for want in (3, 4, 5, 6):
        step, batch = next(loader)
        assert step == want
        assert isinstance(batch["tokens"], torch.Tensor)
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      data.batch(want, 2)["tokens"])
    loader.close()
    loader._thread.join(timeout=5)
    assert not loader._thread.is_alive()
    plain = ShardedLoader(lambda s: data.batch(s, 2))
    step, batch = next(plain)
    assert step == 0 and isinstance(batch["labels"], np.ndarray)
    plain.close()


def _launch(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_launcher_trains_on_the_cpu_and_refuses_dry_devices(tmp_path):
    out = _launch("--arch", "llama3.2-3b", "--reduced", "--steps", "3",
                  "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[train] llama3.2-3b-reduced: steps=3 loss "), line
    assert line.endswith("resumed_from=None events=0"), line
    assert ckpt.latest_step(tmp_path) == 2  # every 2 steps
    out = _launch("--arch", "llama3.2-3b", "--reduced", "--steps", "4",
                  "--batch", "2", "--seq", "16", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert "steps=4 " in line and line.endswith("resumed_from=2 events=0")
    out = _launch("--arch", "llama3.2-3b", "--reduced", "--dry-devices", "8")
    assert out.returncode != 0 and "no counterpart" in out.stderr
