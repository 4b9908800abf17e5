"""Gradients of the port's training loss against `jax.value_and_grad` of the
reference's, for one reduced config of each of the six families, on the
CPU in f32: the loss is the cross-entropy plus 0.01 x the MoE aux loss
(`repro.train.steps.make_train_step`'s), the same numpy weights (norms,
biases and gates redrawn nonzero, as tests/test_torch_models.py's) and the
same numpy batch.  The port's gradients come from autograd over the f32
leaves; remat (on in training) must not move them, and the train step with
two microbatches must match the reference's.

Tolerances, measured on the CPU (torch 2.13.0+cpu, jax 0.9.0; the largest
over the six families in brackets):
- the loss within 1e-6 relative [6.7e-8, granite-moe's];
- every gradient leaf within 1e-5 x that leaf's largest |g| [4.8e-6,
  jamba's `ssm/A_log`, whose sum cancels to 1.2e-4 of the tree's largest
  gradient; it was 1.4e-5 while the port's SSD clipped with
  `torch.clamp`, which passes all of the gradient at a bound where
  `jnp.clip` passes half], but for the cross-attention's key bias
  (whisper's `dec_cross/bk`): unroped keys make every query's scores blind
  to it, so its exact gradient is zero and both packages' are rounding
  noise, held below 1e-8 x the tree's largest |g| [2.0e-11 against 8.6e-10];
- remat on against off: bit-equal;
- one train step (fp32 states) with 2 microbatches against the
  reference's: the metrics within 1e-6 relative, each moment leaf within
  1e-5 x its largest value (the gradient's bound); against 1 microbatch,
  the loss within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_config as j_reduced_config
from repro.models.model import cross_entropy_loss as j_cross_entropy
from repro.models.registry import build_model as j_build_model
from repro.train import optimizer as JO
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import params as TP
from repro_torch.models.model import cross_entropy_loss
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.train.steps import make_train_step

torch.set_num_threads(1)

FAMILY_ARCHS = ["llama3.2-3b", "granite-moe-1b-a400m", "mamba2-780m",
                "jamba-1.5-large-398b", "whisper-base",
                "llama-3.2-vision-11b"]
B = 2


def _tree_and_batch(arch, seed=1):
    """The reference's reduced init tree (numpy) with norms, biases and the
    VLM's gates redrawn nonzero, and a batch: tokens, labels and the
    family's context.  The SSD families take two of their chunks."""
    jcfg = j_reduced_config(arch)
    jm = j_build_model(jcfg, remat=False)
    params, _ = jm.init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    for path, a in list(TP.leaves(tree)):
        name = path.split("/")[-1]
        if name.startswith(("b", "norm", "final_norm")) or name in (
                "conv_b", "dt_bias", "gate"):
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node[p]
            node[leaf] = ((1.0 if name == "gate" else 0.1)
                          * rng.standard_normal(a.shape)).astype(np.float32)
    S = 2 * jcfg.ssm.chunk if jcfg.ssm else 16
    tok = rng.integers(0, jcfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if jcfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, 24, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)
    return tree, batch


def _jax_value_and_grad(arch, tree, batch):
    jcfg = j_reduced_config(arch)
    jm = j_build_model(jcfg, remat=False, compute_dtype=jnp.float32)

    def loss_fn(params, batch):
        logits, aux = jm.train_logits(params, batch)
        loss = j_cross_entropy(logits, batch["labels"], jcfg.vocab)
        return loss + 0.01 * aux, (loss, aux)

    (total, (loss, aux)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    return float(total), float(aux), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(arch, tree, batch, remat):
    cfg = reduced_config(arch)
    model = build_model(cfg, compute_dtype=torch.float32, remat=remat,
                        device="cpu")
    params = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    flat = [w for _, w in TP.leaves(params)]
    for w in flat:
        w.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, aux = model.train_logits(params, tb)
    total = cross_entropy_loss(logits, tb["labels"], cfg.vocab) + 0.01 * aux
    grads = torch.autograd.grad(total, flat)
    return (float(total.detach()), float(aux.detach()),
            {p: g for (p, _), g in zip(TP.leaves(params), grads)})


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch):
    tree, batch = _tree_and_batch(arch)
    jt, jaux, jg = _jax_value_and_grad(arch, tree, batch)
    tt, taux, tg = _port_value_and_grad(arch, tree, batch, remat=False)
    assert np.isfinite(jt) and abs(tt - jt) <= 1e-6 * abs(jt)
    if reduced_config(arch).moe:
        assert jaux > 0
    want = dict(TP.leaves(jg))
    assert sorted(tg) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        g = tg[path].numpy()
        assert g.shape == w.shape, path
        assert np.isfinite(w).all(), path
        if path.endswith("cross/bk"):  # zero exactly (module doc)
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-8 * top
            continue
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= 1e-5 * scale, path
    # remat recomputes each layer body; the numbers stay the same
    rt, raux, rg = _port_value_and_grad(arch, tree, batch, remat=True)
    assert (rt, raux) == (tt, taux)
    for path in tg:
        assert torch.equal(rg[path], tg[path]), path


@pytest.mark.parametrize("arch", ["llama3.2-3b", "granite-moe-1b-a400m"])
def test_microbatched_train_step_matches_jax(arch):
    """One train step with 2 microbatches (f32 gradients averaged over the
    halves) against the reference's scan, and the dense model's loss
    against 1 microbatch."""
    tree, batch = _tree_and_batch(arch, seed=2)
    batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    jcfg, cfg = j_reduced_config(arch), reduced_config(arch)
    j_opt, t_opt = JO.AdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstep, _ = j_make_train_step(jcfg, None, j_opt, remat=False,
                                 microbatches=2, compute_dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    jp, js, jm = jax.jit(jstep)(jp, JO.adamw_init(jp, j_opt),
                                jax.tree.map(jnp.asarray, batch))
    runs = {}
    for mb in (2, 1):
        step, _ = make_train_step(cfg, None, t_opt, microbatches=mb,
                                  compute_dtype=torch.float32, device="cpu")
        tp = params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
        runs[mb] = step(tp, adamw_init(tp, t_opt),
                        {k: torch.as_tensor(v) for k, v in batch.items()})
    tp, st, tm = runs[2]
    assert int(st.step) == int(jm["step"]) == 1
    for k in ("loss", "aux_loss", "total_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    # the moments hold the clipped, averaged gradient (m) and its square
    # (v); the parameters' first step, about lr x sign(g), turns on
    # gradients near eps and is held by test_torch_train's AdamW tests
    for moment in ("m", "v"):
        got = dict(TP.leaves(getattr(st, moment)))
        for path, w in TP.leaves(jax.tree.map(np.asarray,
                                              getattr(js, moment))):
            err = float(np.abs(got[path].numpy() - w).max())
            assert err <= 1e-5 * float(np.abs(w).max()), (moment, path)
    if not cfg.moe:  # the aux loss of a half is not half the batch's
        one = float(runs[1][2]["loss"])
        assert abs(float(tm["loss"]) - one) <= 1e-6 * one
    assert len(tree_leaves(tp)) == len(tree_leaves(st.m))
