"""Step-function builders: train, eval, prefill and serve.

Counterpart of src/repro/train/steps.py (`make_train_step`,
`make_eval_step`, `make_prefill_step`, `make_serve_step`, each returning
(fn, model) as the reference's, and the spec trees `batch_spec_tree`,
`_batch_spec_tree`, `_drop_batch_axes`, `_shardings_of` and
`training_state_shardings`).  Gradients come from autograd: the
parameters are the f32 masters (`params.init_params(dtype=torch.float32)`),
marked `requires_grad`, and the model casts each layer's weights to its
compute dtype as it reads them, as the reference's `_cast` does.  The
train step writes the new parameters and moments into the given trees
(`optimizer.adamw_update`); eval, prefill and serve run without autograd.
The steps run on the model's device (`device=`, the card unless the caller
names another).

With a `mesh` every rank calls the step with its blocks: the parameters
and moments under the spec trees (`training_state_shardings`), the batch
rows of its batch-axes coordinate (`batch_spec_tree`).  The loss is the
global batch's (`Model.loss`, the same on every rank).  A data-sharded
leaf's gradient comes summed over the batch axes from the ZeRO gather's
psum_scatter; the gradient of a leaf replicated over a batch axis is
psum'd over it here (`sum_replicated_grads`).  AdamW's gradient norm is
the global one (`optimizer.adamw_update(mesh=, specs=)`).  The serve step
takes its greedy token from a gathered argmax (`Model.greedy`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.mesh import AXIS_DATA, AXIS_MODEL, AXIS_POD
from repro_torch.distributed.sharding import (NamedSharding, P, ShardingRules,
                                              _keep, spec_axes, spec_map)
from repro_torch.models.model import cross_entropy_loss
from repro_torch.models.params import spec_at
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         grad_norm, opt_state_specs,
                                         tree_leaves, tree_paths,
                                         tree_unflatten)

Tree = Dict[str, Any]


def _shardings_of(mesh, spec_tree):
    return spec_map(lambda s: NamedSharding(mesh, s), spec_tree)


def _drop_batch_axes(spec_tree):
    """Replace the ('pod', 'data') batch group with None in every spec (a
    global batch that does not divide the batch devices)."""
    batch = {AXIS_POD, AXIS_DATA}
    return spec_map(lambda s: P(*(_keep(e, lambda a: a not in batch)
                                  for e in s)), spec_tree)


def batch_spec_tree(cfg: ModelConfig, shape: ShapeConfig,
                    rules: ShardingRules, mesh=None, kv_int8: bool = False):
    """The spec tree of a step's batch (the reference's `input_specs`
    structure).  With a `mesh`, the batch axes are dropped when the global
    batch does not divide them, as the reference's."""
    tree = _batch_spec_tree(cfg, shape, rules, kv_int8)
    if mesh is not None:
        n_batch = 1
        for a in (AXIS_POD, AXIS_DATA):
            n_batch *= mesh.shape.get(a, 1)
        if shape.global_batch % n_batch != 0:
            tree = _drop_batch_axes(tree)
    return tree


def _batch_spec_tree(cfg: ModelConfig, shape: ShapeConfig,
                     rules: ShardingRules, kv_int8: bool = False):
    b = rules.tokens
    out: Tree = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = b
        if shape.kind == "train":
            out["labels"] = b
        if cfg.family == "encdec":
            out["enc_embeds"] = rules.act_btd
        if cfg.family == "vlm":
            out["image_embeds"] = rules.act_btd
        return out
    fam = cfg.family
    # the decode batch group: the reference writes ('pod', 'data'), which
    # the rules' cache spec holds; rules fitted to a pod-less mesh
    # (`strip_pod`) hold 'data'
    bg = rules.kv_cache[1]
    caches: Tree = {}
    if fam in ("dense", "moe", "encdec"):
        caches["k"] = rules.kv_cache
        caches["v"] = rules.kv_cache
        if kv_int8 and fam in ("dense", "moe"):
            scale_spec = P(*tuple(rules.kv_cache)[:-1])
            caches["k_scale"] = scale_spec
            caches["v_scale"] = scale_spec
        if fam == "encdec":
            caches["xk"] = rules.kv_cache
            caches["xv"] = rules.kv_cache
    elif fam == "ssm":
        caches["ssm_h"] = rules.ssm_state
        caches["ssm_conv"] = P(None, bg, None, AXIS_MODEL)
    elif fam == "hybrid":
        caches["k"] = rules.kv_cache
        caches["v"] = rules.kv_cache
        caches["ssm_h"] = P(None, None, bg, AXIS_MODEL, None, None)
        caches["ssm_conv"] = P(None, None, bg, None, AXIS_MODEL)
    elif fam == "vlm":
        caches["k"] = P(None, None, bg, AXIS_MODEL, None, None)
        caches["v"] = P(None, None, bg, AXIS_MODEL, None, None)
        caches["xk"] = P(None, bg, None, None, None)
        caches["xv"] = P(None, bg, None, None, None)
    return {"tokens": P(bg, None), "lengths": P(bg), "caches": caches}


def training_state_shardings(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig,
                             params, param_specs):
    """(parameter placements, optimizer-state placements) of a training
    state on `mesh` (`params`: this rank's blocks)."""
    o_specs = opt_state_specs(params, param_specs, opt_cfg, mesh)
    return _shardings_of(mesh, param_specs), _shardings_of(mesh, o_specs)


def sum_replicated_grads(model, params, grads):
    """`grads` (in `tree_leaves(params)` order) with each leaf's gradient
    psum'd over the batch axes its spec does not shard it over: those
    ranks saw different rows."""
    if model.mesh is None or not model._bx:
        return grads
    out = []
    for path, g in zip(tree_paths(params), grads):
        have = set(spec_axes(spec_at(model.specs, path)))
        miss = tuple(a for a in model._bx if a not in have)
        out.append(model.mesh.psum(g, miss) if miss else g)
    return out


def make_train_step(cfg, mesh=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    rules: Optional[ShardingRules] = None, remat: bool = True,
                    kv_chunk: int = 2048, microbatches: int = 1,
                    **model_kwargs):
    """Returns (train_step, model).  train_step(params, opt_state, batch)
    -> (params, opt_state, metrics): the loss is the cross-entropy plus
    0.01 x the MoE aux loss; with `microbatches` > 1 the batch is split
    along its first axis and the f32 gradients, loss and aux are averaged
    over the slices, as the reference's scan accumulates them."""
    model = build_model(cfg, mesh, remat=remat, kv_chunk=kv_chunk,
                        rules=rules, **model_kwargs)

    def grads_of(params, batch):
        leaves_ = tree_leaves(params)
        with torch.enable_grad():
            for w in leaves_:
                w.requires_grad_(True)
            logits, aux = model.train_logits(params, batch)
            loss = (cross_entropy_loss(logits, batch["labels"], cfg.vocab)
                    if model.mesh is None
                    else model.loss(logits, batch["labels"]))
            total = loss + 0.01 * aux
            grads = torch.autograd.grad(total, leaves_)
        grads = sum_replicated_grads(model, params, list(grads))
        return total.detach(), loss.detach(), aux.detach(), grads

    def train_step(params, opt_state: OptState, batch: Tree):
        if microbatches == 1:
            total, loss, aux, grads = grads_of(params, batch)
        else:
            micro = {k: x.reshape((microbatches, x.shape[0] // microbatches)
                                  + tuple(x.shape[1:]))
                     for k, x in batch.items()}
            grads = [torch.zeros(w.shape, dtype=torch.float32,
                                 device=w.device)
                     for w in tree_leaves(params)]
            loss = aux = torch.zeros((), device=model.device)
            for j in range(microbatches):
                _, l, a, g = grads_of(params, {k: x[j]
                                               for k, x in micro.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss, aux = loss + l, aux + a
            grads = [g / microbatches for g in grads]
            loss, aux = loss / microbatches, aux / microbatches
            total = loss + 0.01 * aux
        grads = tree_unflatten(params, grads)
        gnorm = grad_norm(grads, model.mesh, model.specs)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg,
                                         mesh=model.mesh, specs=model.specs,
                                         gnorm=gnorm)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total,
                   "step": opt_state.step, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step, model


def make_eval_step(cfg, mesh=None, remat: bool = False, kv_chunk: int = 2048,
                   **model_kwargs):
    """Returns (eval_step, model): eval_step(params, batch) -> the mean
    cross-entropy."""
    model = build_model(cfg, mesh, remat=remat, kv_chunk=kv_chunk,
                        **model_kwargs)

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = model.train_logits(params, batch)
        return model.loss(logits, batch["labels"])

    return eval_step, model


def make_prefill_step(cfg, mesh=None, kv_chunk: int = 2048, rules=None,
                      **model_kwargs):
    """Returns (prefill_step, model): prefill_step(params, batch) ->
    (last logits, caches)."""
    model = build_model(cfg, mesh, remat=False, kv_chunk=kv_chunk,
                        rules=rules, **model_kwargs)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step, model


def make_serve_step(cfg, mesh=None, kv_chunk: int = 4096, rules=None,
                    kv_int8: bool = False, **model_kwargs):
    """Decode step, greedy sampling and the length bump: the serving inner
    loop.  Returns (serve_step, model): serve_step(params, batch) with
    batch {"tokens" (B, 1), "lengths" (B,), "caches"} -> the next batch
    (the caches written in place)."""
    model = build_model(cfg, mesh, remat=False, kv_chunk=kv_chunk,
                        rules=rules, kv_int8=kv_int8, **model_kwargs)

    @torch.no_grad()
    def serve_step(params, batch):
        logits, caches = model.decode_step(params, batch["caches"],
                                           batch["tokens"], batch["lengths"])
        return {"tokens": model.greedy(logits)[:, None],
                "lengths": batch["lengths"] + 1, "caches": caches}

    return serve_step, model
