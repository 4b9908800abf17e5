"""Step-function builders: train, eval, prefill and serve.

Counterpart of src/repro/train/steps.py (`make_train_step`,
`make_eval_step`, `make_prefill_step`, `make_serve_step`), each returning
(fn, model) as the reference's.  Gradients come from autograd: the
parameters are the f32 masters (`params.init_params(dtype=torch.float32)`),
marked `requires_grad`, and the model casts each layer's weights to its
compute dtype as it reads them, as the reference's `_cast` does.  The
train step writes the new parameters and moments into the given trees
(`optimizer.adamw_update`); eval, prefill and serve run without autograd.
The steps run on the model's device (`device=`, the card unless the caller
names another).  No mesh yet: `mesh` is accepted only as None, and the
reference's spec trees (`batch_spec_tree`, `training_state_shardings`,
`_shardings_of`, `_drop_batch_axes`) wait for the sharding slice (ROADMAP
queue 1 item 8.5).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models.model import cross_entropy_loss
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         tree_leaves, tree_unflatten)

Tree = Dict[str, Any]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a mesh: the sharded steps wait for the sharding slice (ROADMAP "
            "queue 1 item 8.5)")


def make_train_step(cfg, mesh=None, opt_cfg: AdamWConfig = AdamWConfig(),
                    remat: bool = True, kv_chunk: int = 2048,
                    microbatches: int = 1, **model_kwargs):
    """Returns (train_step, model).  train_step(params, opt_state, batch)
    -> (params, opt_state, metrics): the loss is the cross-entropy plus
    0.01 x the MoE aux loss; with `microbatches` > 1 the batch is split
    along its first axis and the f32 gradients, loss and aux are averaged
    over the slices, as the reference's scan accumulates them."""
    _no_mesh(mesh)
    model = build_model(cfg, remat=remat, kv_chunk=kv_chunk, **model_kwargs)

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for w in leaves:
                w.requires_grad_(True)
            logits, aux = model.train_logits(params, batch)
            loss = cross_entropy_loss(logits, batch["labels"], cfg.vocab)
            total = loss + 0.01 * aux
            grads = torch.autograd.grad(total, leaves)
        return total.detach(), loss.detach(), aux.detach(), list(grads)

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
        params, opt_state = adamw_update(
            params, tree_unflatten(params, grads), opt_state, opt_cfg)
        metrics = {"loss": loss, "aux_loss": aux, "total_loss": total,
                   "step": opt_state.step}
        return params, opt_state, metrics

    return train_step, model


def make_eval_step(cfg, mesh=None, remat: bool = False, kv_chunk: int = 2048,
                   **model_kwargs):
    """Returns (eval_step, model): eval_step(params, batch) -> the mean
    cross-entropy."""
    _no_mesh(mesh)
    model = build_model(cfg, remat=remat, kv_chunk=kv_chunk, **model_kwargs)

    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = model.train_logits(params, batch)
        return cross_entropy_loss(logits, batch["labels"], cfg.vocab)

    return eval_step, model


def make_prefill_step(cfg, mesh=None, kv_chunk: int = 2048, **model_kwargs):
    """Returns (prefill_step, model): prefill_step(params, batch) ->
    (last logits, caches)."""
    _no_mesh(mesh)
    model = build_model(cfg, remat=False, kv_chunk=kv_chunk, **model_kwargs)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step, model


def make_serve_step(cfg, mesh=None, kv_chunk: int = 4096,
                    kv_int8: bool = False, **model_kwargs):
    """Decode step, greedy sampling and the length bump: the serving inner
    loop.  Returns (serve_step, model): serve_step(params, batch) with
    batch {"tokens" (B, 1), "lengths" (B,), "caches"} -> the next batch
    (the caches written in place)."""
    _no_mesh(mesh)
    model = build_model(cfg, remat=False, kv_chunk=kv_chunk, kv_int8=kv_int8,
                        **model_kwargs)

    @torch.no_grad()
    def serve_step(params, batch):
        logits, caches = model.decode_step(params, batch["caches"],
                                           batch["tokens"], batch["lengths"])
        return {"tokens": torch.argmax(logits, dim=-1).to(torch.int32)[:, None],
                "lengths": batch["lengths"] + 1, "caches": caches}

    return serve_step, model
