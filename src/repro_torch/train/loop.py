"""Training loop with checkpoint/restart, straggler watchdog, preemption
handling and failure injection: the fault-tolerance story end to end.

Counterpart of src/repro/train/loop.py (`LoopConfig`, `run`).  Restart
contract: `run()` called with the same `ckpt_dir` resumes from LATEST
(parameters, optimizer state and the data step), so a killed job loses at
most `ckpt_every` steps.  The parameters are f32 masters drawn from a
`torch.Generator` seeded with `loop.seed` on `device` (the card unless the
caller names another; the reference draws from `jax.random.key(seed)`, a
stream PyTorch cannot reproduce); each step's batch is
`SyntheticLMDataset.batch(step, batch_size)` moved to the device.  The
train step updates the parameters and moments in place; a checkpoint
copies them to the host before the next step.

With a `mesh` every rank runs the loop: it draws the same parameters and
keeps its blocks (ZeRO-3 + tensor parallel, `models.model`), takes its
rows of each global batch (`data.loader.place`), saves through
`checkpoint.save(shardings=)` (gathered whole; the mesh's rank 0 writes)
and resumes through `checkpoint.restore(shardings=)` (every rank).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.data.loader import place, to_device
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.models.params import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import shardings_for
from repro_torch.train.fault import (FailureInjector, PreemptionGuard,
                                     StragglerWatchdog)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.steps import (batch_spec_tree, make_train_step,
                                     training_state_shardings)


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    batch_size: int = 8
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    async_ckpt: bool = False
    log_every: int = 10
    seed: int = 0
    straggler_threshold: float = 3.0


def run(
    cfg,  # ModelConfig
    loop: LoopConfig,
    mesh=None,
    opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
    injector: Optional[FailureInjector] = None,
    data: Optional[SyntheticLMDataset] = None,
    install_signals: bool = False,
    device=None,
) -> Dict[str, Any]:
    """Train; returns the summary (losses, steps_done, resumed_from,
    events, params, opt_state, and the loop's own seconds: `step_s` each
    step's, its loss read back included, `ckpt_s` each checkpoint save's
    until it returns, `restore_s` the restore's or None)."""
    train_step, model = make_train_step(cfg, mesh, opt_cfg, remat=True,
                                        device=device)
    dev = model.device

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        loop.seed), dtype=torch.float32, device=dev,
        model_axis=model.model_axis_size, mesh=mesh, specs=model.specs)
    opt_state = adamw_init(params, opt_cfg, mesh, model.specs)
    state_sh = batch_sh = None
    if mesh is not None:
        p_sh, o_sh = training_state_shardings(cfg, mesh, opt_cfg, params,
                                              model.specs)
        state_sh = {"params": p_sh, "opt": o_sh}
    start_step = 0
    resumed_from = restore_s = None

    if loop.ckpt_dir and ckpt.latest_step(loop.ckpt_dir) is not None:
        t0 = time.time()
        state = ckpt.restore(loop.ckpt_dir,
                             {"params": params, "opt": opt_state},
                             shardings=state_sh)
        params, opt_state = state["params"], state["opt"]
        start_step = int(opt_state.step)
        restore_s = time.time() - t0
        resumed_from = start_step

    data = data or SyntheticLMDataset(vocab=cfg.vocab, seq_len=128,
                                      seed=loop.seed)
    if mesh is not None:
        batch_sh = shardings_for(mesh, batch_spec_tree(
            cfg, ShapeConfig("loop", data.seq_len, loop.batch_size, "train"),
            model.rules, mesh))
    watchdog = StragglerWatchdog(threshold=loop.straggler_threshold)
    guard = PreemptionGuard(install=install_signals)
    losses: List[float] = []
    step_s: List[float] = []
    ckpt_s: List[float] = []
    events: List[dict] = []
    pending_ckpt = None

    step = start_step
    try:
        while step < loop.steps:
            if injector:
                injector.maybe_fail(step)
            batch = data.batch(step, loop.batch_size)
            batch = (to_device(batch, dev) if batch_sh is None
                     else place(batch, batch_sh))
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            step_s.append(dt)
            ev = watchdog.observe(step, dt)
            if ev:
                events.append({"kind": "straggler", **ev})
            losses.append(loss)
            step += 1

            want_ckpt = loop.ckpt_dir and (
                step % loop.ckpt_every == 0 or guard.requested
            )
            if want_ckpt:
                t0 = time.time()
                if pending_ckpt is not None:
                    pending_ckpt.join()
                pending_ckpt = ckpt.save(
                    loop.ckpt_dir,
                    step,
                    {"params": params, "opt": opt_state},
                    async_write=loop.async_ckpt,
                    shardings=state_sh,
                )
                ckpt_s.append(time.time() - t0)
            if guard.requested:
                events.append({"kind": "preempted", "step": step})
                break
    finally:
        if pending_ckpt is not None:
            pending_ckpt.join()
        if install_signals:
            guard.restore()

    return {
        "losses": losses,
        "steps_done": step,
        "resumed_from": resumed_from,
        "events": events,
        "params": params,
        "opt_state": opt_state,
        "step_s": step_s,
        "ckpt_s": ckpt_s,
        "restore_s": restore_s,
    }
