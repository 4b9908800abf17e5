"""Rank functions of the port's distributed parity tests.

`repro_torch.distributed.spawn` runs each of these in one process a rank
(gloo, on the CPU); the test modules compute the JAX package's results in
their own process and compare.  This module imports torch and the port
only, so no rank process loads jax.
"""

import numpy as np
import torch

from repro_torch.convert import state_from_numpy
from repro_torch.core import nuddle as N
from repro_torch.core.pqueue import dist as D
from repro_torch.distributed import collectives as DC
from repro_torch.distributed.mesh import make_mesh

torch.set_num_threads(1)

EXACT = ("flat", "hier", "ffwd")


def port_cases(n_dev, S_loc=2, seed=0):
    """`dist_pq`'s cases built with the port alone (no reference at hand):
    a 64-slot queue of 8 * S_loc shards, draws from a seeded generator."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.pqueue import ops as O
    from repro_torch.core.pqueue.schedules import spray_draws
    from repro_torch.core.pqueue.state import make_state

    rng = np.random.default_rng(seed)
    cases = []
    for H, cf, B in ((None, 8.0, 8), (16, 1.0, 8)):
        st, _ = O.insert(make_state(n_dev * S_loc, 64, head_width=H,
                                    device="cpu"),
                         torch.as_tensor(rng.integers(0, 60, 300, np.int32)),
                         torch.as_tensor(rng.integers(0, 99, 300, np.int32)))
        gen = torch.Generator().manual_seed(seed)
        sc, hi = spray_draws(S_loc, 4, st.head_width, steps=n_dev,
                             generator=gen)
        cb = torch.randint(0, S_loc, (n_dev, 4), generator=gen,
                           dtype=torch.int32)
        cases.append(dict(
            S_loc=S_loc, state=state_to_numpy(st),
            ins_k=rng.integers(0, 60, (n_dev, B), np.int32),
            ins_v=rng.integers(0, 99, (n_dev, B), np.int32),
            ins_mask=rng.random((n_dev, B)) < 0.8,
            draws={"sc": sc.numpy(), "hi": hi.numpy(), "cb": cb.numpy()},
            capacity_factor=cf, m=8, active=6, m_loc=4, active_loc=3,
            nuddle_n=5))
    return cases


def _t(a, mesh):
    return torch.as_tensor(np.array(a), device=mesh.device)


def _delete(fn, state, m, active, draws, cfg):
    """One delete from `state`: its outputs and the collectives it issued."""
    cfg.mesh.reset_counts()
    st, k, v, n = fn(state, m, active, draws, cfg)
    return {"state": st, "keys": k, "vals": v, "n": n,
            "counts": dict(cfg.mesh.counts)}


def dist_pq(mesh, cases):
    """For each case on this rank's slice of the global state: insert_dist
    then delete_flat_dist over a one-axis ("dev",) mesh; insert_dist over
    the (pod, shard) mesh, then from that state each exact schedule, spray
    and MULTIQ with this rank's draws, and Nuddle's delegate_dist."""
    one_axis = make_mesh((mesh.size,), ("dev",), device=mesh.device,
                         backend=mesh.backend)
    r = mesh.rank
    out = []
    for c in cases:
        S_loc = c["S_loc"]
        rows = slice(r * S_loc, (r + 1) * S_loc)
        st = state_from_numpy({f: a[rows] for f, a in c["state"].items()},
                              device=mesh.device)
        ins = [_t(c[k][r], mesh) for k in ("ins_k", "ins_v", "ins_mask")]
        res = {}
        cfg1 = D.AxisCfg(("dev",), None, mesh=one_axis)
        st1, dropped, rejected = D.insert_dist(st, *ins, cfg1,
                                               c["capacity_factor"])
        res["insert_1axis"] = {"state": st1, "dropped": dropped,
                               "rejected": rejected}
        res["flat_1axis"] = _delete(D.delete_flat_dist, st1, c["m"],
                                    c["active"], None, cfg1)

        cfg = D.AxisCfg(("shard",), "pod", mesh=mesh)
        mesh.reset_counts()
        st2, dropped, rejected = D.insert_dist(st, *ins, cfg,
                                               c["capacity_factor"])
        res["insert"] = {"state": st2, "dropped": dropped,
                         "rejected": rejected, "counts": dict(mesh.counts)}
        for name, fn in zip(EXACT, (D.delete_flat_dist, D.delete_hier_dist,
                                    D.delete_ffwd_dist)):
            res[name] = _delete(fn, st2, c["m"], c["active"], None, cfg)
        sc, hi, cb = (_t(c["draws"][k][r], mesh) for k in ("sc", "hi", "cb"))
        res["spray"] = _delete(D.delete_spray_dist, st2, c["m_loc"],
                               c["active_loc"], (sc, hi), cfg)
        res["multiq"] = _delete(D.delete_multiq_dist, st2,
                                c["m_loc"], c["active_loc"], (sc, cb), cfg)

        # Nuddle: this device's rows merged into one sorted local run.
        keys = st.keys.reshape(-1)
        order = torch.sort(keys, stable=True).indices
        local = {"keys": keys[order], "vals": st.vals.reshape(-1)[order]}
        _, verdict = N.delegate_dist(N.pq_tournament_ops(), local, c["m"],
                                     ("shard",), "pod",
                                     ctx={"n": c["nuddle_n"]}, mesh=mesh)
        res["nuddle"] = verdict
        out.append(res)
    one_axis.close()
    return out


def collectives(mesh, x, steps):
    """The collectives of `collectives_check.py` on this rank's row of `x`
    (8, D), and the mesh's collectives' result layouts, over a (pod, data)
    mesh on its device."""
    r = mesh.rank
    xr = torch.as_tensor(x[r], device=mesh.device)
    res = {
        "flat": mesh.psum(xr, ("pod", "data")),
        "hier": DC.hierarchical_psum(xr, ("data",), "pod", mesh=mesh),
        "psum_data": mesh.psum(xr, "data"),
        "rsag": DC.reduce_scatter_then_allgather(xr, "data", mesh=mesh),
        "pmax": mesh.pmax(xr, ("pod", "data")),
    }
    err, comp = torch.zeros_like(xr), []
    for _ in range(steps):
        out, err = DC.compressed_cross_pod_psum(xr, ("data",), "pod", err,
                                                mesh=mesh)
        comp.append(out)
    res["compressed"] = torch.stack(comp)
    res["compressed_1pod"] = DC.compressed_cross_pod_psum(
        xr, ("pod", "data"), None, mesh=mesh)
    me = torch.tensor([r], dtype=torch.int32, device=mesh.device)
    for axes in (("pod", "data"), ("data", "pod"), ("data",), ("pod",)):
        n = mesh.axis_size(axes)
        tag = ",".join(axes)
        res[f"rank:{tag}"] = mesh.device_rank(axes)
        res[f"all_gather:{tag}"] = mesh.all_gather(me, axes)
        res[f"all_gather_tiled1:{tag}"] = mesh.all_gather(
            me.reshape(1, 1).expand(2, 1), axes, axis=1, tiled=True)
        # row j of the frame is addressed to member j
        frame = me * 100 + torch.arange(n, dtype=torch.int32,
                                        device=mesh.device)
        res[f"all_to_all:{tag}"] = mesh.all_to_all(frame, axes)
        res[f"psum_scatter:{tag}"] = mesh.psum_scatter(
            frame.reshape(n, 1) + 0, axes, tiled=False)
        res[f"ppermute:{tag}"] = mesh.ppermute(
            me + 1, axes, [(j, (j + 1) % n) for j in range(0, n, 2)])
    res["counts"] = dict(mesh.counts)
    return res


def gloo_probe(mesh, p2p):
    """gloo's own collectives, called on this rank's CUDA tensors as they
    are (no staging): rank r holds [10r, 10r + 1, ...]; returns each
    result by name, or with `p2p` the ring shift of one
    `batch_isend_irecv`."""
    import torch.distributed as dist

    n, r = mesh.size, mesh.rank
    x = torch.arange(n, dtype=torch.int32, device=mesh.device) + 10 * r
    if p2p:
        y = torch.empty_like(x)
        for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, (r + 1) % n),
                 dist.P2POp(dist.irecv, y, (r - 1) % n)]):
            w.wait()
        return {"batch_isend_irecv": y}
    out = {"all_reduce": x.clone(), "broadcast": x.clone(),
           "all_gather": [torch.empty_like(x) for _ in range(n)],
           "reduce_scatter": torch.empty_like(x[:1]),
           "all_to_all_single": torch.empty_like(x)}
    dist.all_reduce(out["all_reduce"])
    dist.broadcast(out["broadcast"], 0)
    dist.all_gather(out["all_gather"], x)
    dist.reduce_scatter(out["reduce_scatter"], list(x.clone().chunk(n)))
    dist.all_to_all_single(out["all_to_all_single"], x)
    out["all_gather"] = torch.stack(out["all_gather"])
    if x.is_cuda:
        torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# the sharding slice: the sharded model, its steps, checkpoints and engine
# ---------------------------------------------------------------------------


def variant_config(arch, variant=None):
    """`arch`'s reduced config with the `variant`'s "cfg" fields replaced
    (a dict; "ssm" a dict of `SSMConfig` fields)."""
    import dataclasses

    from repro_torch.configs.registry import reduced_config

    cfg = reduced_config(arch)
    fields = dict((variant or {}).get("cfg", {}))
    if "ssm" in fields:
        fields["ssm"] = dataclasses.replace(cfg.ssm, **fields["ssm"])
    return dataclasses.replace(cfg, **fields)


def redrawn_tree(arch, seed=1, variant=None):
    """The port's reduced f32 init tree of `arch` (`variant_config`) as
    numpy, with norms, biases, the SSD's conv bias and dt bias and the
    VLM's gates redrawn nonzero (as tests/test_torch_grad.py's), from
    `seed`."""
    from repro_torch.models import params as TP

    cfg = variant_config(arch, variant)
    params = TP.init_params(cfg, torch.Generator().manual_seed(seed),
                            torch.float32, "cpu")
    rng = np.random.default_rng(seed)
    tree = {}
    for path, a in TP.leaves(params):
        name = path.split("/")[-1]
        a = a.numpy()
        if name.startswith(("b", "norm", "final_norm")) or name in (
                "conv_b", "dt_bias", "gate"):
            a = ((1.0 if name == "gate" else 0.1)
                 * rng.standard_normal(a.shape)).astype(np.float32)
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def family_batch(arch, B=2, seed=1, variant=None):
    """A training batch of `arch`'s reduced config: tokens, labels and the
    family's context; the SSD families take two of their chunks."""
    cfg = variant_config(arch, variant)
    rng = np.random.default_rng(seed)
    S = 2 * cfg.ssm.chunk if cfg.ssm else 16
    tok = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, 24, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _counts(mesh):
    return {f"{k}:{','.join(a)}": n for (k, a), n in mesh.counts.items()}


def _sharded_model(mesh, arch, tree, dtype=torch.float32, variant=None,
                   **kw):
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.policy import replicated_block_rules
    from repro_torch.distributed.sharding import ShardingRules, strip_pod
    from repro_torch.models.registry import build_model
    from repro_torch.train.elastic import reshard_state, shardings_for

    cfg = variant_config(arch, variant)
    if (variant or {}).get("rules") == "replicated_blocks":
        kw["rules"] = replicated_block_rules(strip_pod(ShardingRules(), mesh))
    model = build_model(cfg, mesh, compute_dtype=dtype, device=mesh.device,
                        **kw)
    full = params_from_numpy(tree, cfg, device=mesh.device, dtype=dtype,
                             model_axis=model.model_axis_size)
    return cfg, model, reshard_state(full, shardings_for(mesh, model.specs))


def decode_run(model, params, caches, B, steps, rows=slice(None)):
    """`steps` greedy decode steps of B rows from fixed first tokens and
    lengths: (logits of this rank's rows, tokens of all rows) a step."""
    tok = torch.as_tensor(np.arange(B) * 7 + 3, dtype=torch.int32,
                          device=model.device)[:, None]
    ln = torch.as_tensor(np.arange(B) % 3, dtype=torch.int32,
                         device=model.device)
    logits, toks = [], []
    with torch.no_grad():
        for _ in range(steps):
            lg, caches = model.decode_step(params, caches, tok[rows],
                                           ln[rows])
            g = model.greedy(lg)
            if model.mesh is not None and model._bx:
                g = model.mesh.all_gather(g, model._bx, tiled=True)
            logits.append(lg)
            toks.append(g)
            tok, ln = g[:, None], ln + 1
    return logits, toks


def sharded_families(mesh, cases, steps=4, B=4, S=16):
    """For each (name, arch, tree, batch, variant): the loss, aux, logits
    and every gradient of the sharded model (f32, remat on), each gathered
    whole, and `steps` decode steps of `B` rows over `S` positions (f32
    caches; int8 too for the dense and moe families) where the variant's
    rules can hold caches.  Rank 0 returns them by name."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import P, gather_full, local_shard
    from repro_torch.models import params as TP
    from repro_torch.models.io import init_caches
    from repro_torch.train.steps import batch_spec_tree, sum_replicated_grads
    from repro_torch.train.optimizer import tree_leaves

    out = {}
    for name, arch, tree, batch, variant in cases:
        cfg, model, params = _sharded_model(mesh, arch, tree,
                                            variant=variant)
        flat = tree_leaves(params)
        for w in flat:
            w.requires_grad_(True)
        bx = model._bx
        b = {k: local_shard(torch.as_tensor(v), mesh, P(bx)).clone()
             for k, v in batch.items()}
        mesh.reset_counts()
        logits, aux = model.train_logits(params, b)
        loss = model.loss(logits, b["labels"])
        total = loss + 0.01 * aux
        grads = sum_replicated_grads(
            model, params, list(torch.autograd.grad(total, flat)))
        train_counts = _counts(mesh)
        paths = [p for p, _ in sorted(TP.leaves(params))]
        res = {
            "loss": float(loss.detach()), "aux": float(aux.detach()),
            "logits": gather_full(logits.detach(), mesh,
                                  P(bx, None, model.vocab_axes)),
            "grads": {p: gather_full(g, mesh, TP.spec_at(model.specs, p))
                      for p, g in zip(paths, grads)},
            "train_counts": train_counts, "decode": {}}
        if "model" in model._bx:  # the caches cannot be filled: refused
            try:
                model.decode_step(params, {}, None, None)
            except ValueError as e:
                res["decode_refused"] = str(e)
            out[name] = res
            continue
        for int8 in ((False, True) if cfg.family in ("dense", "moe")
                     else (False,)):
            _, dm, dp = _sharded_model(mesh, arch, tree, variant=variant,
                                       kv_int8=int8)
            specs = batch_spec_tree(cfg, ShapeConfig("d", S, B, "decode"),
                                    dm.rules, mesh, kv_int8=int8)
            caches = init_caches(cfg, B, S, dtype=torch.float32, mesh=mesh,
                                 specs=specs["caches"], kv_int8=int8)
            rows = local_shard(torch.arange(B), mesh, specs["lengths"])
            lg, toks = decode_run(dm, dp, caches, B, steps, rows)
            res["decode"][int8] = {
                "logits": [gather_full(x, mesh, P(bx, dm.vocab_axes))
                           for x in lg], "tokens": toks}
        out[name] = res
    return out if mesh.rank == 0 else None


def placement(mesh, full, specs):
    """`local_shard` then `gather_full` of each array under each spec, and
    `constraint` from the first spec to the last and back."""
    from repro_torch.distributed.sharding import (P, constraint, gather_full,
                                                  local_shard)

    x = torch.as_tensor(full, device=mesh.device)
    out = {"blocks": [], "round": []}
    for s in specs:
        blk = local_shard(x, mesh, P(*s))
        out["blocks"].append(blk.clone())
        out["round"].append(gather_full(blk.contiguous(), mesh, P(*s)))
    a, z = P(*specs[0]), P(*specs[-1])
    moved = constraint(local_shard(x, mesh, a).contiguous(), mesh, z, a)
    out["moved"] = gather_full(moved.contiguous(), mesh, z)
    return out


def elastic(mesh, state, ckpt_dir):
    """tests/device_scripts/elastic_check.py's three checks on the port:
    a (pod=2, data=4) state rescaled live to the first four ranks
    (`sub_mesh`), through a checkpoint, and one train-like step on both
    meshes."""
    from repro_torch.distributed.mesh import sub_mesh
    from repro_torch.distributed.sharding import P, gather_tree
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import (fit_spec_to_mesh, reshard_state,
                                           resume_on_new_mesh, shardings_for)

    spec = {"w": P(("pod", "data"), None), "m": P(("pod", "data"), None)}
    full = {k: torch.as_tensor(v) for k, v in state.items()}
    sh8 = shardings_for(mesh, spec)
    state8 = reshard_state(full, sh8)
    mesh4 = sub_mesh((4,), ("data",), device="cpu")
    spec4 = fit_spec_to_mesh(spec, mesh4) if mesh4 is not None else None
    state4 = reshard_state(state8, shardings_for(mesh4, spec4)
                           if mesh4 is not None else None, sh8)
    out = {"spec4": spec4 and {k: tuple(v) for k, v in spec4.items()},
           "blocks8": state8}
    ckpt.save(ckpt_dir, 3, state8, shardings=sh8)

    def step(s):
        g = s["w"] * 0.1
        return {"w": s["w"] - g, "m": s["m"] * 0.9 + g}

    out["step8"] = gather_tree(step(state8), mesh, spec)
    if mesh4 is not None:
        like = {k: torch.zeros(1) for k in full}
        restored = resume_on_new_mesh(ckpt_dir, like, mesh4, spec4, step=3)
        out |= {"live4": gather_tree(state4, mesh4, spec4),
                "ckpt4": gather_tree(restored, mesh4, spec4),
                "step4": gather_tree(step(state4), mesh4, spec4),
                "rows4": state4["w"]}
    return out


def moe_ep(mesh, x, router, wg, wu, wd, dims):
    """`moe_block_ep` on this rank's rows and experts of a (data, model)
    mesh; each rank's output and aux."""
    from repro_torch.distributed.sharding import P, local_shard
    from repro_torch.models.layers.moe import MoEDims, moe_block_ep

    t = {k: torch.as_tensor(v) for k, v in
         dict(x=x, router=router, wg=wg, wu=wu, wd=wd).items()}
    ex = P("model")
    y, aux = moe_block_ep(
        local_shard(t["x"], mesh, P("data")), t["router"],
        local_shard(t["wg"], mesh, ex), local_shard(t["wu"], mesh, ex),
        local_shard(t["wd"], mesh, ex), MoEDims(**dims), mesh, ("data",))
    return {"y": y, "aux": aux, "counts": _counts(mesh)}


def sharded_train(mesh, cases, ckpt_dir):
    """For each (arch, tree, batches, state_dtype): train steps of the
    reduced model on the mesh (ZeRO-3 + TP, AdamW with `state_dtype`
    moments), a checkpoint of the state saved from the mesh, the gathered
    parameters after each step, and the gathered state and metrics; then
    `train.loop.run(mesh=)` for two steps with a checkpoint a step, and
    again to three (every rank resumes from rank 0's checkpoint)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.loader import place
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as TO
    from repro_torch.train.elastic import shardings_for
    from repro_torch.train.loop import LoopConfig, run
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import (batch_spec_tree, make_train_step,
                                         training_state_shardings)

    out = {}
    for arch, tree, batches, state_dtype in cases:
        opt = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
        cfg, _, params = _sharded_model(mesh, arch, tree)
        step, model = make_train_step(cfg, mesh, opt, device="cpu",
                                      compute_dtype=torch.float32)
        st = adamw_init(params, opt, mesh, model.specs)
        bsh = shardings_for(mesh, batch_spec_tree(
            cfg, ShapeConfig("t", 16, batches[0]["tokens"].shape[0],
                             "train"), model.rules, mesh))
        metrics, snaps = [], []
        for b in batches:
            params, st, m = step(params, st, place(b, bsh))
            metrics.append({k: float(v) for k, v in m.items()})
            snaps.append(TO.tree_map(lambda x: x.clone(), gather_tree(
                params, mesh, model.specs)))
        p_sh, o_sh = training_state_shardings(cfg, mesh, opt, params,
                                              model.specs)
        d = f"{ckpt_dir}/{arch}"
        ckpt.save(d, 2, {"params": params, "opt": st},
                  shardings={"params": p_sh, "opt": o_sh})
        state = {"params": gather_tree(params, mesh, model.specs),
                 "opt": gather_tree(st, mesh, _specs_of(o_sh))}
        state["opt"] = state["opt"]._replace(v=TO.tree_map(  # no bf16 numpy
            lambda x: x.float(), state["opt"].v))
        out[arch] = {"metrics": metrics, "state": state, "snaps": snaps}
    cfg = _sharded_model(mesh, "llama3.2-3b", cases[0][1])[0]
    data = SyntheticLMDataset(vocab=cfg.vocab, seq_len=16, seed=0)
    loops = []
    for steps in (2, 3):
        r = run(cfg, LoopConfig(steps=steps, batch_size=2, ckpt_every=1,
                                ckpt_dir=f"{ckpt_dir}/loop", seed=0),
                mesh=mesh, data=data, device="cpu")
        loops.append({"losses": r["losses"],
                      "resumed_from": r["resumed_from"]})
    out["loop"] = loops
    return out if mesh.rank == 0 else {"loop": loops}


def _specs_of(shardings):
    from repro_torch.distributed.sharding import is_sharding, spec_map

    return spec_map(lambda sh: sh.spec, shardings, is_leaf=is_sharding)


def sharded_engine(mesh, arch, tree, workload, B, S, ticks, dtree):
    """The serving engine with the reduced model on the mesh
    (`tp_only_params` rules; `dtree` the scheduler's decision tree): its
    dispatch stream, outputs and the collectives it issued."""
    from repro_torch.configs.registry import reduced_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import (ShardingRules,
                                                  tp_only_params)
    from repro_torch.train.elastic import reshard_state, shardings_for
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.scheduler import Request

    cfg = reduced_config(arch)
    rules = tp_only_params(ShardingRules())
    eng = ServeEngine(cfg, None, EngineConfig(batch_size=B, max_seq=S),
                      mesh=mesh, rules=rules, seed=0, tree=dtree)
    full = params_from_numpy(tree, cfg, device="cpu", dtype=torch.bfloat16)
    eng.params = reshard_state(full, shardings_for(mesh, eng.model.specs))
    stream = []
    sched_tick = eng.scheduler.tick

    def tick(arrivals, n_dispatch):
        d = sched_tick(arrivals, n_dispatch=n_dispatch)
        stream.append([r.uid for r in d])
        return d

    eng.scheduler.tick = tick
    wl = [[Request(**r) for r in reqs] for reqs in workload]
    res = eng.run(wl, max_steps=ticks)
    return {"stream": stream, "outputs": eng.outputs,
            "completed": res["completed"], "counts": _counts(mesh)}


def full_width_training(mesh, arch, batch, seq_len, steps, seed=0):
    """`steps` train steps of `arch` at full width on the mesh (ZeRO-3 +
    TP, f32 masters drawn from `seed`, bf16 compute, remat, int8 first
    moments) on the synthetic task's first batch: the losses and the peak
    allocated on this rank's card."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.loader import place
    from repro_torch.data.synthetic import SyntheticLMDataset
    from repro_torch.models.params import init_params
    from repro_torch.train.elastic import shardings_for
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.steps import batch_spec_tree, make_train_step

    dev = mesh.device
    cfg = get_config(arch)
    opt_cfg = AdamWConfig(lr=1e-3, state_dtype="int8")
    step, model = make_train_step(cfg, mesh, opt_cfg, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.float32, device=dev,
                         model_axis=model.model_axis_size, mesh=mesh,
                         specs=model.specs)
    opt = adamw_init(params, opt_cfg, mesh, model.specs)
    data = SyntheticLMDataset(cfg.vocab, seq_len=seq_len, fixed_map=True,
                              seed=seed)
    b = place(data.batch(0, batch), shardings_for(mesh, batch_spec_tree(
        cfg, ShapeConfig("t", seq_len, batch, "train"), model.rules, mesh)))
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return {"losses": losses, "peak": torch.cuda.max_memory_allocated(dev),
            "card": str(dev)}


def step_collectives(mesh, archs, B=4, S=16):
    """The collectives, by (kind, axes), of one train step (int8 first
    moments) and one decode step of each reduced arch on this rank, built
    as the dry run builds a cell (`launch.dryrun.build_step`, zero
    blocks: no collective depends on the values).  On an `AbstractMesh`
    call it inside a `FakeTensorMode`."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.train.optimizer import AdamWConfig

    out = {}
    for arch in archs:
        cfg = reduced_config(arch)
        for kind in ("train", "decode"):
            shape = ShapeConfig(kind, S, B, kind)
            step, args = dryrun.build_step(
                cfg, shape, mesh, dryrun.cell_rules(cfg, shape, mesh),
                AdamWConfig(state_dtype="int8"))
            mesh.reset_counts()
            step(*args)
            out[f"{arch}/{kind}"] = _counts(mesh)
    return out


def straddled_int8(mesh, p, g, gnorm, steps):
    """`steps` AdamW updates (int8 first moments) of one (rows, cols) leaf
    whose columns are sharded over 'model', every rank's block of the
    columns: its parameters and its moments' q and scales (whole) after
    each step, as numpy."""
    from repro_torch.distributed.sharding import P, local_shard
    from repro_torch.train import optimizer as O

    spec = P(None, "model")
    opt = O.AdamWConfig(lr=1e-2, state_dtype="int8")
    params = {"w": local_shard(torch.as_tensor(p), mesh, spec).clone()}
    st = O.adamw_init(params, opt, mesh, {"w": spec})
    out = []
    for gi in g:
        grads = {"w": local_shard(torch.as_tensor(gi), mesh, spec)}
        params, st = O.adamw_update(params, grads, st, opt, mesh=mesh,
                                    specs={"w": spec},
                                    gnorm=torch.tensor(gnorm))
        q, scale = st.m["w"]
        out.append((params["w"].clone(), q.clone(), scale.clone()))
    return out


def dryrun_ranks(mesh, archs, p, g, gnorm):
    """tests/test_torch_dryrun.py's rank work in one spawn:
    `step_collectives` and `straddled_int8`."""
    return {"collectives": step_collectives(mesh, archs),
            "straddled": straddled_int8(mesh, p, g, gnorm, len(g))}
