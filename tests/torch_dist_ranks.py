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
