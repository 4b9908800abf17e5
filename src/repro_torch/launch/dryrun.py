"""The dry run: every (arch x shape x mesh) cell's step traced on one device
of an abstract production mesh, on fake tensors.

Counterpart of src/repro/launch/dryrun.py: the same CLI, cells, rule
choices and `STATE_DTYPE`.  Where the reference lowers and compiles the
step for 256 or 512 virtual devices and reads XLA's analyses, the port
traces one device's step in Python:

  1. the production mesh is an `AbstractMesh` (`launch/mesh.py`): the
     mesh's geometry, this process at coordinate 0 of every axis, and
     collectives that give their output's shape and move nothing;
  2. the step (`train.steps.make_train_step`, `make_prefill_step` or
     `make_serve_step`) is built on it as a user would build it on a real
     mesh, and runs once under `torch._subclasses.FakeTensorMode` on
     `--device` (the card unless it names another): each parameter, moment
     and batch leaf is this device's block as a fake tensor, which has a
     shape, a dtype and a device and no storage;
  3. `torch.utils.flop_counter.FlopCounterMode` counts the matmul FLOPs
     (the reference's dot FLOPs, src/repro/utils/hlo.py:14-15; the port's
     model has no convolution), the backward pass and remat's recompute
     included; the mesh counts every collective and its output bytes under
     the HLO name it lowers to; `LiveBytes` tracks the bytes of the live
     storages and their peak;
  4. one JSON record a cell goes to build/dryrun_torch/.

The record keeps the reference's keys where the quantity is the same
(`flops_per_device`, `collective_*`, `memory_per_device`'s argument,
output, alias and peak bytes, `params`, `active_params`).  XLA's own
quantities (`xla_*_body_once`, `hbm_bytes_proxy_per_device`, `temp_bytes`,
`lower_s`, `compile_s`) have no counterpart; `trace_s` is the trace's wall
time.  The fit test is the device's memory, not the TPU's 16 GiB:
`fits_device_memory` against `device_memory_bytes` (the card's
`total_memory`; on the CPU the capacity the caller of `lower_cell` passes,
else null).  The port has no scan, so `--cast-before-scan` is refused.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --multi-pod both --device cpu --device-memory-bytes BYTES
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k --one-device --device cpu

A cell's replication multiple is its `flops_per_device` times `n_chips`
over the `--one-device` record's `flops_per_device`: 1.0 where the mesh
splits every FLOP, more where devices repeat work.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.configs.registry import get_config, list_configs
from repro_torch.distributed.mesh import AbstractMesh
from repro_torch.distributed.sharding import (ShardingRules, drop_batch_axes,
                                              local_shape, replicate_unused,
                                              spec_map, strip_pod,
                                              tp_only_params)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.io import input_specs
from repro_torch.models.params import leaves, param_layout, param_specs
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         opt_state_specs)
from repro_torch.train.steps import (batch_spec_tree, make_prefill_step,
                                     make_serve_step, make_train_step)
from repro_torch.utils.hostsync import resolve_device

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# Per-arch optimizer state dtype (the reference's, src/repro/launch/
# dryrun.py:45-51).
STATE_DTYPE = {
    "jamba-1.5-large-398b": "int8",
    "qwen2.5-32b": "bf16",
    "llama-3.2-vision-11b": "bf16",
    "granite-8b": "bf16",
}


class LiveBytes(TorchDispatchMode):
    """The bytes of the live storages of a traced step and their peak.  A
    storage counts from the first op output (or `track`ed argument) that
    holds it until a weakref finalizer sees it die; views and in-place
    results hold a storage already counted."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._sizes = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        self._sizes[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def argument_bytes(tree) -> int:
    """The bytes of a tree's tensors, each storage once."""
    return sum(_storages(tree).values())


def _storages(tree) -> dict:
    """{storage key: bytes} of every tensor of a tree (each storage once)."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _block(shape, spec, mesh, dtype) -> torch.Tensor:
    """This device's block of a `shape` tensor under `spec`, zeros (a fake
    tensor inside a `FakeTensorMode`)."""
    return torch.zeros(local_shape(shape, mesh, spec), dtype=dtype,
                       device=mesh.device)


def abstract_state(cfg, mesh, rules, opt_cfg: AdamWConfig,
                   serving: bool = False):
    """(params, param specs, optimizer state, its specs): this device's
    blocks from `params.param_layout` and the spec tree at the mesh's
    model axis, f32 masters to train and bf16 to serve (the reference
    casts every floating leaf), and `adamw_init`'s moments of them.  No
    leaf is ever drawn whole: call it inside a `FakeTensorMode`."""
    model_axis = mesh.shape.get("model", 16)
    specs = param_specs(cfg, rules, model_axis)
    dtype = torch.bfloat16 if serving else torch.float32
    params: dict = {}
    for path, (shape, _) in leaves(param_layout(cfg, model_axis)):
        *outer, name = path.split("/")
        node, spec = params, specs
        for k in outer:
            node, spec = node.setdefault(k, {}), spec[k]
        node[name] = _block(shape, spec[name], mesh, dtype)
    opt = adamw_init(params, opt_cfg, mesh, specs)
    return params, specs, opt, opt_state_specs(params, specs, opt_cfg, mesh)


def _device_memory(dev: torch.device, capacity: Optional[int]):
    """(name, bytes) of the device the trace judges the fit on."""
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return props.name, int(props.total_memory)
    return None, capacity


def cell_rules(cfg, shape, mesh, serve_tp_only: bool = False,
               auto_policy: bool = False) -> ShardingRules:
    """The rules a cell runs under (src/repro/launch/dryrun.py:128-150).
    A global batch that does not divide the batch devices (long_500k's 1)
    leaves them to no activation rule; those that no parameter rule takes
    either are declared replicated (`replicate_unused`), where the
    reference's GSPMD replicates them unasked."""
    rules = strip_pod(ShardingRules(), mesh)
    n_batch_devs = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    split_batch = shape.global_batch % n_batch_devs == 0
    if not split_batch:
        rules = drop_batch_axes(rules)
    # TP-only serving placement only when bf16 params fit comfortably next
    # to the KV cache when replicated over 'data' (<= ~4 GiB/device).
    model_axis = mesh.shape.get("model", 1)
    params_fit_tp = cfg.param_count() * 2 / model_axis <= 2 * 2**30
    if serve_tp_only and shape.kind in ("prefill", "decode") and params_fit_tp:
        rules = tp_only_params(rules)
    if auto_policy and shape.kind == "train":
        from repro_torch.distributed.policy import apply_policy

        rules = apply_policy(cfg, mesh, rules, global_batch=shape.global_batch)
    return rules if split_batch else replicate_unused(rules, mesh)


def build_step(cfg, shape, mesh, rules, opt_cfg: AdamWConfig,
               kv_chunk: int = 2048, microbatches: int = 1,
               kv_int8: bool = False):
    """(step, its arguments) of a `shape` on `mesh`: the step built as a
    user builds it on a real mesh, and this device's blocks of its
    arguments (the parameters, the optimizer state to train, the batch),
    zeros.  Inside a `FakeTensorMode` the blocks are fake."""
    use_int8 = kv_int8 and cfg.family in ("dense", "moe")
    if shape.kind == "train":
        step, model = make_train_step(
            cfg, mesh, opt_cfg, rules=rules, remat=True, kv_chunk=kv_chunk,
            microbatches=microbatches, device=mesh.device)
    elif shape.kind == "prefill":
        step, model = make_prefill_step(cfg, mesh, kv_chunk=kv_chunk,
                                        rules=rules, device=mesh.device)
    else:  # decode / serve
        step, model = make_serve_step(
            cfg, mesh, kv_chunk=max(kv_chunk, 4096), rules=rules,
            kv_int8=use_int8, device=mesh.device)
    params, _, opt, _ = abstract_state(cfg, mesh, model.rules, opt_cfg,
                                       serving=shape.kind != "train")
    batch = spec_map(
        lambda s, m: _block(m.shape, s, mesh, m.dtype),
        batch_spec_tree(cfg, shape, model.rules, mesh, kv_int8=use_int8),
        input_specs(cfg, shape, kv_int8=use_int8))
    return step, ((params, opt, batch) if shape.kind == "train"
                  else (params, batch))


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               kv_chunk: int = 2048, serve_tp_only: bool = False,
               microbatches: int = 1, auto_policy: bool = False,
               kv_int8: bool = False, one_device: bool = False,
               device=None):
    """(step, its arguments, the mesh) of an applicable cell
    (`build_step`) on the production mesh, or with `one_device` on a
    (1, 1) mesh (the whole global batch's step).  Call it inside a
    `FakeTensorMode`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = (AbstractMesh((1, 1), ("data", "model"), device=device)
            if one_device else
            make_production_mesh(multi_pod=multi_pod, device=device))
    step, args = build_step(
        cfg, shape, mesh, cell_rules(cfg, shape, mesh, serve_tp_only,
                                     auto_policy),
        AdamWConfig(state_dtype=STATE_DTYPE.get(arch, "fp32")),
        kv_chunk=kv_chunk, microbatches=microbatches, kv_int8=kv_int8)
    return step, args, mesh


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               kv_chunk: int = 2048, serve_tp_only: bool = False,
               microbatches: int = 1, auto_policy: bool = False,
               kv_int8: bool = False, one_device: bool = False,
               device=None,
               device_memory_bytes: Optional[int] = None) -> dict:
    """Trace one cell; returns its record.  With `one_device` the cell's
    whole step runs on a (1, 1) mesh: its FLOPs over a production record's
    FLOPs times `n_chips` say how much of the work the mesh repeats."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, SHAPES[shape_name])
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}

    dev = resolve_device(device)
    t0 = time.perf_counter()
    with FakeTensorMode():
        step, args, mesh = build_cell(
            arch, shape_name, multi_pod, kv_chunk=kv_chunk,
            serve_tp_only=serve_tp_only, microbatches=microbatches,
            auto_policy=auto_policy, kv_int8=kv_int8,
            one_device=one_device, device=dev)
        inputs = _storages(args)
        live = LiveBytes()
        for t in tree_leaves(args):
            live.track(t)
        with FlopCounterMode(display=False) as flops, live:
            out = step(*args)
        outputs = _storages(out)
    trace_s = time.perf_counter() - t0

    peak = live.peak
    name, capacity = _device_memory(dev, device_memory_bytes)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "n_chips": mesh.size,
        "trace_s": round(trace_s, 1),
        "flops_per_device": int(flops.get_total_flops()),
        "collective_bytes_per_device": sum(mesh.op_bytes.values()),
        "collective_bytes_by_op": dict(mesh.op_bytes),
        "collective_counts": dict(mesh.op_counts),
        "collectives_by_axes": {f"{kind}[{','.join(axes)}]": n
                                for (kind, axes), n in mesh.counts.items()},
        "memory_per_device": {
            "argument_bytes": sum(inputs.values()),
            "output_bytes": sum(outputs.values()),
            "alias_bytes": sum(n for k, n in outputs.items() if k in inputs),
            "peak_estimate_bytes": peak,
        },
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "device": str(dev),
        "device_name": name,
        "device_memory_bytes": capacity,
        "fits_device_memory": None if capacity is None else peak <= capacity,
    }
    fit = {None: "capacity unknown", True: "FITS", False: "OVER"}[
        rec["fits_device_memory"]]
    print(f"[dryrun] {arch} x {shape_name} x "
          f"{_mesh_tag(multi_pod, one_device)}: trace {trace_s:.1f}s | "
          f"peak/device {peak / 2**30:.2f} GiB ({fit}) | flops/dev "
          f"{rec['flops_per_device']:.3e} | coll/dev "
          f"{rec['collective_bytes_per_device'] / 2**30:.3f} GiB")
    return rec


def _mesh_tag(multi_pod: bool, one_device: bool) -> str:
    return "1dev" if one_device else "2pod" if multi_pod else "1pod"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=("true", "false", "both"),
                    default="false")
    ap.add_argument("--kv-chunk", type=int, default=2048)
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--cast-before-scan", action="store_true",
                    help="perf: bf16-cast stacked params outside the scan")
    ap.add_argument("--serve-tp-only", action="store_true",
                    help="perf: serving params TP-sharded, data-replicated")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="perf: gradient accumulation slices (train shapes)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="perf: int8 KV cache with per-(token,head) scales "
                         "(decode shapes, dense/moe families)")
    ap.add_argument("--auto-policy", action="store_true",
                    help="perf: per-arch parallelism policy (replicate block "
                         "weights for TP-starved models)")
    ap.add_argument("--tag", default="", help="suffix for output JSON names")
    ap.add_argument("--one-device", action="store_true",
                    help="trace each cell's whole step on a (1, 1) mesh")
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the "
                         "card)")
    ap.add_argument("--device-memory-bytes", type=int, default=None,
                    help="the capacity the fit is judged against off the "
                         "card (on the card: its total_memory)")
    args = ap.parse_args(argv)
    if args.cast_before_scan:
        ap.error("--cast-before-scan casts the stacked parameters outside "
                 "the reference's lax.scan; the PyTorch port has no scan")

    archs = list_configs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"true": [True], "false": [False], "both": [False, True]}[
        args.multi_pod]

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = (f"{arch}_{shape}_{_mesh_tag(mp, args.one_device)}"
                       f"{args.tag}")
                try:
                    rec = lower_cell(
                        arch, shape, mp, kv_chunk=args.kv_chunk,
                        serve_tp_only=args.serve_tp_only,
                        microbatches=args.microbatches,
                        auto_policy=args.auto_policy,
                        kv_int8=args.kv_int8, one_device=args.one_device,
                        device=args.device,
                        device_memory_bytes=args.device_memory_bytes,
                    )
                except Exception as e:  # noqa: BLE001 — report, keep going
                    rec = {
                        "arch": arch, "shape": shape, "multi_pod": mp,
                        "status": "error", "error": repr(e),
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    failures.append(tag)
                    print(f"[dryrun] FAIL {tag}: {e!r}")
                (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
