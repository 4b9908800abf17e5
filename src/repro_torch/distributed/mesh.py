"""The named-axis device mesh and its collectives, over `torch.distributed`.

Counterpart of src/repro/distributed/mesh.py (the axis names, `make_mesh`,
`batch_axes`, `mesh_geometry`, `local_fits`) and of what JAX's `shard_map`
gives the code inside it: named axes, a device's rank along them, and the
collectives `all_gather`, `psum`, `pmax`, `psum_scatter`, `all_to_all` and
`ppermute` over a tuple of axis names.

One process is one device of the mesh.  Global ranks are row-major over the
mesh's axes, as JAX orders its devices, and a tuple of axis names maps to
the process group of the ranks that differ only along those axes, ranked
row-major over the tuple in the order given (`device_rank`).  Every group
is made when the mesh is made, since `new_group` is collective over all
ranks.  Each collective gives JAX's result layout and is counted in
`Mesh.counts` by (kind, axis tuple), as `kernels.ops.LAUNCHES` counts
kernel launches, so a run can show which collectives a path issued, and
its payload's bytes in `Mesh.bytes`.

Device and backend are explicit: the card unless the caller names another
device (`utils.hostsync.resolve_device`), NCCL on CUDA and gloo on the CPU
unless the caller names a backend.  Gloo named on CUDA tensors (several
ranks on one card, where NCCL refuses to run) stages every payload through
host memory: the mesh chooses this from the backend it was given, and
`Mesh.transport` says so.

`spawn` runs a function on every rank of a mesh, one process each, and
returns each rank's result as numpy arrays: the counterpart of `shard_map`
over virtual devices.  `AbstractMesh` has a mesh's geometry and no process
behind it: its collectives take fake tensors and move nothing, for a
step traced ahead of time (`launch/dryrun.py`).
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import itertools
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.utils.hostsync import resolve_device

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"

Axes = Tuple[str, ...]
_SRC = Path(__file__).resolve().parents[2]


def _axes(axes) -> Axes:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass
class _Group:
    group: object  # the torch ProcessGroup
    members: List[int]  # global ranks, row-major over the axis tuple
    sorted_pos: Dict[int, int]  # global rank -> its rank in `group`


class MeshGeometry:
    """A named-axis mesh's geometry as one device sees it: the axes and
    their sizes, this device's rank and coordinates, and the collectives
    it issued, counted by (kind, axis tuple) in `counts` and their payload
    bytes in `bytes`."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int,
                 device: torch.device):
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} must pair up, names unique")
        self.axis_names: Axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.device = device
        self.counts: Counter = Counter()
        self.bytes: Counter = Counter()  # payload bytes this rank sent in
        self._coords = dict(zip(axes, _unravel(rank, shape)))

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_size(self, axes) -> int:
        """Devices along the axis tuple (counterpart of dist.py:64-76)."""
        return math.prod(self.shape[a] for a in _axes(axes))

    def device_rank(self, axes) -> int:
        """Row-major rank over the given axes (counterpart of dist.py:
        79-84)."""
        r = 0
        for a in _axes(axes):
            r = r * self.shape[a] + self._coords[a]
        return r

    def _count(self, kind: str, axes, x: torch.Tensor) -> Axes:
        axes = _axes(axes)
        if x.device != self.device:
            raise ValueError(f"{kind}: tensor on {x.device}, mesh on "
                             f"{self.device}")
        self.counts[(kind, axes)] += 1
        self.bytes[(kind, axes)] += x.numel() * x.element_size()
        return axes

    def reset_counts(self) -> None:
        self.counts.clear()
        self.bytes.clear()


class Mesh(MeshGeometry):
    """This process's view of a named-axis mesh: its rank, device and
    backend, one process group per tuple of axes, and the collectives.
    Made by `make_mesh`."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int,
                 device: torch.device, backend: str, owns_group: bool):
        super().__init__(shape, axes, rank, device)
        self.backend = backend
        self.staged = backend == "gloo" and device.type == "cuda"
        self._owns_group = owns_group
        self._groups: Dict[frozenset, Tuple[object, List[int]]] = {}
        self._by_axes: Dict[Axes, _Group] = {}
        # new_group is collective: every rank makes every group, in order.
        for k in range(1, len(axes) + 1):
            for subset in itertools.combinations(axes, k):
                rest = [a for a in axes if a not in subset]
                for fixed in itertools.product(
                        *(range(self.shape[a]) for a in rest)):
                    ranks = sorted(self._rank_of({**dict(zip(rest, fixed)),
                                                  **dict(zip(subset, c))})
                                   for c in itertools.product(
                                       *(range(self.shape[a])
                                         for a in subset)))
                    group = dist.new_group(ranks, backend=backend)
                    if rank in ranks:
                        self._groups[frozenset(subset)] = (group, ranks)

    def _group(self, axes: Axes) -> _Group:
        if axes not in self._by_axes:
            group, ranks = self._groups[frozenset(axes)]
            members = [self._rank_of({**self._coords, **dict(zip(axes, c))})
                       for c in itertools.product(
                           *(range(self.shape[a]) for a in axes))]
            self._by_axes[axes] = _Group(group, members,
                                         {g: i for i, g in enumerate(ranks)})
        return self._by_axes[axes]

    @property
    def transport(self) -> str:
        """How this mesh moves payloads: the backend, the device and, for
        gloo on CUDA, that payloads go through host memory."""
        staged = ", payloads host-staged" if self.staged else ""
        return f"{self.backend} on {self.device}{staged}"

    # -- collectives ---------------------------------------------------------

    def _begin(self, kind: str, axes, x: torch.Tensor):
        axes = self._count(kind, axes, x)
        payload = x.contiguous()
        return self._group(axes), payload.cpu() if self.staged else payload

    def _end(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(self.device) if self.staged else y

    def all_gather(self, x: torch.Tensor, axes, axis: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every member's `x`, in the axis tuple's row-major order: stacked
        along a new dimension `axis`, or with `tiled` concatenated along
        dimension `axis`."""
        g, p = self._begin("all_gather", axes, x)
        parts = [torch.empty_like(p) for _ in g.members]
        dist.all_gather(parts, p, group=g.group)
        parts = [parts[g.sorted_pos[r]] for r in g.members]
        out = torch.cat(parts, axis) if tiled else torch.stack(parts, axis)
        return self._end(out)

    def _all_reduce(self, kind, x, axes, op) -> torch.Tensor:
        g, p = self._begin(kind, axes, x)
        p = p.clone()
        dist.all_reduce(p, op=op, group=g.group)
        return self._end(p)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce("psum", x, axes, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._all_reduce("pmax", x, axes, dist.ReduceOp.MAX)

    def psum_scatter(self, x: torch.Tensor, axes, scatter_dimension: int = 0,
                     tiled: bool = True) -> torch.Tensor:
        """The sum over the members, of which member i keeps block i of
        dimension `scatter_dimension` (with `tiled` False the dimension has
        one entry per member and is dropped)."""
        g, p = self._begin("psum_scatter", axes, x)
        n = len(g.members)
        if p.shape[scatter_dimension] % n:
            raise ValueError(f"psum_scatter: dimension {scatter_dimension} "
                             f"of {tuple(p.shape)} does not split {n} ways")
        blocks = p.chunk(n, scatter_dimension)
        by_rank = [None] * n
        for i, r in enumerate(g.members):
            by_rank[g.sorted_pos[r]] = blocks[i].contiguous()
        out = torch.empty_like(by_rank[0])
        dist.reduce_scatter(out, by_rank, group=g.group)
        if not tiled:
            out = out.squeeze(scatter_dimension)
        return self._end(out)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Block j of dimension 0 goes to member j; block j of the result
        came from member j (JAX's split_axis=0, concat_axis=0, tiled)."""
        g, p = self._begin("all_to_all", axes, x)
        n = len(g.members)
        if p.shape[0] % n:
            raise ValueError(f"all_to_all: {p.shape[0]} rows do not split "
                             f"{n} ways")
        # all_to_all_single runs in group-rank (sorted) order
        to_sorted = [g.members.index(r) for r in sorted(g.members)]
        blocks = p.reshape(n, -1, *p.shape[1:])
        out = torch.empty_like(blocks)
        dist.all_to_all_single(out, blocks[to_sorted].contiguous(),
                               group=g.group)
        from_sorted = [g.sorted_pos[r] for r in g.members]
        return self._end(out[from_sorted].reshape(p.shape))

    def ppermute(self, x: torch.Tensor, axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Member `dst` receives member `src`'s `x` for each (src, dst) of
        `perm` (indices in the axis tuple's row-major order); a member that
        receives nothing gets zeros, as in JAX."""
        g, p = self._begin("ppermute", axes, x)
        me = g.members.index(self.rank)
        out = torch.zeros_like(p)
        ops = []
        for src, dst in perm:
            if src == me and dst == me:
                out.copy_(p)
            elif src == me:
                ops.append(dist.P2POp(dist.isend, p, g.members[dst],
                                      g.group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, g.members[src],
                                      g.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return self._end(out)

    # -- lifetime ------------------------------------------------------------

    def close(self) -> None:
        """Tear the process group down if this mesh set it up."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self._owns_group = False

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# The HLO collective each `Mesh` collective lowers to
# (src/repro/utils/hlo.py:16-17 counts their output bytes).
HLO_COLLECTIVE = {"all_gather": "all-gather", "psum": "all-reduce",
                  "pmax": "all-reduce", "psum_scatter": "reduce-scatter",
                  "all_to_all": "all-to-all", "ppermute": "collective-permute"}


class AbstractMesh(MeshGeometry):
    """A mesh of `shape` over `axes` with no process group behind it: the
    port's form of the reference's ahead-of-time lowering on virtual
    devices (`launch/dryrun.py`).  This process is at coordinate 0 of
    every axis.  Each collective takes a fake tensor
    (`torch._subclasses.FakeTensorMode`) and returns one of its output's
    shape and dtype, moving nothing; it is counted in `counts` and `bytes`
    as `Mesh` counts it, and its output bytes in `op_bytes` under the HLO
    name it lowers to (`HLO_COLLECTIVE`).  A real tensor is refused: the
    values a fake collective gives mean nothing."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device=None):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        super().__init__(shape, axes, 0, dev)
        self.op_bytes: Counter = Counter()

    @property
    def op_counts(self) -> Counter:
        """The calls under the HLO name each lowers to."""
        out: Counter = Counter()
        for (kind, _), n in self.counts.items():
            out[HLO_COLLECTIVE[kind]] += n
        return out

    def _fake(self, kind: str, axes, x: torch.Tensor, shape) -> torch.Tensor:
        from torch._subclasses.fake_tensor import is_fake

        if not is_fake(x):
            raise ValueError(f"{kind}: an abstract mesh takes fake tensors "
                             f"only (torch._subclasses.FakeTensorMode)")
        self._count(kind, axes, x)
        out = x.new_empty(shape)
        self.op_bytes[HLO_COLLECTIVE[kind]] += out.numel() * x.element_size()
        return out

    def all_gather(self, x, axes, axis: int = 0, tiled: bool = False):
        shape = list(x.shape)
        n = self.axis_size(axes)
        if tiled:
            shape[axis] *= n
        else:
            shape.insert(axis, n)
        return self._fake("all_gather", axes, x, shape)

    def psum(self, x, axes):
        return self._fake("psum", axes, x, x.shape)

    def pmax(self, x, axes):
        return self._fake("pmax", axes, x, x.shape)

    def psum_scatter(self, x, axes, scatter_dimension: int = 0,
                     tiled: bool = True):
        n = self.axis_size(axes)
        shape = list(x.shape)
        if shape[scatter_dimension] % n:
            raise ValueError(f"psum_scatter: dimension {scatter_dimension} "
                             f"of {tuple(shape)} does not split {n} ways")
        shape[scatter_dimension] //= n
        if not tiled:
            del shape[scatter_dimension]
        return self._fake("psum_scatter", axes, x, shape)

    def all_to_all(self, x, axes):
        n = self.axis_size(axes)
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split "
                             f"{n} ways")
        return self._fake("all_to_all", axes, x, x.shape)

    def ppermute(self, x, axes, perm):
        return self._fake("ppermute", axes, x, x.shape)

    def reset_counts(self) -> None:
        super().reset_counts()
        self.op_bytes.clear()


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for n in reversed(shape):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None,
              backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: int = 0,
              timeout_s: float = 600.0) -> Mesh:
    """This process's `Mesh` of `shape` over `axes`, on `device` (the card
    unless the caller names another) with `backend` (NCCL on CUDA, gloo on
    the CPU, unless named).  Sets up the default process group (world size
    the product of `shape`, this process's `rank`, `init_method`) unless
    one is set up already; a one-device mesh needs no `init_method`."""
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} "
                         f"must pair up, names unique")
    dev = resolve_device(device)
    world = math.prod(shape)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or default_backend(dev)
    owns = not dist.is_initialized()
    if owns:
        # one device rendezvous with itself: an in-process store
        if init_method is None and world != 1:
            raise ValueError(f"a mesh of {world} devices needs the "
                             f"init_method its ranks share")
        where = (dict(store=dist.HashStore()) if init_method is None
                 else dict(init_method=init_method))
        dist.init_process_group(
            backend, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **where)
    elif dist.get_world_size() != world:
        raise ValueError(f"mesh of {world} devices on a process group of "
                         f"{dist.get_world_size()}")
    return Mesh(shape, axes, dist.get_rank(), dev, backend, owns)


def sub_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None,
             backend: Optional[str] = None) -> Optional[Mesh]:
    """A mesh of `shape` over the first prod(shape) ranks of the process
    group already set up (another mesh's): the live side of an elastic
    rescale onto fewer devices.  Every rank of the group calls it, since
    making process groups is collective; a rank outside the new mesh gets
    None."""
    if not dist.is_initialized():
        raise ValueError("sub_mesh: no process group is set up")
    size = math.prod(shape)
    world = dist.get_world_size()
    if size > world:
        raise ValueError(f"sub_mesh of {size} devices in a group of {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    mesh = Mesh(shape, axes, rank, dev,
                backend or dist.get_backend(), owns_group=False)
    return mesh if rank < size else None


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    return tuple(a for a in (AXIS_POD, AXIS_DATA) if a in mesh.axis_names)


def mesh_geometry(mesh: Mesh) -> Tuple[int, int]:
    """(npods, chips_per_pod)."""
    npods = mesh.shape.get(AXIS_POD, 1)
    return npods, mesh.size // npods


def local_fits(mesh: Mesh, dim: int, axis: str = AXIS_MODEL) -> bool:
    return dim % mesh.shape[axis] == 0


# ---------------------------------------------------------------------------
# spawn: one process a rank
# ---------------------------------------------------------------------------


def _to_numpy(tree):
    """Tensors to numpy arrays through dicts, lists, tuples, named tuples
    and dataclasses (a dataclass becomes a dict of its fields)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _target(fn: Callable) -> Tuple[str, str]:
    """(module:qualname, directory to put on the path) naming `fn` so that a
    fresh interpreter can import it."""
    module = fn.__module__
    path = getattr(sys.modules[module], "__file__", None)
    if path is None or "<locals>" in fn.__qualname__:
        raise ValueError(f"spawn: {fn!r} cannot be imported by name")
    if module == "__main__":
        module = Path(path).stem
    return f"{module}:{fn.__qualname__}", str(Path(path).resolve().parent)


def spawn(fn: Callable, shape: Tuple[int, ...], axes: Tuple[str, ...],
          device=None, backend: Optional[str] = None,
          init_file: Optional[str] = None, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a `shape` mesh over `axes`,
    one process a rank, on `device` (the card unless the caller names
    another) with `backend` (NCCL on CUDA, gloo on the CPU, unless named).
    `fn` must be importable by module and name; `args` are pickled to each
    rank.  Returns the ranks' results, in rank order, with every tensor as
    a numpy array.  A rank that fails, or runs past `timeout` seconds,
    raises with its stderr's tail, after the other ranks are stopped.
    The ranks rendezvous on `init_file` (a fresh file under a temporary
    directory unless named)."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    target, fn_dir = _target(fn)
    world = math.prod(shape)
    work = Path(tempfile.mkdtemp(prefix="repro_torch_spawn_"))
    try:
        with open(work / "args.pkl", "wb") as f:
            pickle.dump(args, f)
        spec = dict(target=target, shape=tuple(shape), axes=tuple(axes),
                    device=str(dev), backend=backend,
                    init_method="file://" + str(init_file or work / "store"),
                    timeout=timeout, work=str(work))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            p for p in (str(_SRC), fn_dir, os.environ.get("PYTHONPATH"))
            if p))
        procs = []
        for r in range(world):
            with open(work / f"rank{r}.err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c",
                     "import sys; from repro_torch.distributed.mesh import "
                     "_rank_main; _rank_main(sys.argv[1], int(sys.argv[2]))",
                     repr(spec), str(r)],
                    env=env, stdout=subprocess.DEVNULL, stderr=err))
        _wait_ranks(procs, work, time.monotonic() + timeout)
        out = []
        for r in range(world):
            with open(work / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _wait_ranks(procs, work: Path, deadline: float) -> None:
    """Wait for every rank; on the first failure or at the deadline stop
    the rest and raise with the failed ranks' stderr tails."""
    failed = []
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        failed = failed or [r for r, p in enumerate(procs)
                            if p.poll() != 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        tails = "\n".join(
            f"--- rank {r} (exit {procs[r].returncode}) ---\n"
            + (work / f"rank{r}.err").read_text()[-3000:] for r in failed)
        raise RuntimeError(f"spawn: ranks {failed} failed or timed out:\n"
                           f"{tails}")


def _rank_main(spec_text: str, rank: int) -> None:
    """One rank of `spawn`: set up the mesh, run the function, write its
    result for the parent."""
    import ast

    spec = ast.literal_eval(spec_text)
    module, name = spec["target"].split(":")
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    with open(Path(spec["work"]) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    mesh = make_mesh(spec["shape"], spec["axes"], device=spec["device"],
                     backend=spec["backend"],
                     init_method=spec["init_method"], rank=rank,
                     timeout_s=spec["timeout"])
    with mesh:
        out = _to_numpy(fn(mesh, *args))
    tmp = Path(spec["work"]) / f"rank{rank}.pkl.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, Path(spec["work"]) / f"rank{rank}.pkl")
