"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles on first use, with nvcc, into its own shared library
with a plain C interface, loaded through `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <name>.so csrc/<name>.cu

The libraries go to ``build/repro_torch_kernels/<source hash>/`` at the
repository root (listed in `.gitignore`), so a changed source builds anew
and an unchanged one is reused.  All sources compile in parallel, one nvcc
process each.  Nothing is compiled or imported when this module is imported;
`load` is called by the kernel wrappers in `kernels.ops` at their first
launch, and a failed build raises.  `build_all` also builds another
tree's sources into a directory of the caller's, and `use` routes a
kernel's launches to such a build (`kernels.compare` times builds of
several trees against each other that way).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
SOURCES = ("windowed_merge", "topk_smallest", "elim_sort", "twochoice_pick",
           "multiq_select", "merge_sorted", "decode_attend")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# What the last build that compiled anything did: seconds, output directory,
# nvcc's messages (the -Xptxas -v register and shared-memory report) per
# source.
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels cannot be built"
    )


def source_digest(csrc: Path = CSRC) -> str:
    """Hash of every kernel source in `csrc` and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return REPO_ROOT / "build" / "repro_torch_kernels" / source_digest()


def build_all(csrc: Path = CSRC, out: Path | None = None,
              names: Sequence[str] = SOURCES) -> Path:
    """Compile every source of `names` in `csrc` whose library is missing
    from `out` (default `build_dir()`), all in parallel."""
    out = out or build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs: List = []
    nvcc = None
    for name in names:
        lib = out / f"{name}.so"
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(tmp),
               str(csrc / f"{name}.cu")]
        procs.append((name, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    if not procs:
        BUILD_INFO.setdefault("dir", str(out))
        return out
    logs: Dict[str, str] = {}
    failed = []
    for name, tmp, lib, proc in procs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{text}")
        else:
            os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out),
                      logs=logs, built=[p[0] for p in procs])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def bind(name: str, lib: ctypes.CDLL) -> None:
    """Declare the C signatures of kernel `name`'s launch and error
    functions (and `decode_attend`'s scratch size) in `lib`."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {
        "windowed_merge": [p] * 9 + [i, i, i, p],
        "topk_smallest": [p] * 4 + [i, i, i, p],
        "elim_sort": [p] * 4 + [i, i, p],
        "twochoice_pick": [p, i] * 4 + [p, i, i, p],
        "multiq_select": [p, i] * 3 + [p, p, i, i, p],
        "merge_sorted": [p] * 6 + [i, i, i, p],
        "decode_attend": [p] * 6 + [f] + [i] * 6 + [p],
    }[name]
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = sig
    fn.restype = i
    if name == "decode_attend":  # the scratch a shape needs, or -1
        lib.decode_attend_scratch.argtypes = [i] * 5
        lib.decode_attend_scratch.restype = ctypes.c_longlong
    err = getattr(lib, f"{name}_error")
    err.argtypes = [i]
    err.restype = ctypes.c_char_p


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`; the first call builds and loads
    every kernel."""
    if not _LIBS:
        out = build_all()
        for src in SOURCES:
            lib = ctypes.CDLL(str(out / f"{src}.so"))
            bind(src, lib)
            _LIBS[src] = lib
    return _LIBS[name]


@contextlib.contextmanager
def use(name: str, lib: ctypes.CDLL):
    """Route the launches of kernel `name` to `lib`, a library of the same
    C interface built from another source tree, inside the block."""
    before = _LIBS.get(name)
    _LIBS[name] = lib
    try:
        yield
    finally:
        if before is None:
            del _LIBS[name]
        else:
            _LIBS[name] = before
