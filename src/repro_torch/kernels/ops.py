"""Public kernel wrappers: a CUDA kernel on the card, the plain version on
the CPU.

Counterpart of src/repro/kernels/ops.py, with the same public wrappers and
padding contracts (src/repro/kernels/ops.py:59-133,207-268) but no arm
registry or tuning cache: a wrapper given CPU tensors runs the plain
PyTorch version (`kernels.ref`), and given CUDA tensors it launches the
hand-written kernel (`kernels/csrc`) or raises.  There is no fallback from
one to the other.

Padding happens inside the kernels, not in extra tensors: `topk_smallest`
treats each row as padded to a multiple of the power-of-two k' >= k,
`elim_sort` pads B to a power of two with (INF, INT32_MAX), and
`windowed_merge` pads the window H+R to a power of two with INF run lanes.
`windowed_merge` also does the gather that follows the Pallas merge (val
and seq by tag, zeroed on INF lanes) in the kernel's epilogue.

Each wrapper counts its kernel launches in `LAUNCHES` (one per launch,
nowhere else), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as R

LAUNCHES: Dict[str, int] = {name: 0 for name in build.SOURCES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors (the
    kernel, after checking what it takes); raises on anything else."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected cpu or cuda")
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: kernel takes int32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name}: kernel takes contiguous 2-D tensors, got shape "
                f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
    return False


def _launch(name: str, lib: ctypes.CDLL, *args) -> None:
    rc = getattr(lib, f"{name}_launch")(*args)
    if rc != 0:
        msg = getattr(lib, f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# bitonic top-k — the deleteMin tournament
# ---------------------------------------------------------------------------


def topk_smallest(keys: torch.Tensor, vals: torch.Tensor, k: int):
    """(R, N) -> the k lexicographically smallest (key, val) pairs per row,
    ascending.  Vals are position-monotone tags (or payloads)."""
    if _on_cpu("topk_smallest", keys, vals):
        return R.topk_smallest_ref(keys, vals, k)
    rows, n = keys.shape
    if vals.shape != keys.shape:
        raise ValueError(f"topk_smallest: shapes {keys.shape} {vals.shape}")
    kout = min(k, n)
    out_k = torch.empty((rows, kout), dtype=torch.int32, device=keys.device)
    out_v = torch.empty_like(out_k)
    if rows:
        _launch("topk_smallest", build.load("topk_smallest"),
                keys.data_ptr(), vals.data_ptr(), out_k.data_ptr(),
                out_v.data_ptr(), rows, n, k, _stream())
    return out_k, out_v


# ---------------------------------------------------------------------------
# elimination-match sort — the fused-window pre-pass
# ---------------------------------------------------------------------------


def elim_sort(keys: torch.Tensor, tags: torch.Tensor):
    """Row-wise full ascending sort of (key, tag) pairs (R, B)."""
    if _on_cpu("elim_sort", keys, tags):
        return R.elim_sort_ref(keys, tags)
    rows, b = keys.shape
    if tags.shape != keys.shape:
        raise ValueError(f"elim_sort: shapes {keys.shape} {tags.shape}")
    out_k = torch.empty_like(keys)
    out_t = torch.empty_like(tags)
    if rows and b:
        _launch("elim_sort", build.load("elim_sort"), keys.data_ptr(),
                tags.data_ptr(), out_k.data_ptr(), out_t.data_ptr(), rows, b,
                _stream())
    return out_k, out_t


# ---------------------------------------------------------------------------
# windowed head merge — the tiered insert hot spot
# ---------------------------------------------------------------------------


def windowed_merge(head_k, head_v, head_q, run_k, run_v, run_q):
    """Full (S, H+R) merge of the ascending head tier and an ascending
    incoming run: (out_k, out_v, out_q), nothing dropped, positional-stable
    (head before run), payloads zeroed on INF lanes."""
    args = (head_k, head_v, head_q, run_k, run_v, run_q)
    if _on_cpu("windowed_merge", *args):
        return R.windowed_merge_ref(*args)
    S, H = head_k.shape
    Rw = run_k.shape[1]
    if any(t.shape != (S, H) for t in args[:3]) or any(
        t.shape != (S, Rw) for t in args[3:]
    ):
        raise ValueError(
            f"windowed_merge: shapes {[tuple(t.shape) for t in args]}"
        )
    out_k = torch.empty((S, H + Rw), dtype=torch.int32, device=head_k.device)
    out_v = torch.empty_like(out_k)
    out_q = torch.empty_like(out_k)
    if S and H + Rw:
        _launch("windowed_merge", build.load("windowed_merge"),
                *(t.data_ptr() for t in args), out_k.data_ptr(),
                out_v.data_ptr(), out_q.data_ptr(), S, H, Rw, _stream())
    return out_k, out_v, out_q
