"""Public kernel wrappers: a CUDA kernel on the card, the plain version on
the CPU.

Counterpart of src/repro/kernels/ops.py, with the same public wrappers and
padding contracts (src/repro/kernels/ops.py:59-308) but no arm
registry or tuning cache: a wrapper given CPU tensors runs the plain
PyTorch version (`kernels.ref`), and given CUDA tensors it launches the
hand-written kernel (`kernels/csrc`) or raises.  There is no fallback from
one to the other.

Padding happens inside the kernels, not in extra tensors: `topk_smallest`
treats each row as padded to a multiple of the power-of-two k' >= k, and
`elim_sort` pads B to a power of two (at least 32) with (INF, INT32_MAX).
`multiq_select_topm` pads m to a power of two with (INF, INT32_MAX).
`windowed_merge` and `merge_sorted_runs` pad nothing: they are rank
merges, each word written at its index plus its rank in the other row
(`merge_sorted_runs`'s run pads, (INF, INT32_MAX) up to C, would all land
past C).  `windowed_merge` and `multiq_select_topm` also do the gather
that follows the Pallas kernel (the payloads, zeroed on INF lanes) in the
kernel.

Most kernels take contiguous 2-D tensors.  The two MULTIQ kernels read the
head tier in place: `twochoice_counts` takes 1-D tensors of any stride (its
`mins` is the column `head_keys[:, 0]`) and `multiq_select_topm` takes
windows with unit column stride and any row stride (`head_keys[:, :m]`);
the wrapper passes the strides to the kernel.

`decode_attend` is the one kernel that replaces no Pallas kernel and has
no plain version here: it takes CUDA tensors only, and its plain arm is
`models.layers.attention.attend_chunked` itself, which calls it for a
one-token query over a per-row-length cache on the card.

Each wrapper counts its kernel launches in `LAUNCHES` (one per launch,
nowhere else), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref as R

LAUNCHES: Dict[str, int] = {name: 0 for name in build.SOURCES}

# The widest row `windowed_merge` takes, H + R words (its `kMaxWindow`):
# the row it stages in shared memory stays within 128 KB.
MAX_MERGE_WINDOW = 1 << 15
_DECODE_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# How far `decode_attend` may lie from its plain arm, by dtype.  bf16: one
# ulp of the plain arm's element (2^-7 of it at most) plus 2^-14 absolute;
# both sides are f32 sums of the same terms in another order (about 1e-6
# apart), which can round to the neighbouring bf16 number, and next to 0
# the order's error is absolute.  f32 outputs keep the f32 sums' difference.
DECODE_TOL = {torch.bfloat16: dict(rtol=2.0 ** -7, atol=2.0 ** -14),
              torch.float32: dict(rtol=1e-5, atol=1e-5)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _strided_ok(t: torch.Tensor) -> bool:
    """A 1-D tensor of any stride, or a 2-D one whose rows are contiguous."""
    return t.dim() == 1 or (t.dim() == 2 and (t.stride(1) == 1
                                               or t.shape[1] <= 1))


def _on_cpu(name: str, *tensors: torch.Tensor, strided: bool = False,
            masks: Tuple[torch.Tensor, ...] = ()) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors (the
    kernel, after checking what it takes); raises on anything else.  The
    kernel takes contiguous 2-D int32 tensors, or with `strided` what
    `_strided_ok` accepts; `masks` are bool tensors it takes the same way."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors + masks):
        raise ValueError(f"{name}: tensors on "
                         f"{[str(t.device) for t in tensors + masks]}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected cpu or cuda")
    for t, want in ([(t, torch.int32) for t in tensors]
                    + [(t, torch.bool) for t in masks]):
        if t.dtype != want:
            raise TypeError(f"{name}: kernel takes {want}, got {t.dtype}")
        if strided and not _strided_ok(t):
            raise ValueError(
                f"{name}: kernel takes 1-D tensors or 2-D tensors with "
                f"contiguous rows, got shape {tuple(t.shape)} strides "
                f"{t.stride()}"
            )
        if not strided and (t.dim() != 2 or not t.is_contiguous()):
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
# MULTIQ two-choice probe + commit-side tournament
# ---------------------------------------------------------------------------


def twochoice_counts(mins: torch.Tensor, choice_a: torch.Tensor,
                     choice_b: torch.Tensor,
                     act: torch.Tensor) -> torch.Tensor:
    """Per-shard commit counts (S,) int32 of the MULTIQ two-choice probe:
    `mins` (S,) cached per-shard minima, `choice_a`/`choice_b` (m,) shard
    ids in [0, S), `act` (m,) bool (False parks the lane; the plain
    version also takes ints)."""
    if _on_cpu("twochoice_pick", mins, choice_a, choice_b, strided=True,
               masks=(act,)):
        return R.twochoice_counts_ref(mins, choice_a, choice_b, act)
    S, m = mins.shape[0], choice_a.shape[0]
    if (mins.dim(), choice_a.dim(), choice_b.dim(), act.dim()) != (1,) * 4 \
            or choice_b.shape[0] != m or act.shape[0] != m:
        raise ValueError(
            f"twochoice_counts: shapes {tuple(mins.shape)} "
            f"{tuple(choice_a.shape)} {tuple(choice_b.shape)} "
            f"{tuple(act.shape)}")
    counts = torch.empty((S,), dtype=torch.int32, device=mins.device)
    if S:
        _launch("twochoice_pick", build.load("twochoice_pick"),
                mins.data_ptr(), mins.stride(0), choice_a.data_ptr(),
                choice_a.stride(0), choice_b.data_ptr(), choice_b.stride(0),
                act.data_ptr(), act.stride(0), counts.data_ptr(), S, m,
                _stream())
    return counts


def multiq_select_topm(win_k: torch.Tensor, win_v: torch.Tensor,
                       take: torch.Tensor):
    """The m smallest (key, val) pairs of the take-prefixes of the S
    ascending head windows (S, m), ascending, as two (m,) tensors; lanes
    past the popped count read (INF, 0).  The network runs on (key,
    position-tag) pairs and the vals follow by tag, so ties go to the lower
    (shard, column)."""
    if _on_cpu("multiq_select", win_k, win_v, take, strided=True):
        return R.multiq_select_ref(win_k, win_v, take)
    if win_k.dim() != 2 or win_v.shape != win_k.shape or take.dim() != 1 \
            or take.shape[0] != win_k.shape[0]:
        raise ValueError(
            f"multiq_select_topm: shapes {tuple(win_k.shape)} "
            f"{tuple(win_v.shape)} {tuple(take.shape)}")
    S, m = win_k.shape
    out_k = torch.empty((m,), dtype=torch.int32, device=win_k.device)
    out_v = torch.empty_like(out_k)
    if S and m:
        _launch("multiq_select", build.load("multiq_select"),
                win_k.data_ptr(), win_k.stride(0), win_v.data_ptr(),
                win_v.stride(0), take.data_ptr(), take.stride(0),
                out_k.data_ptr(), out_v.data_ptr(), S, m, _stream())
    return out_k, out_v


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


# ---------------------------------------------------------------------------
# capacity-wide sorted merge (no caller on the fused window's path)
# ---------------------------------------------------------------------------


def merge_sorted_runs(buf_k, buf_v, run_k, run_v):
    """The smallest C of each row's buffer (S, C) ∪ run (S, R), R <= C and
    C a power of two, ascending and lexicographic on (key, val)."""
    args = (buf_k, buf_v, run_k, run_v)
    if _on_cpu("merge_sorted", *args):
        return R.merge_sorted_runs_ref(*args)
    S, C = buf_k.shape
    Rw = run_k.shape[1]
    if buf_v.shape != (S, C) or run_k.shape != (S, Rw) \
            or run_v.shape != (S, Rw):
        raise ValueError(
            f"merge_sorted_runs: shapes {[tuple(t.shape) for t in args]}")
    if C & (C - 1) or Rw > C:
        raise ValueError(f"merge_sorted_runs: needs C a power of two and "
                         f"R <= C, got C={C} R={Rw}")
    out_k = torch.empty_like(buf_k)
    out_v = torch.empty_like(buf_v)
    if S and C:
        _launch("merge_sorted", build.load("merge_sorted"),
                *(t.data_ptr() for t in args), out_k.data_ptr(),
                out_v.data_ptr(), S, C, Rw, _stream())
    return out_k, out_v


# ---------------------------------------------------------------------------
# segment-min — the SSSP relax fold
# ---------------------------------------------------------------------------


def segment_min_into(dist: torch.Tensor, tgt: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """Fold E candidate (target, value) pairs into the (n,) `dist`
    elementwise-min; targets outside [0, n) drop (the reference's
    ``mode="drop"``, src/repro/kernels/ops.py:316-334).  The reference has
    no Pallas kernel for it, only two jnp arms (`kernels/segmin.py`), so it
    stays one PyTorch op: a scatter-min into an (n + 1,) buffer whose last
    slot takes the dropped lanes.  int32 min is associative and
    commutative, so any order of the scatter gives the same result."""
    n = dist.shape[0]
    idx = torch.where((tgt >= 0) & (tgt < n), tgt, n).to(torch.int64)
    buf = torch.cat([dist, dist.new_zeros((1,))])
    buf.scatter_reduce_(0, idx, vals.to(dist.dtype), "amin",
                        include_self=True)
    return buf[:n]


# ---------------------------------------------------------------------------
# decode attention over the valid prefix of each cache row
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _decode_scratch(B: int, S: int, Hq: int, Hkv: int, hd: int) -> int:
    """Floats of scratch `decode_attend` needs at these shapes; the kernel's
    source alone holds the limits on them, and this raises past them."""
    n = build.load("decode_attend").decode_attend_scratch(B, S, Hq, Hkv, hd)
    if n < 0:
        raise ValueError(
            f"decode_attend: kernel does not take B {B}, S {S}, Hq {Hq}, "
            f"Hkv {Hkv}, hd {hd} (its limits: csrc/decode_attend.cu)")
    return n


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """One-token attention of q (B, 1, Hq, hd) over the first kv_len[b]
    positions (clamped to [0, S]) of each row of k, v (B, S, Hkv, hd):
    (B, 1, Hq, hd) in q's dtype.  Query head h reads KV head h // G.  The
    query is scaled by `scale` (a number of q's dtype) in that dtype, then
    everything is f32, as `attend_chunked`'s plain arm computes it; a row
    with kv_len 0 reads 0.  The kernel takes contiguous, 16-byte aligned
    CUDA tensors: q, k, v of one dtype, bf16 or f32, and kv_len (B,)
    int32, at the shapes its source allows (`_decode_scratch`)."""
    name = "decode_attend"
    ts = (q, k, v, kv_len)
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev
            and kv_len.device == dev):
        raise ValueError(f"{name}: the kernel takes CUDA tensors on one "
                         f"device, got {[str(t.device) for t in ts]}")
    if q.dtype not in _DECODE_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype or kv_len.dtype != torch.int32:
        raise TypeError(f"{name}: kernel takes q, k, v of one dtype of "
                        f"{list(_DECODE_DTYPES)} and int32 lengths, got "
                        f"{[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in ts]}")
    B, Sq, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if (Sq != 1 or k.shape != (B, S, Hkv, hd) or v.shape != k.shape
            or kv_len.shape != (B,)):
        raise ValueError(
            f"{name}: kernel takes q (B, 1, Hq, hd), k and v (B, S, Hkv, "
            f"hd), kv_len (B,); got {[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts) \
            or any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: kernel takes contiguous tensors, q, k and "
                         f"v 16-byte aligned")
    out = torch.empty_like(q)
    if B:
        part = torch.empty(_decode_scratch(B, S, Hq, Hkv, hd),
                           dtype=torch.float32, device=dev)
        _launch(name, build.load(name), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                part.data_ptr(), scale, _DECODE_DTYPES[q.dtype], B, S, Hq,
                Hkv, hd, _stream())
    return out
