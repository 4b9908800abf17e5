"""Parity of the port's kernel wrappers with the JAX package's kernels.

On the CPU a port wrapper runs its kernel's plain PyTorch version; the JAX
side runs its jnp reference arm and its Pallas kernel in interpret mode.
Inputs are made with numpy from a seed (the JAX registry's input makers) and
both sides must agree bit for bit, shapes and dtypes included, at the
registry's validation shapes and at the shapes the fused window gives each
kernel.  tests/test_torch_gpu.py holds each CUDA kernel against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ops as JO
from repro.kernels import registry as REG
from repro_torch.kernels import ops as TO

# The tensors here are small: one intra-op thread per test process keeps
# torch from contending for the cores with the suite's other workers.
torch.set_num_threads(1)

INF_KEY = 2**31 - 1
INTERPRET = "interpret@rows_per_block=1"
# The JAX package's Pallas interpret arm of each kernel, where it is not
# INTERPRET (the MULTIQ kernels have no rows_per_block axis).
PALLAS_ARM = {"twochoice_counts": "interpret",
              "multiq_select_topm": "interpret"}

# (kernel, coords): the registry's validation shapes, then the main path's
# ((16, 64) is a validation shape of both MULTIQ kernels; 57 and 22 are the
# lane widths of the paper's Fig. 11 and Fig. 10 c_mix traces, and the run
# widths of their step inserts (R = B through `route_dense`); top-k also
# takes the registry's tuning shapes and a k' = 512 run, wider than the
# CUDA kernel keeps in registers; (8, 1024, 128) is merge_sorted's tuning
# shape, it has no main-path shape)
MAIN_SHAPES = {
    "windowed_merge": ({"S": 16, "H": 256, "R": 64},
                       {"S": 16, "H": 256, "R": 57},
                       {"S": 16, "H": 256, "R": 22}),
    "topk_smallest": tuple(
        {"R": R, "N": N, "k": k, "dtype": "int32"} for R, N, k in (
            (1, 1424, 64), (2, 512, 64), (1, 128, 64),
            (1, 1312, 57), (2, 456, 57), (1, 114, 57),
            (1, 752, 22), (2, 176, 22), (1, 44, 22),
            (16, 4096, 64), (1, 1024, 64), (1, 512, 64),
            (2, 2048, 300))),
    "elim_sort": ({"R": 64, "B": 64},),
    "twochoice_counts": ({"S": 16, "m": 57},),
    "multiq_select_topm": ({"S": 16, "m": 57}, {"S": 16, "m": 22}),
    "merge_sorted_runs": ({"S": 8, "C": 1024, "R": 128},),
}
CASES = [
    (name, coords)
    for name in ("windowed_merge", "topk_smallest", "elim_sort",
                 "twochoice_counts", "multiq_select_topm",
                 "merge_sorted_runs")
    for coords in REG.REGISTRY[name].validation_shapes + MAIN_SHAPES[name]
]
ARM_CASES = [(arm if arm == "ref" else PALLAS_ARM.get(name, INTERPRET), name,
              coords) for arm in ("ref", INTERPRET) for name, coords in CASES]


def _inputs(name, coords, seed=0):
    args, kw = REG.REGISTRY[name].make_inputs(coords,
                                             np.random.default_rng(seed))
    return [np.asarray(a) for a in args], kw


def _port(name, args, kw, device="cpu"):
    return getattr(TO, name)(*(torch.as_tensor(np.array(a), device=device)
                               for a in args), **kw)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, g.shape,
                                                         w.dtype, w.shape)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize(
    "arm,name,coords", ARM_CASES,
    ids=[f"{a}-{n}-{REG.sig(c)}" for a, n, c in ARM_CASES])
def test_plain_matches_jax_kernel(arm, name, coords):
    args, kw = _inputs(name, coords)
    want = getattr(JO, name)(*args, **kw, arm=arm)
    got = _port(name, args, kw)
    _assert_same(got if isinstance(got, tuple) else (got,),
                 want if isinstance(want, tuple) else (want,))


def test_twochoice_ties_and_inactive_lanes_match_jax():
    """Minima drawn from three values (INF among them): most lanes break
    ties by shard id; a fifth of the lanes are parked."""
    rng = np.random.default_rng(4)
    mins = rng.choice(np.array([5, 9, INF_KEY], np.int32), 16)
    a, b = (rng.integers(0, 16, 57).astype(np.int32) for _ in range(2))
    act = rng.random(57) < 0.8
    got = TO.twochoice_counts(*(torch.as_tensor(x) for x in (mins, a, b,
                                                             act)))
    for arm in ("ref", "interpret"):
        _assert_same((got,), (JO.twochoice_counts(mins, a, b, act,
                                                  arm=arm),))
    assert int(got.sum()) == int(act.sum())


def test_multiq_select_reads_strided_windows():
    """The MULTIQ core hands the kernel wrapper the window
    head_keys[:, :m] of the (S, H) head tier, a view; the answer is the
    contiguous copy's."""
    args, _ = _inputs("multiq_select_topm", {"S": 16, "m": 57})
    win_k, win_v, take = (torch.as_tensor(np.array(a)) for a in args)
    head_k = torch.full((16, 256), INF_KEY, dtype=torch.int32)
    head_v = torch.zeros((16, 256), dtype=torch.int32)
    head_k[:, :57], head_v[:, :57] = win_k, win_v
    got = TO.multiq_select_topm(head_k[:, :57], head_v[:, :57], take)
    _assert_same(got, JO.multiq_select_topm(*args, arm="interpret"))


def test_merge_sorted_kernel_agrees_with_local_merge():
    """The capacity-wide merge keeps what the rank merge of the JAX
    package's `local.merge_sorted` keeps (tests/test_kernels.py:86-108),
    and the port's own `local.merge_sorted` is bit-identical to it."""
    from repro.core.pqueue import local as JL
    from repro_torch.core.pqueue import local as TL

    rng = np.random.default_rng(5)
    S, C, R = 4, 64, 16
    buf_k = np.full((S, C), INF_KEY, np.int32)
    run_k = np.full((S, R), INF_KEY, np.int32)
    sizes, counts = np.zeros(S, np.int32), np.zeros(S, np.int32)
    for s in range(S):
        sizes[s] = rng.integers(0, C - R)
        buf_k[s, :sizes[s]] = np.sort(rng.integers(0, 500, sizes[s]))
        counts[s] = rng.integers(0, R + 1)
        run_k[s, :counts[s]] = np.sort(rng.integers(0, 500, counts[s]))
    buf_v = rng.integers(0, 99, (S, C)).astype(np.int32)
    run_v = rng.integers(0, 99, (S, R)).astype(np.int32)
    args = (buf_k, buf_v, run_k, run_v, sizes, counts)
    want = JL.merge_sorted(*args)
    got = TL.merge_sorted(*(torch.as_tensor(a) for a in args))
    _assert_same(got, want)
    zeros = np.zeros_like(run_k)
    mk, _ = TO.merge_sorted_runs(*(torch.as_tensor(a) for a in (
        buf_k, np.zeros_like(buf_k), run_k, zeros)))
    np.testing.assert_array_equal(mk.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("arm", ["ref", INTERPRET])
@pytest.mark.parametrize("K,B,ins_frac", [(84, 57, 0.5), (30, 22, 0.5),
                                          (64, 64, 0.0)],
                         ids=["table3", "c_mix", "all_inf"])
def test_elim_sort_op_logs_match_jax(arm, K, B, ins_frac):
    """The op logs the window sorts (`local.sort_op_log`): path C's (Fig.
    11 Table 3, Fig. 10 c_mix) with half the lanes inserting, and path A's
    at ins0, where every key is INF and the tags alone order each row."""
    rng = np.random.default_rng(K * B)
    keys = rng.integers(0, 1 << 10, (K, B)).astype(np.int32)
    keys[rng.random((K, B)) >= ins_frac] = INF_KEY
    tags = np.tile(np.arange(B, dtype=np.int32), (K, 1))
    got = TO.elim_sort(torch.as_tensor(keys), torch.as_tensor(tags))
    _assert_same(got, JO.elim_sort(keys, tags, arm=arm))


@pytest.mark.parametrize("arm", ["ref", INTERPRET])
def test_merge_sorted_duplicate_words_match_jax(arm):
    """All vals 0 and keys in [0, 8): equal (key, val) words stand in the
    buffer and the run, and the INF-keyed ones of both are equal too."""
    rng = np.random.default_rng(8)
    S, C, R = 4, 256, 64
    rows = []
    for W in (C, R):
        k = np.full((S, W), INF_KEY, np.int32)
        for s in range(S):
            n = rng.integers(0, W + 1)
            k[s, :n] = np.sort(rng.integers(0, 8, n))
        rows += [k, np.zeros((S, W), np.int32)]
    got = TO.merge_sorted_runs(*(torch.as_tensor(a) for a in rows))
    _assert_same(got, JO.merge_sorted_runs(*rows, arm=arm))


def test_topk_inf_lanes_match_jax_path():
    """The spray tournament's candidates are mostly INF lanes; the port's
    plain version must order them by position like the JAX arms the fused
    window takes on the CPU (`ref`, and the default `argsort`)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 50, (1, 1424)).astype(np.int32)
    keys[rng.random((1, 1424)) < 0.97] = INF_KEY
    tags = np.arange(1424, dtype=np.int32)[None, :]
    got = TO.topk_smallest(torch.as_tensor(keys), torch.as_tensor(tags), 64)
    for arm in ("ref", "argsort"):
        _assert_same(got, JO.topk_smallest(keys, tags, 64, arm=arm))


def test_windowed_merge_prefill_shape_matches_jax():
    """The bulk prefill's merge (H=256, R=4096, padded window 8192)."""
    args, kw = _inputs("windowed_merge", {"S": 2, "H": 256, "R": 4096})
    for arm in ("ref", INTERPRET):
        _assert_same(_port("windowed_merge", args, kw),
                     JO.windowed_merge(*args, arm=arm))


@pytest.mark.parametrize("R", [64, 57, 22, 4096])
def test_windowed_merge_matches_jax_rank_arm(R):
    """The JAX package's `rank` arm places each word at its index plus its
    rank in the other row, the formulation of the CUDA kernel: the port's
    plain version equals it at the step inserts and the prefill."""
    args, kw = _inputs("windowed_merge", {"S": 16, "H": 256, "R": R})
    _assert_same(_port("windowed_merge", args, kw),
                 JO.windowed_merge(*args, arm="rank"))


def test_cpu_wrappers_count_no_launch():
    TO.reset_launches()
    for name, coords in CASES[:1] + CASES[-1:]:
        args, kw = _inputs(name, coords)
        _port(name, args, kw)
    assert all(v == 0 for v in TO.LAUNCHES.values())


def test_wrapper_rejects_mixed_devices():
    a = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        TO.elim_sort(a, a.to("meta"))
