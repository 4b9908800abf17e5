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

# (kernel, coords): the registry's validation shapes, then the main path's
MAIN_SHAPES = {
    "windowed_merge": ({"S": 16, "H": 256, "R": 64},),
    "topk_smallest": ({"R": 1, "N": 1424, "k": 64, "dtype": "int32"},
                      {"R": 2, "N": 512, "k": 64, "dtype": "int32"},
                      {"R": 1, "N": 128, "k": 64, "dtype": "int32"}),
    "elim_sort": ({"R": 64, "B": 64},),
}
CASES = [
    (name, coords)
    for name in ("windowed_merge", "topk_smallest", "elim_sort")
    for coords in REG.REGISTRY[name].validation_shapes + MAIN_SHAPES[name]
]


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


@pytest.mark.parametrize("name,coords", CASES,
                         ids=[f"{n}-{REG.sig(c)}" for n, c in CASES])
@pytest.mark.parametrize("arm", ["ref", INTERPRET])
def test_plain_matches_jax_kernel(name, coords, arm):
    args, kw = _inputs(name, coords)
    want = getattr(JO, name)(*args, **kw, arm=arm)
    _assert_same(_port(name, args, kw), want)


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
