"""The reference's random draws as tensors, for the port's parity tests.

The JAX package draws its spray and MULTIQ choices with `jax.random` from a
per-step key (src/repro/core/pqueue/schedules.py:252-256,275-276,323-328);
the port takes the same numbers as tensors with a leading step axis, in the
form `schedules.step_draws` gives them: (shard_choice (T, m), hi (T, S, W),
choice_b (T, m)).  `m` is the deleteMin bound: a `SmartPQ.step`'s lane
width B, or a fixed schedule's wavefront m.  The key streams follow the
reference's drivers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _draw_fn(S, m, W):
    def one(r):
        k_shard, k_pos = jax.random.split(r)
        return (jax.random.randint(k_shard, (m,), 0, S),
                jax.random.randint(k_pos, (S, W), 0,
                                   (1 << 31) // (W + 1) - 1, dtype=jnp.int32),
                jax.random.randint(k_pos, (m,), 0, S))

    return jax.jit(jax.vmap(one))


def draws_from_keys(rngs, S, m, H):
    """(shard_choice, hi, choice_b) for each per-step key in `rngs` (T,):
    the spray core's draws and MULTIQ's second choice (its first is
    shard_choice, the same call on the same key)."""
    pad = (max(int(S - 1).bit_length(), 1) + 1) ** 2
    return tuple(torch.as_tensor(np.array(x))
                 for x in _draw_fn(S, m, min(m + pad, H))(rngs))


def window_keys(seed, steps):
    """The per-step keys of one fused scan: `traces.trace_rngs` and the DES
    hold engine (src/repro/workloads/des.py:121)."""
    return jax.random.split(jax.random.key(seed), steps)


def chunked_keys(seed, steps, chunk=8):
    """The per-step keys of the SSSP engines (src/repro/workloads/sssp.py:
    148-152,257-263): each chunk splits a fresh subkey of a running key."""
    key = jax.random.key(seed)
    out = []
    for _ in range(-(-steps // chunk)):
        key, sub = jax.random.split(key)
        out.append(jax.random.split(sub, chunk))
    return jnp.concatenate(out)[:steps]


def scheduler_keys(seed, ticks):
    """The per-tick keys of the serving scheduler
    (src/repro/serve/scheduler.py:495,677-682): each tick splits its running
    key, keeps the first half as the running key and hands the step the
    second."""
    key = jax.random.key(seed)
    out = []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        out.append(sub)
    return jnp.stack(out)
