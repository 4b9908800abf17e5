"""Integer hashing used to route keys to shards.

Counterpart of src/repro/utils/hashing.py:19-32.
Torch has no uint32 arithmetic on every device, so the 32-bit finalizer runs
in int64 and wraps each multiply back into 32 bits with ``& 0xFFFFFFFF``:
bit for bit the reference's uint32 arithmetic.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


def mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit xorshift-multiply finalizer.  Any int dtype in; the uint32
    result as int64 values in [0, 2**32)."""
    h = x.to(torch.int64) & _MASK  # the int32 -> uint32 reinterpretation
    h = h ^ (h >> 16)
    h = (h * _GOLDEN) & _MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _MASK
    h = h ^ (h >> 16)
    return h


def shard_of_key(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """int32 shard id in [0, num_shards) for each key."""
    return (mix32(keys) % num_shards).to(torch.int32)
