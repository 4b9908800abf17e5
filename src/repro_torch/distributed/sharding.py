"""Sharding helpers of the port (counterpart of
src/repro/distributed/sharding.py).

Only `pad_to_multiple` is here: the model path reads it to pad the
vocabulary.  The `PartitionSpec` rules wait for the tensor-parallel slice.
"""

from __future__ import annotations


def pad_to_multiple(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult
