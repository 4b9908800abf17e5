"""Classification features — Table 1 of the paper, unchanged.

Counterpart of src/repro/core/classifier/features.py: the same class ids and
the same normalization (log2 of clients, size and key range; the insert
fraction as is).  `featurize` is the numpy transform the training set uses;
`featurize_t` is the tensor transform `SmartPQ.step` evaluates on the
queue's device every step.
"""

from __future__ import annotations

import numpy as np
import torch

FEATURE_NAMES = ("num_clients", "size", "key_range", "insert_frac")

# Class labels.  Classes 0..NUM_MODES-1 are algorithmic modes and index
# `SmartPQConfig.mode_schedules`; CLASS_NEUTRAL (always the last class) means
# "tie — keep the current mode".
CLASS_OBLIVIOUS = 0
CLASS_MULTIQ = 1
CLASS_AWARE = 2
NUM_MODES = 3
CLASS_NEUTRAL = NUM_MODES
NUM_CLASSES = NUM_MODES + 1
MODE_NAMES = ("oblivious", "multiq", "aware")


def featurize(num_clients, size, key_range, insert_frac) -> np.ndarray:
    """Vectorized feature transform -> float32 (..., 4)."""
    num_clients = np.asarray(num_clients, np.float64)
    size = np.asarray(size, np.float64)
    key_range = np.asarray(key_range, np.float64)
    insert_frac = np.asarray(insert_frac, np.float64)
    f = np.stack(
        [
            np.log2(np.maximum(num_clients, 1.0)),
            np.log2(np.maximum(size, 1.0)),
            np.log2(np.maximum(key_range, 1.0)),
            insert_frac,
        ],
        axis=-1,
    )
    return f.astype(np.float32)


def featurize_t(num_clients: torch.Tensor, size: torch.Tensor,
                key_range: torch.Tensor,
                insert_frac: torch.Tensor) -> torch.Tensor:
    """Tensor mirror of `featurize` in float32 (the reference's
    `featurize_jnp`): 0-d inputs -> (4,) float32 on their device."""

    def lg2(x):
        return torch.log2(torch.clamp(x.to(torch.float32), min=1.0))

    return torch.stack([lg2(num_clients), lg2(size), lg2(key_range),
                        insert_frac.to(torch.float32)])
