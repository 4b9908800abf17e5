"""Host reads of device values: where the port's control flow leaves the card.

The JAX package keeps its control flow on the device (`lax.cond`,
`lax.switch`).  The port runs eagerly, so each of those branches becomes a
host read of its predicate followed by one branch.  Every such read goes
through `host_bool` / `host_int` (or `host_array`, for the serving tier's
one read of a window's stacked outputs), which count it in `SYNCS`, so a
run can report how many host syncs a step costs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

SYNCS: Dict[str, int] = {"count": 0}


def reset() -> None:
    SYNCS["count"] = 0


def host_bool(pred: torch.Tensor) -> bool:
    """Read a 0-d bool tensor on the host (one device sync)."""
    SYNCS["count"] += 1
    return bool(pred.item())


def host_int(value: torch.Tensor) -> int:
    """Read a 0-d integer tensor on the host (one device sync)."""
    SYNCS["count"] += 1
    return int(value.item())


def host_array(value: torch.Tensor) -> np.ndarray:
    """Read a tensor into a numpy array on the host (one device sync)."""
    SYNCS["count"] += 1
    return value.detach().cpu().numpy()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return dev
