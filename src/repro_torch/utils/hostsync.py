"""Host reads of device values: where the port's control flow leaves the card.

The JAX package keeps its control flow on the device (`lax.cond`,
`lax.switch`).  The port runs eagerly, so each of those branches becomes a
host read of its predicate followed by one branch.  Every such read goes
through `host_bool` / `host_int` (or `host_array`, for the serving tier's
one read of a window's stacked outputs), which count it in `SYNCS`, so a
run can report how many host syncs a step costs.

Each call names its `site`, a constant label of the line that reads
(``"<module>.<what>"``).  `SITES` holds, per site, the reads and the host
seconds spent blocked in them (two `perf_counter` readings a read, always
on); `SYNCS["count"]` stays the total.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

SYNCS: Dict[str, int] = {"count": 0}
# site -> [reads, host seconds blocked in them]
SITES: Dict[str, List[float]] = {}


def reset() -> None:
    SYNCS["count"] = 0
    SITES.clear()


def site_counts() -> Dict[str, List[float]]:
    """A copy of `SITES`, to subtract from a later one."""
    return {k: list(v) for k, v in SITES.items()}


def _count(site: str, t0: float) -> None:
    dt = time.perf_counter() - t0
    SYNCS["count"] += 1
    rec = SITES.get(site)
    if rec is None:
        SITES[site] = [1, dt]
    else:
        rec[0] += 1
        rec[1] += dt


def host_bool(pred: torch.Tensor, site: str) -> bool:
    """Read a 0-d bool tensor on the host (one device sync)."""
    t0 = time.perf_counter()
    out = bool(pred.item())
    _count(site, t0)
    return out


def host_int(value: torch.Tensor, site: str) -> int:
    """Read a 0-d integer tensor on the host (one device sync)."""
    t0 = time.perf_counter()
    out = int(value.item())
    _count(site, t0)
    return out


def host_array(value: torch.Tensor, site: str) -> np.ndarray:
    """Read a tensor into a numpy array on the host (one device sync)."""
    t0 = time.perf_counter()
    out = value.detach().cpu().numpy()
    _count(site, t0)
    return out


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
