"""Two-tier interconnect cost model — ground-truth generator for the tree.

Copy of src/repro/core/classifier/cost_model.py, importing the port's own
`features` and `schedules`; the model and its constants are the
reference's, so both packages train the identical tree.

The paper trains on 5525 workloads *measured* on a 4-node Xeon (§3.1.2-3).
This container has no NUMA/ICI hardware, so ground truth comes from an
analytical per-step model of the two algorithmic modes, built from the same
terms the roofline analysis uses (DESIGN.md §5-6):

  OBLIVIOUS (= spray, the alistarh base algorithm): collective-free local
    pops.  Raw step time is tiny, but relaxed deleteMin returns elements up
    to `spray_bound(S, m)` ranks from the head; the *application* pays for
    each inversion (SSSP re-relaxations, scheduler re-queues, DES rollbacks).
    Modeled as a multiplicative effective-throughput penalty
        w = clip(alpha * rank_err * delete_frac, 0, w_max),
        rank_err = envelope / size, discounted by duplicate density
    — the message-passing analogue of the head-contention the paper's
    oblivious mode suffers under deleteMin-dominated load.

  MULTIQ (= relaxed MultiQueue, Williams & Sanders 2021): collective-free
    like spray, but every deleter probes TWO sub-queue cached minima and
    pops from the smaller — two-choice load balancing shrinks the rank-error
    envelope from spray's m + S*(log2 S + 1)^2 to m + O(S log log S)
    (`multiq_bound`).  Pays for it with double the probe traffic per
    deleter, so on waste-free workloads spray stays marginally cheaper.

  AWARE (= hier, the Nuddle delegation): exact two-phase tournament.  Pays
    an intra-pod gather (fast ICI), a pod-axis candidate exchange (slow
    tier — the compact request/response frames of Nuddle), and two
    collective launch latencies; delivers exact semantics (no waste).

Qualitative regimes reproduced (paper Figs. 1, 7, 9 + the MultiQueue
mixed-contention regime of Engineering MultiQueues):
  * insert-dominated / huge queues    -> OBLIVIOUS (delegation latency wasted,
                                         relaxation free, fewest probes)
  * deleteMin-dominated, queue deep
    enough to absorb the two-choice
    envelope but not the spray one    -> MULTIQ (mixed-contention regime)
  * deleteMin-dominated, small queues
    or many clients                   -> AWARE (contention analogue)
  * few clients / single pod          -> NEUTRAL band (paper §3.1.2 (1)(i))

Divergence from the paper (documented in EXPERIMENTS.md): with very large
queues the relaxation penalty vanishes (rank error is relative), so
deleteMin-dominated + huge-queue workloads favor OBLIVIOUS here, whereas
size-independent cache-line contention keeps Nuddle ahead on real NUMA
hardware.  This is a physical property of the message-passing translation,
not a modeling bug.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.classifier.features import (
    CLASS_AWARE,
    CLASS_MULTIQ,
    CLASS_NEUTRAL,
    CLASS_OBLIVIOUS,
    NUM_MODES,
)
from repro_torch.core.pqueue.schedules import multiq_bound, spray_bound


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # B/s per chip
    ici_bw: float = 50e9  # B/s per link, intra-pod
    dci_bw: float = 12.5e9  # B/s per link, cross-pod tier
    lat_ici: float = 2e-6  # s per intra-pod collective phase
    lat_dci: float = 30e-6  # s per cross-pod collective phase
    vpu_rate: float = 1e11  # key compare/merge element-ops per s per chip
    relax_alpha: float = 3.0  # wasted ops per fully-inverted deletion
    # Cap on the wasted-work fraction.  At envelope saturation (rank error
    # ~1) essentially every relaxed deletion returns junk the application
    # re-queues, so the cap must sit close enough to 1 that a saturated
    # relaxed mode cannot out-throughput the exact mode on raw step speed
    # alone — otherwise the delete-storm regime (paper Fig. 9, deleteMin-
    # dominated) mislabels as OBLIVIOUS.
    relax_wmax: float = 0.999
    bytes_per_item: int = 8  # key + value
    cand_slack: float = 1.5  # expected-case candidate oversampling factor


TPU_V5E = HardwareModel()


@dataclasses.dataclass(frozen=True)
class MeshGeom:
    npods: int = 2
    chips_per_pod: int = 256

    @property
    def chips(self) -> int:
        return self.npods * self.chips_per_pod


@dataclasses.dataclass(frozen=True)
class Workload:
    """One contention workload — the paper's Table 1 feature tuple plus the
    per-client batch the bulk-synchronous translation needs."""

    num_clients: int  # active client devices
    size: int  # current queue size
    key_range: int
    insert_frac: float  # [0, 1]
    ops_per_client: int = 64


def _geom_active(w: Workload, g: MeshGeom):
    """Pods/chips actually hosting active clients."""
    chips_pod = min(max(w.num_clients, 1), g.chips_per_pod)
    pods = max(min(g.npods, -(-w.num_clients // g.chips_per_pod)), 1)
    return chips_pod, pods


def _insert_cost(w: Workload, hw: HardwareModel, g: MeshGeom) -> float:
    """Shared by both modes: hash-route all_to_all + local sorted merge."""
    b_ins = w.num_clients * w.ops_per_client * w.insert_frac
    if b_ins <= 0:
        return 0.0
    chips_pod, pods = _geom_active(w, g)
    bytes_total = b_ins * hw.bytes_per_item
    cross = bytes_total * (pods - 1) / pods
    local = bytes_total - cross
    t_route = local / (hw.ici_bw * max(w.num_clients, 1)) + hw.lat_ici
    if pods > 1:
        t_route += cross / (hw.dci_bw * pods) + hw.lat_dci
    # Rank-merge (searchsorted + scatter) of each shard's incoming run.
    per_shard = b_ins / max(w.num_clients, 1)
    t_merge = per_shard * math.log2(max(w.size + b_ins, 2)) / hw.vpu_rate
    return t_route + t_merge


def _rank_error(w: Workload, b_del: float, mode: int = CLASS_OBLIVIOUS) -> float:
    """Expected relative rank displacement of a relaxed deletion, in [0, 1].
    The envelope is the mode's: spray pays the full O(S log^2 S) window,
    multiq's two-choice sampling pays only O(S log log S)."""
    S = max(w.num_clients, 1)
    m = int(max(b_del, 1))
    envelope = multiq_bound(S, m) if mode == CLASS_MULTIQ else spray_bound(S, m)
    distinct = max(min(w.size, w.key_range), 1)
    dup_discount = max(w.size / distinct, 1.0)  # equal keys are interchangeable
    return min(envelope / max(w.size, 1), 1.0) / dup_discount


def _delete_cost_oblivious(w: Workload, hw: HardwareModel, g: MeshGeom) -> float:
    """Spray: collective-free local window pops."""
    b_del = w.num_clients * w.ops_per_client * (1.0 - w.insert_frac)
    if b_del <= 0:
        return 0.0
    S = max(w.num_clients, 1)
    m_s = b_del / S
    window = m_s + (math.log2(max(S, 2)) + 1) ** 2
    return window * math.log2(max(window, 2)) / hw.vpu_rate


def _delete_cost_multiq(w: Workload, hw: HardwareModel, g: MeshGeom) -> float:
    """Relaxed MultiQueue: collective-free two-choice pops.  Each of the
    b_del deleters reads TWO cached sub-queue minima and compares (the probe
    term — double spray's single landing), then the chosen sub-queues serve
    balanced prefix pops (expected max load m/S + O(log log S))."""
    b_del = w.num_clients * w.ops_per_client * (1.0 - w.insert_frac)
    if b_del <= 0:
        return 0.0
    S = max(w.num_clients, 1)
    probes = 2.0 * b_del  # two min-cache reads + one compare per deleter
    load = b_del / S + math.log2(math.log2(max(S, 4))) + 1.0
    pops = load * math.log2(max(load, 2.0))
    return (probes + pops) / hw.vpu_rate


def _delete_cost_aware(w: Workload, hw: HardwareModel, g: MeshGeom) -> float:
    """Nuddle hierarchical tournament: exact, two collective phases.
    Expected-case single-round selection: every shard nominates
    slack * m/S candidates (two-round fallback amortized into `cand_slack`)."""
    b_del = w.num_clients * w.ops_per_client * (1.0 - w.insert_frac)
    if b_del <= 0:
        return 0.0
    m = max(b_del, 1.0)
    chips_pod, pods = _geom_active(w, g)
    S = max(w.num_clients, 1)
    cand = hw.cand_slack * m / S + 8.0  # per-shard nomination

    # Phase 1 (ICI): all-gather per-pod candidates + replicated k-way merge.
    ph1_bytes = cand * chips_pod * hw.bytes_per_item
    pod_cand = cand * chips_pod
    t1 = ph1_bytes / hw.ici_bw  # ring all-gather: each chip receives all cands
    t1 += hw.lat_ici
    t1 += pod_cand * math.log2(max(chips_pod, 2)) / hw.vpu_rate  # k-way merge

    # Phase 2 (DCI, pod axis only): compact pod-winner frames.
    if pods > 1:
        per_pod = hw.cand_slack * m / pods + 8.0
        ph2_bytes = per_pod * pods * hw.bytes_per_item
        t2 = ph2_bytes / hw.dci_bw + hw.lat_dci
        t2 += per_pod * pods * math.log2(max(pods, 2)) / hw.vpu_rate
    else:
        t2 = 0.0

    # Prefix removal (local shift) — HBM touch of the shard frontier.
    t3 = (m / S) * hw.bytes_per_item / hw.hbm_bw
    return t1 + t2 + t3


def _delete_cost_flat(w: Workload, hw: HardwareModel, g: MeshGeom) -> float:
    """lotan_shavit: one flat global gather — all candidates cross DCI."""
    b_del = w.num_clients * w.ops_per_client * (1.0 - w.insert_frac)
    if b_del <= 0:
        return 0.0
    m = max(b_del, 1.0)
    D = max(w.num_clients, 1)
    chips_pod, pods = _geom_active(w, g)
    cand = hw.cand_slack * m / D + 8.0
    bytes_total = cand * D * hw.bytes_per_item
    t = bytes_total / hw.ici_bw + hw.lat_ici
    if pods > 1:
        t += bytes_total * (pods - 1) / pods / hw.dci_bw + hw.lat_dci
    t += cand * D * math.log2(max(D, 2)) / hw.vpu_rate
    return t


def _waste_fraction(
    w: Workload, hw: HardwareModel, mode: int = CLASS_OBLIVIOUS
) -> float:
    """Fraction of a relaxed mode's work lost to priority inversion."""
    b_del = w.num_clients * w.ops_per_client * (1.0 - w.insert_frac)
    if b_del <= 0:
        return 0.0
    rank_err = _rank_error(w, b_del, mode)
    return min(hw.relax_alpha * rank_err * (1.0 - w.insert_frac), hw.relax_wmax)


_DELETE_COSTS = {
    CLASS_OBLIVIOUS: _delete_cost_oblivious,
    CLASS_MULTIQ: _delete_cost_multiq,
    CLASS_AWARE: _delete_cost_aware,
}

_RELAXED_MODES = (CLASS_OBLIVIOUS, CLASS_MULTIQ)  # modes paying inversion waste


def schedule_cost(
    mode: int, w: Workload, hw: HardwareModel = TPU_V5E, g: MeshGeom = MeshGeom()
) -> float:
    """Seconds per bulk step for an algorithmic mode (class id < NUM_MODES)."""
    if mode not in _DELETE_COSTS:
        raise ValueError(f"no cost for mode {mode}")
    return _insert_cost(w, hw, g) + _DELETE_COSTS[mode](w, hw, g)


def throughput(mode: int, w: Workload, hw=TPU_V5E, g=MeshGeom()) -> float:
    """*Effective* ops/second — the paper's metric, with relaxed-mode
    throughput discounted by the wasted-work fraction (see module doc)."""
    t = schedule_cost(mode, w, hw, g)
    total_ops = w.num_clients * w.ops_per_client
    raw = total_ops / max(t, 1e-12)
    if mode in _RELAXED_MODES:
        raw *= 1.0 - _waste_fraction(w, hw, mode)
    return raw


def mode_throughputs(
    w: Workload, hw: HardwareModel = TPU_V5E, g: MeshGeom = MeshGeom()
) -> tuple:
    """Effective throughput of every algorithmic mode, indexed by class id."""
    return tuple(throughput(m, w, hw, g) for m in range(NUM_MODES))


def best_mode(
    w: Workload,
    hw: HardwareModel = TPU_V5E,
    g: MeshGeom = MeshGeom(),
    neutral_band: float = 0.07,
) -> int:
    """Label: argmax-throughput mode, or NEUTRAL when the runner-up is inside
    the tie band.  The paper uses an absolute 1.5 Mops/s band (§3.1.2 (4)); a
    relative band is the scale-free equivalent for a 512-chip mesh."""
    ts = mode_throughputs(w, hw, g)
    order = sorted(range(NUM_MODES), key=lambda m: ts[m], reverse=True)
    hi, second = ts[order[0]], ts[order[1]]
    if hi <= 0 or (hi - second) / hi < neutral_band:
        return CLASS_NEUTRAL
    return order[0]
