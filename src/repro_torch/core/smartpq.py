"""SmartPQ — the paper's adaptive priority queue (§3), in PyTorch.

Counterpart of src/repro/core/smartpq.py, whose docstring gives the design:
every algorithmic mode works on the same `PQState`; a packed decision tree,
evaluated on the queue's device every `decision_interval` steps, picks the
mode; and a mode switch needs no synchronization point.  The mode set is
`SmartPQConfig.mode_schedules`, indexed by classifier class id.

The shipped modes are the reference's (smartpq.py:18-22):

    0 MODE_OBLIVIOUS -> SPRAY_HERLIHY  relaxed, collective-free spray
    1 MODE_MULTIQ    -> MULTIQ         relaxed MultiQueue, two-choice probes
    2 MODE_AWARE     -> HIER           exact Nuddle pod delegation

`run_window` runs K steps: the elimination pre-pass sorts the whole (K, B)
operation log in one `elim_sort` launch in front of the loop, and each step
then featurizes, decides, eliminates, inserts (`windowed_merge`), refills the
head when needed and runs its mode's deleteMin (`topk_smallest` for SPRAY
and HIER, `twochoice_pick` and `multiq_select` for MULTIQ).
`make_mode_steps` gives one step function per mode on the same state, for a
host that picks the mode itself.

Where the reference stays on the device, the port reads a few predicates on
the host (`utils.hostsync`): the `lax.cond`s of insert and of the tiered
state's rebalances, and the step's mode in place of `lax.switch`.  A step
costs three to six such reads.

Randomness: the spray and MULTIQ cores take their draws as tensors.  The
step's mode is decided on the device and read on the host, so a step may
run either random core, and `step` takes the draws of both:
``draws=(shard_choice (B,), hi (S, W), choice_b (B,))`` — the reference's
per-step `jax.random` draws, so tests can feed both packages the same
numbers.  The spray takes (shard_choice, hi), MULTIQ (shard_choice,
choice_b): the reference draws MULTIQ's first choice with the very call the
spray draws its shard choice with.  A config without MULTIQ may leave
choice_b out.  `run_window` takes the same with a leading K axis, and
without draws both draw on the device from the caller's `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.classifier.dataset import make_training_set
from repro_torch.core.classifier.features import (
    CLASS_AWARE,
    CLASS_MULTIQ,
    CLASS_OBLIVIOUS,
    NUM_CLASSES,
    NUM_MODES,
    featurize,
    featurize_t,
)
from repro_torch.core.classifier.inference import (
    PackedTree,
    pack_tree,
    tree_predict,
)
from repro_torch.core.classifier.tree import DecisionTree, train_tree
from repro_torch.core.pqueue import local as L
from repro_torch.core.pqueue import ops as O
from repro_torch.core.pqueue import schedules as SCH
from repro_torch.core.pqueue.ops import OP_DELETE_MIN, OP_INSERT
from repro_torch.core.pqueue.schedules import DeleteResult, Schedule
from repro_torch.core.pqueue.state import (
    INF_KEY,
    PQState,
    invariant_violations,
    leaf_bytes,
    make_state,
    state_fingerprint,
)
from repro_torch.obs import NULL, Observability
from repro_torch.utils.hostsync import host_bool, host_int, resolve_device

MODE_OBLIVIOUS = CLASS_OBLIVIOUS  # 0: base algorithm directly (spray)
MODE_MULTIQ = CLASS_MULTIQ  # 1: relaxed MultiQueue
MODE_AWARE = CLASS_AWARE  # 2: Nuddle delegation (hier)

Tensor = torch.Tensor


class SmartPQStats(NamedTuple):
    """Workload statistics (paper §5); every field int32 on the device."""

    step: Tensor  # ()
    mode: Tensor  # () current algorithmic mode
    n_insert: Tensor  # () ops since the last decision
    n_delete: Tensor  # ()
    min_key: Tensor  # () smallest key requested so far
    max_key: Tensor  # () largest
    transitions: Tensor  # () mode flips
    eliminated: Tensor  # () pairs served by the pre-pass
    rejected: Tensor  # () non-finite keys refused at admission
    mode_steps: Tensor  # (NUM_MODES,) steps spent per mode
    head_refills: Tensor  # () guarded hot-tier refill firings
    ring_deferred: Tensor  # () threaded through unchanged by `step`


class SmartPQCarry(NamedTuple):
    state: PQState
    stats: SmartPQStats


class WindowResult(NamedTuple):
    """Per-step delete outputs of a K-step window."""

    keys: Tensor  # (K, B) ascending per step, INF-padded
    vals: Tensor  # (K, B)
    n_out: Tensor  # (K,)
    mode: Tensor  # (K,) mode after each step


@dataclasses.dataclass(frozen=True)
class SmartPQConfig:
    num_shards: int = 64
    capacity: int = 4096
    head_width: int | None = None  # None -> state.DEFAULT_HEAD_WIDTH
    npods: int = 2
    decision_interval: int = 8  # steps between classifier calls
    # Schedule per mode id — index == classifier class.
    mode_schedules: Tuple[Schedule, ...] = (
        Schedule.SPRAY_HERLIHY,  # MODE_OBLIVIOUS
        Schedule.MULTIQ,  # MODE_MULTIQ
        Schedule.HIER,  # MODE_AWARE
    )
    initial_mode: int = MODE_OBLIVIOUS
    eliminate: bool = True  # elimination/combining pre-pass
    # Runtime guard tier: validated callers (`workloads.traces.replay`) run
    # `validate_carry` after their window and raise its typed
    # `InvariantViolation`.  Off costs nothing; on costs a host copy of the
    # state per validated call.
    validate: bool = False

    def __post_init__(self):
        if len(self.mode_schedules) != NUM_MODES:
            raise ValueError(
                f"mode_schedules must give one Schedule per classifier mode "
                f"({NUM_MODES}); got {len(self.mode_schedules)}"
            )


def _i32(x) -> Tensor:
    return x.to(torch.int32)


class SmartPQ:
    """Adaptive PQ facade: construct once (trains or accepts a tree), then
    drive `step` or `run_window`.  Runs on the card unless `device` names
    another (the tests pass ``device="cpu"``); `obs` is the observability
    bundle whose tracer records the steps (disabled `NULL` by default)."""

    def __init__(self, config: SmartPQConfig = SmartPQConfig(),
                 tree: Optional[DecisionTree] = None, device=None,
                 obs: Optional[Observability] = None):
        self.device = resolve_device(device)
        self.config = config
        self.obs = obs if obs is not None else NULL
        if tree is None:
            X, y = make_training_set()
            tree = train_tree(X, y, NUM_CLASSES, max_depth=8)
        self.tree = tree
        self.packed: PackedTree = pack_tree(tree, self.device)

    # -- lifecycle -----------------------------------------------------------

    def _scalar(self, v: int) -> Tensor:
        return torch.tensor(v, dtype=torch.int32, device=self.device)

    def init(self) -> SmartPQCarry:
        c = self.config
        z = lambda: self._scalar(0)  # noqa: E731
        stats = SmartPQStats(
            step=z(), mode=self._scalar(c.initial_mode), n_insert=z(),
            n_delete=z(), min_key=self._scalar(INF_KEY), max_key=z(),
            transitions=z(), eliminated=z(), rejected=z(),
            mode_steps=torch.zeros((NUM_MODES,), dtype=torch.int32,
                                   device=self.device),
            head_refills=z(), ring_deferred=z(),
        )
        state = make_state(c.num_shards, c.capacity, head_width=c.head_width,
                           device=self.device)
        return SmartPQCarry(state, stats)

    # -- the adaptive step ----------------------------------------------------

    def step(
        self,
        carry: SmartPQCarry,
        ops: Tensor,  # (B,)
        keys: Tensor,  # (B,)
        vals: Tensor,  # (B,)
        draws: Optional[Tuple[Tensor, ...]] = None,
        num_clients: Tensor | int | None = None,
        presorted: Optional[Tuple[Tensor, Tensor]] = None,
        mode_override: Tensor | int | None = None,
        return_features: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """One bulk step: update stats -> (maybe) re-decide the mode ->
        eliminate matched pairs -> insert the rest -> refill the head if
        needed -> deleteMin under the selected mode.  `draws` are this
        step's (shard_choice (B,), hi (S, W)[, choice_b (B,)]); without them
        a random mode draws from `generator`.  `presorted` is `run_window`'s
        sorted insert log row; `mode_override` (-1 = none) pins the mode for
        this step.
        Returns (carry, DeleteResult) and, with `return_features`, the
        step's (4,) float32 classifier features.

        Traced as a ``pq.step`` span (cat ``pq``) holding ``pq.decide``
        (statistics and the decision), ``pq.eliminate``, ``pq.insert``,
        ``pq.refill`` and ``pq.delete_min`` (the mode's read and its
        deleteMin)."""
        with self.obs.tracer.span("pq.step", "pq"):
            return self._step(carry, ops, keys, vals, draws, num_clients,
                              presorted, mode_override, return_features,
                              generator)

    def _step(self, carry, ops, keys, vals, draws, num_clients, presorted,
              mode_override, return_features, generator):
        c = self.config
        tr = self.obs.tracer
        state, stats = carry
        dev = state.device
        B = ops.shape[0]
        if num_clients is None:
            num_clients = c.num_shards
        num_clients = torch.as_tensor(num_clients, dtype=torch.int32,
                                      device=dev)

        with tr.span("pq.decide", "pq"):
            ins_mask = ops == OP_INSERT
            n_rejected = stats.rejected
            if keys.dtype.is_floating_point:
                keys, bad_keys = O.sanitize_keys(keys)
                n_rejected = n_rejected + _i32(torch.sum(bad_keys & ins_mask))
                ins_mask = ins_mask & ~bad_keys
            b_ins = _i32(torch.sum(ins_mask))
            b_del = _i32(torch.sum(ops == OP_DELETE_MIN))

            batch_min = torch.min(torch.where(ins_mask, keys, INF_KEY))
            batch_max = torch.max(torch.where(ins_mask, keys, 0))
            n_insert = stats.n_insert + b_ins
            n_delete = stats.n_delete + b_del
            min_key = torch.minimum(stats.min_key, batch_min)
            max_key = torch.maximum(stats.max_key, batch_max)

            # the decision, on the device
            do_decide = (stats.step % c.decision_interval) == 0
            total_ops = torch.clamp(n_insert + n_delete, min=1)
            key_range = torch.where(min_key <= max_key,
                                    torch.clamp(max_key - min_key, min=1), 1)
            feats = featurize_t(
                num_clients, state.total_size, key_range,
                n_insert.to(torch.float32) / total_ops.to(torch.float32),
            )
            pred = tree_predict(self.packed, feats)
            keep = (~do_decide) | (pred >= NUM_MODES) | (pred < 0)
            new_mode = _i32(torch.where(keep, stats.mode, pred))
            if mode_override is not None:
                ov = torch.as_tensor(mode_override, dtype=torch.int32,
                                     device=dev)
                new_mode = torch.where(ov >= 0, ov, new_mode)
            new_mode = torch.clamp(new_mode, 0, NUM_MODES - 1)
            transitions = stats.transitions + _i32(new_mode != stats.mode)
            n_insert = torch.where(do_decide, 0, n_insert)
            n_delete = torch.where(do_decide, 0, n_delete)

        # -- elimination/combining pre-pass ----------------------------------
        if c.eliminate:
            with tr.span("pq.eliminate", "pq"):
                if presorted is None:
                    presorted = L.sort_op_log(torch.where(ins_mask, keys,
                                                          INF_KEY))
                sk, stg = presorted
                elim_k, elim_v, n_elim, keep_lane = O.elim_split(
                    state, sk, stg, vals, b_del)
                ins_mask = ins_mask & keep_lane
                active = b_del - n_elim
        else:
            n_elim = torch.zeros((), dtype=torch.int32, device=dev)
            active = b_del

        # -- apply the batch under the selected mode -------------------------
        with tr.span("pq.insert", "pq"):
            state, _dropped = O.insert(state, keys, vals, mask=ins_mask)
        with tr.span("pq.refill", "pq"):
            refill = (state.tail_width > 0
                      and host_bool(SCH.head_refill_pred(state, B),
                                    "smartpq.refill"))
            head_refills = stats.head_refills + int(refill)
            state = SCH.ensure_head(state, B, pred=refill)
        total = state.total_size

        with tr.span("pq.delete_min", "pq"):
            schedule = c.mode_schedules[host_int(new_mode, "smartpq.mode")]
            hot, out_k, out_v, n_out = SCH.HOT_SCHEDULE_FNS[schedule](
                SCH.hot_tier(state), total, B, active,
                SCH.schedule_draws(schedule, draws, state.num_shards, B,
                                   state.head_width, generator=generator,
                                   device=dev), c.npods)
            res = DeleteResult(SCH.attach_hot(state, hot), out_k, out_v,
                               n_out)
            if c.eliminate:
                res = O.merge_eliminated(elim_k, elim_v, n_elim, res)

        modes = torch.arange(NUM_MODES, dtype=torch.int32, device=dev)
        new_stats = SmartPQStats(
            step=stats.step + 1,
            mode=new_mode,
            n_insert=n_insert,
            n_delete=n_delete,
            min_key=min_key,
            max_key=max_key,
            transitions=transitions,
            eliminated=stats.eliminated + n_elim,
            rejected=n_rejected,
            mode_steps=stats.mode_steps + _i32(modes == new_mode),
            head_refills=head_refills,
            ring_deferred=stats.ring_deferred,
        )
        out_carry = SmartPQCarry(res.state, new_stats)
        if return_features:
            return out_carry, res, feats
        return out_carry, res

    # -- the window engine ----------------------------------------------------

    def run_window(
        self,
        carry: SmartPQCarry,
        ops: Tensor,  # (K, B)
        keys: Tensor,  # (K, B)
        vals: Tensor,  # (K, B)
        draws: Optional[Tuple[Tensor, ...]] = None,
        num_clients: Tensor | int | None = None,  # scalar or (K,)
        mode_override: Tensor | int | None = None,  # scalar or (K,)
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[SmartPQCarry, WindowResult]:
        """K adaptive steps, equal to K calls of `step` with the same
        draws; only the elimination pre-pass's operation-log sort is hoisted
        in front of the loop, one `elim_sort` launch over the (K, B) log.
        `draws` = (shard_choice (K, B), hi (K, S, W)[, choice_b (K, B)]);
        without them every step's draws come from `generator`, all at once,
        on the device.
        Float key batches are sanitized once up front."""
        c = self.config
        dev = carry.state.device
        K, B = ops.shape
        if num_clients is None:
            num_clients = c.num_shards
        nc = torch.as_tensor(num_clients, dtype=torch.int32,
                             device=dev).expand(K)

        if keys.dtype.is_floating_point:
            keys, bad = O.sanitize_keys(keys)
            n_rej = _i32(torch.sum(bad & (ops == OP_INSERT)))
            carry = carry._replace(stats=carry.stats._replace(
                rejected=carry.stats.rejected + n_rej))

        if c.eliminate:
            sk, stg = L.sort_op_log(torch.where(ops == OP_INSERT, keys,
                                                INF_KEY))
        if draws is None:
            draws = SCH.step_draws(c.mode_schedules, carry.state.num_shards,
                                   B, carry.state.head_width, steps=K,
                                   generator=generator, device=dev)
        ovs = None
        if mode_override is not None:
            ovs = torch.as_tensor(mode_override, dtype=torch.int32,
                                  device=dev).expand(K)

        out_k, out_v, out_n, out_m = [], [], [], []
        for t in range(K):
            carry, res = self.step(
                carry, ops[t], keys[t], vals[t],
                draws=None if draws is None else tuple(d[t] for d in draws),
                num_clients=nc[t],
                presorted=(sk[t], stg[t]) if c.eliminate else None,
                mode_override=None if ovs is None else ovs[t],
            )
            out_k.append(res.keys)
            out_v.append(res.vals)
            out_n.append(res.n_out)
            out_m.append(carry.stats.mode)
        return carry, WindowResult(torch.stack(out_k), torch.stack(out_v),
                                   torch.stack(out_n), torch.stack(out_m))

    # -- the runtime guard tier -----------------------------------------------

    def validate_carry(self, carry: SmartPQCarry) -> None:
        """Run the host-side invariant checker over the carry's state and
        raise the first `InvariantViolation` found."""
        viols = invariant_violations(carry.state, first_only=True)
        if viols:
            raise viols[0]

    # -- host-dispatch variant ------------------------------------------------

    def make_mode_steps(self):
        """One step function per mode, all on the same state layout, so a
        host that picks the mode itself flips modes between calls with no
        copy (src/repro/core/smartpq.py:471-507).  Each takes
        (state, ops, keys, vals, draws=None, generator=None) with `draws` as
        in `step`, runs the elimination pre-pass, the insert and its mode's
        deleteMin, and returns the `DeleteResult`.  No decision, no stats."""
        c = self.config

        def _mk(schedule: Schedule):
            delete = SCH.SCHEDULE_FNS[schedule]

            def mode_step(state: PQState, ops, keys, vals, draws=None,
                          generator=None) -> DeleteResult:
                B = ops.shape[0]
                ins_mask = ops == OP_INSERT
                b_del = _i32(torch.sum(ops == OP_DELETE_MIN))
                active = b_del
                if c.eliminate:
                    sk, stg = L.sort_op_log(torch.where(ins_mask, keys,
                                                        INF_KEY))
                    elim_k, elim_v, n_elim, keep_lane = O.elim_split(
                        state, sk, stg, vals, b_del)
                    ins_mask = ins_mask & keep_lane
                    active = b_del - n_elim
                st, _ = O.insert(state, keys, vals, mask=ins_mask)
                res = delete(st, B, active, SCH.schedule_draws(
                    schedule, draws, st.num_shards, B, st.head_width,
                    generator=generator, device=st.device), c.npods)
                if c.eliminate:
                    res = O.merge_eliminated(elim_k, elim_v, n_elim, res)
                return res

            return mode_step

        return {mode: _mk(s) for mode, s in enumerate(c.mode_schedules)}

    def predict_mode_host(self, num_clients: int, size: int, key_range: int,
                          insert_frac: float) -> int:
        """The tree's class for one feature point, on the host (offline and
        debugging use; `step` decides on the device)."""
        return int(self.tree.predict(
            featurize(num_clients, size, key_range, insert_frac))[0])


def carry_fingerprint(carry: SmartPQCarry) -> int:
    """CRC32 over the whole carry — `state_fingerprint` chained with every
    stats field — equal to the reference's for a bit-identical carry.  The
    leaves may be tensors or numpy arrays (`persist.host_tree` of a
    carry)."""
    crc = state_fingerprint(carry.state)
    for name, leaf in zip(SmartPQStats._fields, carry.stats):
        crc = zlib.crc32(leaf_bytes(leaf), zlib.crc32(name.encode(), crc))
    return crc & 0xFFFFFFFF
