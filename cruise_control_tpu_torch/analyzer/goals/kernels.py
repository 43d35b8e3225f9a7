"""Vectorized goal semantics, and K3.

Counterpart of ``cruise_control_tpu/analyzer/goals/kernels.py`` for every
goal kind: the default stack's (``rack``, ``replica_capacity``,
``capacity``, ``replica_distribution``, ``potential_nw_out``,
``resource_distribution``, ``topic_replica_distribution``,
``leader_replica_distribution``, ``leader_bytes_in``),
``rack_distribution``, ``preferred_leader`` and ``min_topic_leaders``,
kafka-assigner mode included, and the intra-broker disk kinds
(``intra_disk_capacity``, ``intra_disk_distribution``: each disk of a JBOD
broker against its band, ``_disk_limits``).

- ``broker_metric`` / ``limits`` / ``violated_brokers`` — per-broker balance
  quantity and its [lower, upper] band.
- ``self_feasible`` — may this goal apply a candidate while optimizing
  itself.
- ``accepts`` — would this already-optimized goal veto the candidate.
- ``score`` — improvement the candidate brings (> 0 required to apply).
- ``source_pressure`` / ``dest_room`` / ``source_replica_relevance`` —
  candidate-generation rankings; ``_within_group_rank`` ranks the source
  replicas within their broker or (topic, broker) pair (K6 group rank,
  ``csrc/group_rank.cu``), with the plain twin ``within_group_rank_plain``.
- ``goal_masks`` — per-candidate score and eligibility in one pass (K5,
  ``csrc/goal_masks.cu``), with the plain twin ``goal_masks_plain``.
- ``stack_satisfied`` — every goal's satisfied flag and the offline flag in
  one pass (K9 sweep, ``csrc/stack_sweep.cu``), with the plain twin
  ``stack_satisfied_plain``.
- ``structural_accepts`` — the vetoes of structural previous goals (K5b,
  ``csrc/goal_masks.cu``), with the plain twin ``structural_accepts_plain``.
- ``frontier_inputs`` / ``frontier_mask`` — the band goal's active broker
  set (the JAX package's ``frontier_active``; K9 frontier,
  ``csrc/frontier_active.cu``), with the plain twin ``frontier_mask_plain``.
- ``frontier_inputs_batch`` / ``frontier_active_batch`` — every goal's
  active set of a stack in one launch, all-false rows for the goals that
  are not of a band kind (K9 batch, same source), with the plain twin
  ``frontier_active_batch_plain``.
- ``prefix_cut_admit`` / ``prefix_admit_safe`` — the bounded repair (K3,
  ``csrc/prefix_cut.cu``: one score sort by ``cc_argsort``, the counting pass,
  running totals rebuilt where they are tested), with the plain twin
  ``prefix_cut_admit_plain``.
- ``accepts_band_batch`` — the band goals' ``accepts`` ANDed over a stack
  (the optimizer's ``_DBG_NO_BUDGETS`` ablation; ``csrc/band_accepts.cu``),
  with the plain twin ``accepts_band_batch_plain``.
- ``blend_aggregates`` / ``stack_sweep_batch`` — every goal's satisfied
  flag for a batch of blends of two placements, as the executor's
  balancedness scorer asks for it (K10, ``csrc/placement_score.cu``), with
  the plain twins ``blend_aggregates_plain`` and ``stack_sweep_batch_plain``;
  ``blend_row_index`` is the per-segment row index their kernels walk.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.actions import Candidates
from cruise_control_tpu_torch.analyzer.balancing_constraint import (BALANCE_MARGIN,
                                                                    BalancingConstraint)
from cruise_control_tpu_torch.analyzer.goals.specs import GoalSpec
from cruise_control_tpu_torch.analyzer.state import (INTRA_DISK_KINDS, BrokerArrays,
                                                     disk_loads, disk_means,
                                                     disk_sum_per_broker, topic_counts,
                                                     topic_leaders)
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.tensor_model import BrokerState, TensorClusterModel
from cruise_control_tpu_torch.ops import cuda, order
from cruise_control_tpu_torch.ops import segment as sg
from cruise_control_tpu_torch.ops.segment import masked_segment_count, masked_segment_sum

_BIG = 1e30
_OFFLINE_BONUS = 1e12  # healing moves (offline replicas off dead brokers) dominate
MIN_SCORE = 1e-9  # strictly-positive improvement required (greedy accept)

SUPPORTED_KINDS = ("rack", "replica_capacity", "capacity", "replica_distribution",
                   "potential_nw_out", "resource_distribution",
                   "topic_replica_distribution", "leader_replica_distribution",
                   "leader_bytes_in", "rack_distribution", "preferred_leader",
                   "min_topic_leaders") + INTRA_DISK_KINDS

_BAND_KINDS = ("capacity", "resource_distribution", "replica_capacity",
               "replica_distribution", "leader_replica_distribution",
               "potential_nw_out", "leader_bytes_in")


def require_supported(spec: GoalSpec) -> None:
    if spec.kind not in SUPPORTED_KINDS:
        raise NotImplementedError(
            f"goal kind {spec.kind!r} ({spec.name}) is not ported yet")


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """f32 scalar on ``like``'s device, made by a fill (no host-to-device
    copy, so it can be recorded in a CUDA graph)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once, as a fused multiply-add
    (CUDA's ``__fmaf_rn``).  The product is exact in float64; the float64
    sum is taken with round-to-odd (the TwoSum error picks the odd
    neighbour), which makes the final rounding to f32 correct."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sq_sum(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x ** 2 + y ** 2`` as the JAX package's jitted CPU program computes
    it: XLA's CPU code generator contracts the first square into an FMA,
    ``fma(x, x, y * y)`` (the optimized HLO keeps multiply + add in one
    loop fusion; LLVM fuses them).  Bit-identical to the jitted scores of
    every squared-deviation kind at XLA's default backend optimization
    level, the one the service and bench.py run."""
    return fma_f32(x, x, y * y)


def _margin_pct(threshold: float) -> float:
    return (threshold - 1.0) * BALANCE_MARGIN + 1.0


def is_band_kind(spec: GoalSpec) -> bool:
    return spec.kind in _BAND_KINDS


# ---------------------------------------------------------------------------
# Per-broker metric and limits
# ---------------------------------------------------------------------------

def broker_metric(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                  constraint: BalancingConstraint) -> torch.Tensor:
    """f32[B] — the quantity the goal balances / caps."""
    kind = spec.kind
    if kind in ("capacity", "resource_distribution"):
        return arrays.load[:, spec.resource]
    if kind in ("replica_capacity", "replica_distribution"):
        return arrays.replica_count.to(torch.float32)
    if kind == "leader_replica_distribution":
        return arrays.leader_count.to(torch.float32)
    if kind == "potential_nw_out":
        return arrays.potential_nw_out
    if kind == "leader_bytes_in":
        return arrays.leader_bytes_in
    if kind in ("rack", "rack_distribution"):
        conflict = _replica_rack_conflict(spec, model)
        return masked_segment_count(model.replica_broker, model.num_brokers,
                                    model.replica_valid & conflict).to(torch.float32)
    if kind == "topic_replica_distribution":
        tbc = topic_counts(model, arrays).to(torch.float32)
        lower_t, upper_t = _topic_limits(model, arrays, constraint)
        excess = torch.clamp(tbc - upper_t[:, None], min=0.0) + \
            torch.clamp(lower_t[:, None] - tbc, min=0.0)
        return excess.sum(dim=0)
    if kind == "preferred_leader":
        # Wrongly-led partitions whose current leader sits on the broker.
        return masked_segment_count(model.replica_broker, model.num_brokers,
                                    _wrong_leader_mask(model)).to(torch.float32)
    if kind == "min_topic_leaders":
        return _min_topic_leader_shortfall(model, arrays, constraint)
    if kind in INTRA_DISK_KINDS:
        # Per broker: the total excess of its disks over their bands, and
        # everything still on a dead disk (capacity < 0), so the hard goal
        # never reads satisfied while replicas are stranded there.
        disk_load = disk_loads(model, arrays)
        lo_d, up_d = _disk_limits(spec, model, constraint, disk_load, arrays)
        excess = torch.clamp(disk_load - up_d, min=0.0) + torch.clamp(lo_d - disk_load, min=0.0)
        excess = torch.where(model.disk_capacity < 0.0, disk_load, excess)
        excess = torch.where(model.disk_valid, excess, torch.zeros_like(excess))
        return disk_sum_per_broker(excess, model, model.disk_valid)
    raise NotImplementedError(f"goal kind {kind}")


def _disk_limits(spec: GoalSpec, model: TensorClusterModel,
                 constraint: BalancingConstraint, disk_load: torch.Tensor,
                 arrays: Optional[BrokerArrays] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower f32[D], upper f32[D]) bands on the disk axis
    (``goals/kernels.py:147-171``): ``intra_disk_capacity`` caps each disk at
    capacity x threshold; ``intra_disk_distribution`` keeps each disk within
    the DISK balance percentage of its broker's mean utilization (the
    broker's load over its live disks' capacity; ``arrays``' once per step
    when present).  Dead disks (capacity < 0) take no part in the mean."""
    cap = model.disk_capacity.clamp(min=1e-9)
    if spec.kind == "intra_disk_capacity":
        upper = cap * constraint.capacity_threshold[Resource.DISK]
        return torch.zeros_like(upper), upper
    avg_pct = disk_means(model, arrays, disk_load)
    bp = constraint.balance_percentage(Resource.DISK)
    return avg_pct * (2.0 - bp) * cap, avg_pct * bp * cap


def _wrong_leader_mask(model: TensorClusterModel) -> torch.Tensor:
    """bool[R] — the replica leads a partition whose preferred replica is a
    different, online, non-demoted replica, or leads from a DEMOTED broker
    (the demote path).  Pad partitions (preferred -1) read replica 0 behind
    the ``preferred >= 0`` guard."""
    preferred = model.preferred_leader_replica()[model.replica_partition]
    r_idx = torch.arange(model.num_replicas_padded, dtype=torch.int32, device=model.device)
    safe_pref = torch.clamp(preferred, min=0)
    pref_broker = model.replica_broker[safe_pref]
    pref_ok = (model.replica_valid[safe_pref]
               & ~model.replica_offline_now()[safe_pref]
               & (model.broker_state[pref_broker] != BrokerState.DEMOTED)
               & (preferred >= 0))
    on_demoted = model.broker_state[model.replica_broker] == BrokerState.DEMOTED
    return (model.replica_is_leader & model.replica_valid
            & (((preferred != r_idx) & pref_ok) | on_demoted))


# Never evicted: the captured step graphs read these tensors by address, so
# they must outlive every graph (a freed block would be reused under them).
@functools.lru_cache(maxsize=None)
def _designated_table(num_topics: int, ids: Tuple[int, ...],
                      device: torch.device) -> torch.Tensor:
    """bool[T] with the listed topic ids set, uploaded once per (topics,
    ids, device).  Ids at or past ``num_topics`` are dropped and negative
    ones count from the end, as the JAX package's scatter takes them."""
    mask = np.zeros((num_topics,), dtype=bool)
    for t in ids:
        if t < num_topics and t >= -num_topics:
            mask[t] = True
    return torch.from_numpy(mask).to(device)


def _designated_topic_mask(model: TensorClusterModel,
                           constraint: BalancingConstraint) -> torch.Tensor:
    """bool[T] — topics designated for min-leader enforcement (the
    constraint's config-static ``min_leader_topic_ids``)."""
    return _designated_table(model.num_topics, tuple(constraint.min_leader_topic_ids),
                             model.device)


def _min_topic_leader_shortfall(model: TensorClusterModel, arrays: BrokerArrays,
                                constraint: BalancingConstraint) -> torch.Tensor:
    """f32[B] — sum over designated topics of max(0, min - leaders(t, b))
    for alive brokers (an integer-valued sum, so exact in any order)."""
    tlc = topic_leaders(model, arrays).to(torch.float32)
    need = float(constraint.min_topic_leaders_per_broker)
    designated = _designated_topic_mask(model, constraint)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=tlc.device)
    shortfall = torch.where(designated, torch.clamp(need - tlc, min=0.0), zero).sum(dim=0)
    return torch.where(arrays.alive, shortfall, zero)


def limits(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
           constraint: BalancingConstraint):
    """(lower f32[B], upper f32[B]) band for the goal metric."""
    kind = spec.kind
    B = arrays.load.shape[0]
    dev = arrays.load.device
    zero = torch.zeros((B,), dtype=torch.float32, device=dev)
    if kind == "capacity":
        upper = arrays.capacity[:, spec.resource] * constraint.capacity_threshold[spec.resource]
        return zero, upper
    if kind == "potential_nw_out":
        upper = arrays.capacity[:, Resource.NW_OUT] * \
            constraint.capacity_threshold[Resource.NW_OUT]
        return zero, upper
    if kind == "replica_capacity":
        return zero, torch.full((B,), float(constraint.max_replicas_per_broker),
                                dtype=torch.float32, device=dev)
    if kind == "resource_distribution":
        res = spec.resource
        bp = constraint.balance_percentage(res)
        total_util = order.ordered_sum(torch.where(arrays.alive, arrays.load[:, res], 0.0))
        total_cap = order.ordered_sum(
            torch.where(arrays.alive, arrays.capacity[:, res], 0.0)).clamp(min=1e-9)
        avg_pct = total_util / total_cap
        low = constraint.low_utilization_threshold[res]
        gated = avg_pct <= low
        upper = torch.where(gated, _f32(_BIG, zero), avg_pct * bp * arrays.capacity[:, res])
        lower = torch.where(gated, zero, avg_pct * (2.0 - bp) * arrays.capacity[:, res])
        return lower.clamp(min=0.0), upper
    if kind == "replica_distribution":
        bp = _margin_pct(constraint.replica_count_balance_threshold)
        avg = torch.where(arrays.alive, arrays.replica_count, 0).sum().to(torch.float32) \
            / arrays.num_alive.to(torch.float32)
        return torch.floor(avg * (2.0 - bp)).expand(B), torch.ceil(avg * bp).expand(B)
    if kind == "leader_replica_distribution":
        bp = _margin_pct(constraint.leader_replica_count_balance_threshold)
        avg = torch.where(arrays.alive, arrays.leader_count, 0).sum().to(torch.float32) \
            / arrays.num_alive.to(torch.float32)
        return torch.floor(avg * (2.0 - bp)).expand(B), torch.ceil(avg * bp).expand(B)
    if kind == "leader_bytes_in":
        bp = _margin_pct(constraint.resource_balance_threshold[Resource.NW_IN])
        avg = order.ordered_sum(torch.where(arrays.alive, arrays.leader_bytes_in, 0.0)) \
            / arrays.num_alive.to(torch.float32)
        return zero, (avg * bp).expand(B)
    if kind in ("rack", "rack_distribution", "topic_replica_distribution",
                "preferred_leader", "min_topic_leaders") + INTRA_DISK_KINDS:
        return zero, zero
    raise NotImplementedError(f"goal kind {kind}")


def violated_brokers(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                     constraint: BalancingConstraint) -> torch.Tensor:
    """bool[B] brokers violating the goal (incl. dead brokers still hosting
    replicas, for hard goals)."""
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = limits(spec, model, arrays, constraint)
    eps = _metric_epsilon(spec)
    out_of_band = (metric > upper + eps) | (metric < lower - eps)
    dead_with_replicas = (~arrays.alive) & arrays.valid & (arrays.replica_count > 0)
    if spec.is_hard:
        return (arrays.alive & out_of_band) | dead_with_replicas
    return arrays.alive & out_of_band


def goal_satisfied(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                   constraint: BalancingConstraint) -> torch.Tensor:
    """bool scalar tensor (no host sync)."""
    return ~violated_brokers(spec, model, arrays, constraint).any()


# K9 sweep goal kinds (the ``kind`` column of the parameter table).
_SWEEP_KINDS = ("capacity", "potential_nw_out", "replica_capacity",
                "resource_distribution", "replica_distribution",
                "leader_replica_distribution", "leader_bytes_in", "rack",
                "topic_replica_distribution", "rack_distribution", "preferred_leader",
                "min_topic_leaders") + INTRA_DISK_KINDS
_SWEEP_COUNTS = cuda.mode_counters("stack_sweep", _SWEEP_KINDS)
_BATCH_SWEEP_COUNTS = cuda.mode_counters("stack_sweep_batch", _SWEEP_KINDS)


def _sweep_params(spec: GoalSpec, constraint: BalancingConstraint):
    """(i32 [kind, resource, is_hard], f32 [eps, a, b, c]) of one goal: the
    constants ``limits`` and ``violated_brokers`` use, as float32 (torch
    converts a Python scalar to the tensor's float32 before the op)."""
    kind = spec.kind
    res = spec.resource
    a = b = c = 0.0
    if kind == "capacity":
        a = constraint.capacity_threshold[res]
    elif kind == "potential_nw_out":
        res = Resource.NW_OUT
        a = constraint.capacity_threshold[res]
    elif kind == "replica_capacity":
        a = float(constraint.max_replicas_per_broker)
    elif kind == "resource_distribution":
        bp = constraint.balance_percentage(res)
        a, b, c = bp, 2.0 - bp, constraint.low_utilization_threshold[res]
    elif kind in ("replica_distribution", "leader_replica_distribution"):
        bp = _margin_pct(constraint.replica_count_balance_threshold
                         if kind == "replica_distribution"
                         else constraint.leader_replica_count_balance_threshold)
        a, b = bp, 2.0 - bp
    elif kind == "leader_bytes_in":
        a = _margin_pct(constraint.resource_balance_threshold[Resource.NW_IN])
    elif kind == "topic_replica_distribution":
        bp = _margin_pct(constraint.topic_replica_count_balance_threshold)
        a, b = bp, 2.0 - bp
    elif kind == "min_topic_leaders":
        a = float(constraint.min_topic_leaders_per_broker)
    elif kind == "intra_disk_capacity":
        a = constraint.capacity_threshold[Resource.DISK]
    elif kind == "intra_disk_distribution":
        bp = constraint.balance_percentage(Resource.DISK)
        a, b = bp, 2.0 - bp
    ints = [_SWEEP_KINDS.index(kind), max(int(res), 0), int(spec.is_hard)]
    return ints, [_metric_epsilon(spec), a, b, c]


# Never evicted: the captured step graphs read these tensors by address, so
# they must outlive every graph (a freed block would be reused under them).
@functools.lru_cache(maxsize=None)
def _sweep_table(specs, constraint: BalancingConstraint, device: torch.device):
    """The K9 parameter table of ``specs`` on ``device``, uploaded once per
    (stack, constraint)."""
    rows = [_sweep_params(s, constraint) for s in specs]
    ints = torch.tensor([r[0] for r in rows], dtype=torch.int32).reshape(-1, 3)
    floats = torch.tensor([r[1] for r in rows], dtype=torch.float32).reshape(-1, 4)
    return ints.to(device), floats.to(device)


def stack_satisfied_plain(specs, model: TensorClusterModel, arrays: BrokerArrays,
                          constraint: BalancingConstraint):
    """(bool[G] every goal's ``goal_satisfied``, bool[1] offline replicas
    remain) — the JAX package's ``_stack_satisfied``
    (``optimizer.py:2332-2337``)."""
    dev = arrays.load.device
    sat = torch.stack([goal_satisfied(s, model, arrays, constraint) for s in specs]) \
        if specs else torch.zeros((0,), dtype=torch.bool, device=dev)
    off = (model.replica_offline_now() & model.replica_valid).any().reshape(1)
    return sat, off


# Goal kinds K9's sweep spreads over the replica axis and over the (topic,
# broker) cells; every other kind takes one block on the broker axis.
_REPLICA_AXIS_KINDS = ("rack", "rack_distribution", "preferred_leader")
_TOPIC_AXIS_KINDS = ("topic_replica_distribution", "min_topic_leaders")


@functools.lru_cache(maxsize=None)
def _sweep_axes(specs) -> Tuple[int, int]:
    """(goals of a replica-axis kind, goals of a (topic, broker) kind) of
    ``specs``: with the kinds in the parameter table they give K9's sweep
    its launch shape."""
    kinds = [s.kind for s in specs]
    return (sum(k in _REPLICA_AXIS_KINDS for k in kinds),
            sum(k in _TOPIC_AXIS_KINDS for k in kinds))


@cuda.counted("stack_sweep")
def stack_satisfied(specs, model: TensorClusterModel, arrays: BrokerArrays,
                    constraint: BalancingConstraint):
    """K9, sweep.  Replaces ``cruise_control_tpu/analyzer/optimizer.py:2332``
    ``_stack_satisfied`` (``goals/kernels.py:237`` ``goal_satisfied`` of G
    goals, plus ``any_offline``): ``(sat bool[G], any_offline bool[1])``.
    With G = 1 it gives a chunk's satisfied-at-entry and -exit flags.
    Bound on the card: bytes (the broker rows once per goal; the rack
    goals' replica and sibling rows; the preferred-leader goal's leader,
    preferred-replica and broker-state rows; the topic goal's [T, B]
    counts, the min-leaders goal's [T, B] leader counts; each replica's
    broker, disk, reported-offline flag and original broker once).  CPU
    tensors take ``stack_satisfied_plain``; CUDA tensors launch one kernel
    spread over the grid by axis, with a parameter table of (kind,
    resource, is_hard, epsilon, thresholds): a band or disk goal takes one
    block that reduces its alive sums in a fixed order and tests every
    broker against its band (the intra-broker disk goals walk each
    broker's disks in disk order); the rack, rack-distribution and
    preferred-leader goals take tiles of the replicas (a replica's siblings
    against "no sibling on the rack" or the ceil(rf / racks) quota; every
    leader); the topic goals take a warp a topic; the offline flag takes
    tiles of the replicas, each replica's ``replica_offline_now`` computed
    in the kernel.  Exact booleans."""
    specs = tuple(specs)
    for s in specs:
        require_supported(s)
    dev = arrays.load.device
    cuda.record("stack_sweep", (specs, model, arrays, constraint))
    if cuda.on_cpu(arrays.load):
        return stack_satisfied_plain(specs, model, arrays, constraint)
    G = len(specs)
    flags = torch.empty((G + 1,), dtype=torch.bool, device=dev)
    sat, off = flags[:G], flags[G:]
    stack_sweep_launch(specs, model, arrays, constraint, sat, off)
    stack_satisfied.launches += 1
    for kind in {s.kind for s in specs}:
        _SWEEP_COUNTS[kind].launches += 1
    return sat, off


def stack_sweep_launch(specs, model: TensorClusterModel, arrays: BrokerArrays,
                       constraint: BalancingConstraint, sat: torch.Tensor,
                       off: torch.Tensor) -> None:
    """K9's sweep of ``specs`` (a tuple) into ``sat`` (bool[G]) and ``off``
    (bool[1]) on CUDA tensors: ``stack_satisfied``'s launch, uncounted."""
    dev = arrays.load.device
    ints, floats = _sweep_table(specs, constraint, dev)
    tables = _sweep_tables(specs, model, arrays, constraint)
    disk_load = (disk_loads(model, arrays)
                 if any(s.kind in INTRA_DISK_KINDS for s in specs) else None)
    cuda.launch("stack_sweep", len(specs), model.num_brokers, model.num_replicas_padded,
                model.num_topics, model.max_rf, model.num_racks, *_sweep_axes(specs), ints,
                floats, arrays.alive, arrays.valid, arrays.replica_count, arrays.leader_count,
                arrays.load.contiguous(), arrays.capacity.contiguous(),
                arrays.potential_nw_out.contiguous(), arrays.leader_bytes_in.contiguous(),
                arrays.num_alive.reshape(1), *tables, model.replica_broker,
                model.replica_valid, model.replica_partition, model.partition_replicas,
                model.broker_rack, model.broker_state, model.replica_is_leader,
                model.replica_disk, model.replica_offline, model.replica_original_broker,
                sat, off, *_disk_rows(model), disk_load)


def _sweep_tables(specs, model: TensorClusterModel, arrays: BrokerArrays,
                  constraint: BalancingConstraint):
    """(topic counts i32[T, B], topic leader counts i32[T, B], designated
    bool[T], replication factors i32[P]) as K9's sweep reads them, each
    None unless a goal of ``specs`` reads it."""
    kinds = {s.kind for s in specs}
    leaders = "min_topic_leaders" in kinds
    return (topic_counts(model, arrays).contiguous()
            if "topic_replica_distribution" in kinds else None,
            topic_leaders(model, arrays).contiguous() if leaders else None,
            _designated_topic_mask(model, constraint) if leaders else None,
            model.partition_replication_factor() if "rack_distribution" in kinds else None)


def _disk_rows(model: TensorClusterModel):
    """(num_disks, max disks per broker, disk_capacity, disk_valid,
    broker_disks): the disk axis as K9's intra-disk kinds walk it, each
    broker's disks in increasing disk order."""
    return (model.num_disks, model.broker_disks.shape[1], model.disk_capacity,
            model.disk_valid, model.broker_disks.contiguous())


# ---------------------------------------------------------------------------
# K10: the goal stack's satisfied flags for a batch of placement blends
# ---------------------------------------------------------------------------

# (load f32[C, B, 4], replica_count i32[C, B], leader_count i32[C, B],
# potential_nw_out f32[C, B], leader_bytes_in f32[C, B], topic counts
# i32[C, T, B] or None, topic leader counts i32[C, T, B] or None, disk
# loads f32[C, D] or None) — BrokerArrays' aggregates of C blends.
BlendAggregates = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
                        Optional[torch.Tensor]]


def blend_placement(before: TensorClusterModel, after: TensorClusterModel,
                    mask: torch.Tensor) -> TensorClusterModel:
    """``before`` with the replicas of the partitions set in ``mask``
    (bool[P]) at ``after``'s broker, leadership and disk
    (``optimizer.py:2398-2406``).  The partition index is clamped into
    range, as the JAX package's gather clamps."""
    rmask = mask[before.replica_partition.clamp(0, mask.shape[0] - 1).long()]
    return before.with_placement(
        torch.where(rmask, after.replica_broker, before.replica_broker),
        torch.where(rmask, after.replica_is_leader, before.replica_is_leader),
        torch.where(rmask, after.replica_disk, before.replica_disk))


def _blend_arrays(before: TensorClusterModel, aggs: BlendAggregates, c: int) -> BrokerArrays:
    """BrokerArrays of blend ``c`` from its slice of the batched aggregates
    (liveness, capacity and validity are the broker axis's, which a blend
    leaves as they are)."""
    load, rc, lc, pnw, lbi, tbc, tlc, dl = aggs
    alive = before.alive_broker_mask()
    return BrokerArrays(load=load[c], replica_count=rc[c], leader_count=lc[c],
                        potential_nw_out=pnw[c], leader_bytes_in=lbi[c], alive=alive,
                        capacity=before.broker_capacity, valid=before.broker_valid,
                        num_alive=alive.sum().clamp(min=1).to(torch.int32),
                        topic_counts=None if tbc is None else tbc[c],
                        topic_leader_counts=None if tlc is None else tlc[c],
                        disk_load=None if dl is None else dl[c])


def blend_aggregates_plain(before: TensorClusterModel, after: TensorClusterModel,
                           masks: torch.Tensor, with_topic_counts: bool,
                           with_topic_leaders: bool = False,
                           with_disk_load: bool = False) -> BlendAggregates:
    """K10's aggregates, one blend at a time: ``BrokerArrays.from_model`` of
    each blend, stacked."""
    rows = [BrokerArrays.from_model(blend_placement(before, after, m), with_topic_counts,
                                    with_topic_leaders, with_disk_load)
            for m in masks]
    stack = [torch.stack([getattr(a, f) for a in rows])
             for f in ("load", "replica_count", "leader_count", "potential_nw_out",
                       "leader_bytes_in")]
    tbc = torch.stack([a.topic_counts for a in rows]) if with_topic_counts else None
    tlc = torch.stack([a.topic_leader_counts for a in rows]) if with_topic_leaders else None
    dl = torch.stack([a.disk_load for a in rows]) if with_disk_load else None
    return (*stack, tbc, tlc, dl)


def _check_blend_inputs(before: TensorClusterModel, after: TensorClusterModel,
                        masks: torch.Tensor) -> None:
    dev = before.device
    R, P = before.num_replicas_padded, before.num_partitions
    cuda.check(masks, "masks", torch.bool, (masks.shape[0], P), dev)
    for f, dtype in (("replica_broker", torch.int32), ("replica_is_leader", torch.bool),
                     ("replica_disk", torch.int32)):
        cuda.check(getattr(before, f), f"before.{f}", dtype, (R,), dev)
        cuda.check(getattr(after, f), f"after.{f}", dtype, (R,), dev)
    if P < 1:
        raise ValueError("placement blends need at least one partition")


def blend_row_index(seg_before: torch.Tensor, seg_after: Optional[torch.Tensor],
                    valid: torch.Tensor, num_segments: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows each segment (broker, disk or topic) can hold in any blend
    of two placements, as a CSR: ``(offsets i32[S + 1], rows i32[N])``.
    The rows of segment s, ``rows[offsets[s]:offsets[s + 1]]``, are every
    valid row whose before-segment is s and every valid row whose
    after-segment is s and differs from its before-segment (none when
    ``seg_after`` is None), in increasing row order; ``rows`` may run on
    past ``offsets[S]``.  Segments outside [0, S) hold no row.  On the CPU
    one sort of the keys ``segment * R + row`` (int32 where they fit); on
    the card a kernel writes each row's segments as int32 keys interleaved
    by row ([R, 2], a row outside every segment keyed S), K6's stable
    ``cc_argsort`` (``num_keys = S + 1``) orders them, so each segment's
    rows stay in increasing row order, and a kernel turns the sorted keys
    and their positions into the CSR, with no host sync.  It orders row ids
    only and computes no part of K10's sums."""
    R, S, dev = seg_before.shape[0], num_segments, seg_before.device
    if 2 * R >= 2 ** 31:
        raise ValueError(f"{R} rows: the row index holds at most 2**30 - 1")
    if R == 0:
        return (torch.zeros(S + 1, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    if not cuda.on_cpu(seg_before):
        n = R if seg_after is None else 2 * R
        keys = torch.empty(n, dtype=torch.int32, device=dev)
        cuda.launch("blend_index_keys", R, S, seg_before, seg_after, valid, keys)
        sorted_keys = torch.empty(n, dtype=torch.int32, device=dev)
        rows = torch.empty(n, dtype=torch.int32, device=dev)
        words = order.argsort_work_words(n)
        work = torch.empty(words, dtype=torch.int32, device=dev) if words else None
        order.argsort_into(keys, S + 1, None, work, out_idx32=rows, out_keys=sorted_keys)
        offsets = torch.empty(S + 1, dtype=torch.int32, device=dev)
        cuda.launch("blend_index_offsets", n, S, int(seg_after is not None), sorted_keys,
                    offsets, rows)
        return offsets, rows
    kd = torch.int32 if (S + 1) * R < 2 ** 31 else torch.int64
    segs = (seg_before[None] if seg_after is None
            else torch.stack([seg_before, seg_after])).to(kd)
    held = valid & (segs >= 0) & (segs < S)
    if seg_after is not None:
        held[1] &= segs[1] != segs[0]
    # A row outside every segment gets a key past the last: sorted to the end.
    keys = (torch.where(held, segs, S) * R
            + torch.arange(R, dtype=kd, device=dev)).reshape(-1).sort().values
    offsets = torch.searchsorted(keys, torch.arange(S + 1, dtype=kd, device=dev) * R)
    return offsets.to(torch.int32), (keys % R).to(torch.int32)


def masks_by_partition(masks: torch.Tensor) -> torch.Tensor:
    """bool[P, C'], the landed masks transposed, C' = C rounded up to a
    multiple of 8 and the columns past C false: the blend kernels read a
    partition's flags for up to 8 consecutive blends as one aligned word.
    On the card a tiled transpose (``cc_masks_by_partition``), a step of
    the blend wrappers' launches."""
    C, P = masks.shape
    cp = -(-C // 8) * 8
    if cuda.on_cpu(masks):
        out = torch.zeros((P, cp), dtype=torch.bool)
        out[:, :C] = masks.t()
        return out
    out = torch.empty((P, cp), dtype=torch.bool, device=masks.device)
    cuda.launch("masks_by_partition", C, P, masks, out)
    return out


def blend_indexes(before: TensorClusterModel, after: TensorClusterModel,
                  masks: torch.Tensor, disks: bool = False, topics: bool = False):
    """What a blend kernel walks besides the models, built per call: the
    masks by partition, the per-broker (``disks``: per-disk) row index and,
    with ``topics``, the per-topic row index (each topic's valid rows in row
    order) or None."""
    seg, num = (("replica_disk", before.num_disks) if disks
                else ("replica_broker", before.num_brokers))
    index = blend_row_index(getattr(before, seg), getattr(after, seg), before.replica_valid,
                            num)
    by_topic = blend_row_index(before.replica_topic, None, before.replica_valid,
                               before.num_topics) if topics else None
    return masks_by_partition(masks), index, by_topic


# The disk loads of the blends: a second launch of K10's aggregates, counted
# as ``blend_aggregates[disk]``.
_BLEND_DISK_COUNTS = cuda.mode_counters("blend_aggregates", ("disk",))


@cuda.counted("blend_aggregates")
def blend_aggregates(before: TensorClusterModel, after: TensorClusterModel,
                     masks: torch.Tensor, with_topic_counts: bool,
                     out: Optional[BlendAggregates] = None,
                     with_topic_leaders: bool = False,
                     with_disk_load: bool = False) -> BlendAggregates:
    """K10, aggregates.  Replaces the ``BrokerArrays.from_model`` of every
    blend that ``cruise_control_tpu/analyzer/optimizer.py:2392``
    ``_get_placement_score_fn`` maps over its masks: each blend's per-broker
    sums, its (topic, broker) replica counts when ``with_topic_counts`` and
    its (topic, broker) leader counts when ``with_topic_leaders`` and its
    disk loads when ``with_disk_load``.  Bound on the card: bytes (the
    masks, both placements and the load rows once; C x B x 32 bytes, the C
    x T x B counts and the C x D disk loads written).  CPU tensors take
    ``blend_aggregates_plain``; CUDA tensors build the per-broker (and
    per-topic) row index (``blend_indexes``) and launch one warp per broker
    and 32 L blends: each lane walks its broker's index rows in order for L
    blends (1 to 8), keeping the rows each blend puts there, so every sum
    adds the plain version's rows in row order (an all-false mask gives
    K1's bits); the topic counts are counted per topic in shared memory,
    exactly, and written once; the disk loads are a second launch
    (``blend_disk_load``).  ``out`` takes the output tensors to write (the
    scorer's buffers of this shape)."""
    dev = before.device
    C, B, T = masks.shape[0], before.num_brokers, before.num_topics
    _check_blend_inputs(before, after, masks)
    cuda.record("blend_aggregates", (before, after, masks, with_topic_counts, None,
                                     with_topic_leaders, with_disk_load))
    if cuda.on_cpu(masks):
        return blend_aggregates_plain(before, after, masks, with_topic_counts,
                                      with_topic_leaders, with_disk_load)
    if out is None:
        out = (torch.empty((C, B, 4), dtype=torch.float32, device=dev),
               torch.empty((C, B), dtype=torch.int32, device=dev),
               torch.empty((C, B), dtype=torch.int32, device=dev),
               torch.empty((C, B), dtype=torch.float32, device=dev),
               torch.empty((C, B), dtype=torch.float32, device=dev),
               torch.empty((C, T, B), dtype=torch.int32, device=dev)
               if with_topic_counts else None,
               torch.empty((C, T, B), dtype=torch.int32, device=dev)
               if with_topic_leaders else None,
               torch.empty((C, before.num_disks), dtype=torch.float32, device=dev)
               if with_disk_load else None)
    load, rc, lc, pnw, lbi, tbc, tlc, dl = out
    if C > 0 and B > 0:
        topics = tbc is not None or tlc is not None
        masks_t, (offsets, rows), by_topic = blend_indexes(before, after, masks,
                                                           topics=topics)
        t_offsets, t_rows = by_topic if topics else (None, None)
        cuda.launch("blend_aggregates", C, B, before.num_partitions, T, masks_t, offsets,
                    rows, t_offsets, t_rows, before.replica_partition,
                    before.replica_broker, after.replica_broker, before.replica_is_leader,
                    after.replica_is_leader, before.replica_load_leader,
                    before.replica_load_follower, load, rc, lc, pnw, lbi, tbc, tlc)
        blend_aggregates.launches += 1
        if dl is not None:
            _launch_disk_load(before, after, masks_t, dl)
    return out


def blend_disk_load_plain(before: TensorClusterModel, after: TensorClusterModel,
                          masks: torch.Tensor) -> torch.Tensor:
    """K10's disk loads in torch ops, one blend at a time: each blend's
    ``disk_load`` (``index_add_`` in row order), stacked; f32[C, D]."""
    rows = []
    for m in masks:
        blend = blend_placement(before, after, m)
        on_disk = blend.replica_disk >= 0
        disk = blend.replica_load()[:, Resource.DISK]
        rows.append(masked_segment_sum(disk, torch.where(on_disk, blend.replica_disk, 0),
                                       blend.num_disks, blend.replica_valid & on_disk))
    return torch.stack(rows)


def _launch_disk_load(before: TensorClusterModel, after: TensorClusterModel,
                      masks_t: torch.Tensor, out: torch.Tensor) -> None:
    """K10's disk-loads kernel for the blends of ``masks_t``
    (``masks_by_partition``) into ``out`` (f32[C, D], every entry
    written)."""
    C, D = out.shape[0], before.num_disks
    if C > 0 and D > 0:
        offsets, rows = blend_row_index(before.replica_disk, after.replica_disk,
                                        before.replica_valid, D)
        cuda.launch("blend_disk_load", C, D, before.num_partitions, masks_t, offsets, rows,
                    before.replica_partition, before.replica_disk, after.replica_disk,
                    before.replica_is_leader, after.replica_is_leader,
                    before.replica_load_leader, before.replica_load_follower, out)
        _BLEND_DISK_COUNTS["disk"].launches += 1


def blend_disk_load(before: TensorClusterModel, after: TensorClusterModel,
                    masks: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10's disk loads (the second launch of ``blend_aggregates``), f32[C,
    D]: each blend's ``disk_load``.  Bound on the card: bytes (the masks,
    both placements' disks and leader flags and the replica rows once; C x D
    loads written).  CPU tensors take ``blend_disk_load_plain``; CUDA
    tensors build the per-disk row index (``blend_row_index``) and launch
    one warp per disk and 32 L blends whose lanes each add, for L blends,
    the DISK load of the rows the blend puts on the disk in row order (the
    CPU's ``index_add_`` order).  ``out`` takes the tensor to write."""
    _check_blend_inputs(before, after, masks)
    if cuda.on_cpu(masks):
        return blend_disk_load_plain(before, after, masks)
    C, D = masks.shape[0], before.num_disks
    if out is None:
        out = torch.empty((C, D), dtype=torch.float32, device=before.device)
    _launch_disk_load(before, after, masks_by_partition(masks), out)
    return out


def stack_sweep_batch_plain(specs, before: TensorClusterModel, after: TensorClusterModel,
                            masks: torch.Tensor, aggs: BlendAggregates,
                            constraint: BalancingConstraint) -> torch.Tensor:
    """K10's sweep, one blend at a time: ``stack_satisfied_plain`` of each
    blend on its slice of the aggregates; bool[C, G]."""
    specs = tuple(specs)
    rows = [stack_satisfied_plain(specs, blend_placement(before, after, m),
                                  _blend_arrays(before, aggs, c), constraint)[0]
            for c, m in enumerate(masks)]
    if not rows:
        return torch.zeros((0, len(specs)), dtype=torch.bool, device=masks.device)
    return torch.stack(rows)


@cuda.counted("stack_sweep_batch")
def stack_sweep_batch(specs, before: TensorClusterModel, after: TensorClusterModel,
                      masks: torch.Tensor, aggs: BlendAggregates,
                      constraint: BalancingConstraint,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K10, sweep.  Replaces the ``_stack_satisfied`` (``optimizer.py:2331``)
    of every blend that ``cruise_control_tpu/analyzer/optimizer.py:2392``
    ``_get_placement_score_fn`` maps over its masks: bool[C, G], every
    goal's satisfied flag for each blend.  Bound on the card: bytes (each
    blend's aggregates, the rack goal's replica rows and the masks, the
    topic goal's counts, once).  CPU tensors take
    ``stack_sweep_batch_plain``; CUDA tensors launch one block per (goal,
    blend) running K9's per-goal body on the blend's slice of ``aggs``
    (``blend_aggregates``), the rack goals reading blended brokers, the
    preferred-leader goal blended leader flags and offline flags, through
    the mask, and the intra-broker disk goals the blend's disk loads.
    Exact booleans."""
    specs = tuple(specs)
    for s in specs:
        require_supported(s)
    dev = before.device
    C, G, B, T = masks.shape[0], len(specs), before.num_brokers, before.num_topics
    _check_blend_inputs(before, after, masks)
    load, rc, lc, pnw, lbi, tbc, tlc, dl = aggs
    cuda.check(load, "load", torch.float32, (C, B, 4), dev)
    for t, what, dtype in ((rc, "replica_count", torch.int32),
                           (lc, "leader_count", torch.int32),
                           (pnw, "potential_nw_out", torch.float32),
                           (lbi, "leader_bytes_in", torch.float32)):
        cuda.check(t, what, dtype, (C, B), dev)
    kinds = {s.kind for s in specs}
    for kind, table, what in (("topic_replica_distribution", tbc, "topic counts"),
                              ("min_topic_leaders", tlc, "topic leader counts")):
        if kind in kinds:
            if table is None:
                raise ValueError(f"the {kind} goal needs the blends' {what}")
            cuda.check(table, what, torch.int32, (C, T, B), dev)
    intra = bool(kinds & set(INTRA_DISK_KINDS))
    if intra:
        if dl is None:
            raise ValueError("the intra-broker disk goals need the blends' disk loads")
        cuda.check(dl, "disk loads", torch.float32, (C, before.num_disks), dev)
    cuda.record("stack_sweep_batch", (specs, before, after, masks, aggs, constraint))
    if cuda.on_cpu(masks):
        return stack_sweep_batch_plain(specs, before, after, masks, aggs, constraint)
    sat = out if out is not None else torch.empty((C, G), dtype=torch.bool, device=dev)
    cuda.check(sat, "sat", torch.bool, (C, G), dev)
    if C > 0 and G > 0:
        ints, floats = _sweep_table(specs, constraint, dev)
        alive = before.alive_broker_mask()
        leaders = "min_topic_leaders" in kinds
        cuda.launch("stack_sweep_batch", C, G, B, before.num_replicas_padded, T,
                    before.num_partitions, before.max_rf, before.num_racks, ints, floats,
                    alive, before.broker_valid, rc, lc, load, before.broker_capacity.contiguous(),
                    pnw, lbi, alive.sum().clamp(min=1).to(torch.int32).reshape(1),
                    tbc if "topic_replica_distribution" in kinds else None,
                    tlc if leaders else None,
                    _designated_topic_mask(before, constraint) if leaders else None,
                    masks, before.replica_broker, after.replica_broker,
                    before.replica_is_leader, after.replica_is_leader, before.replica_disk,
                    after.replica_disk, before.disk_capacity, before.replica_offline,
                    before.replica_original_broker, before.broker_state, before.replica_valid,
                    before.replica_partition, before.partition_replicas, before.broker_rack,
                    before.partition_replication_factor()
                    if "rack_distribution" in kinds else None,
                    sat, *_disk_rows(before), dl if intra else None)
        stack_sweep_batch.launches += 1
        for kind in kinds:
            _BATCH_SWEEP_COUNTS[kind].launches += 1
    return sat


def _metric_epsilon(spec: GoalSpec) -> float:
    if spec.kind in ("capacity", "resource_distribution"):
        return Resource(spec.resource).epsilon * 1e-3
    if spec.kind in ("potential_nw_out", "leader_bytes_in"):
        return Resource.NW_OUT.epsilon * 1e-3
    if spec.kind in INTRA_DISK_KINDS:
        return Resource.DISK.epsilon * 1e-3
    return 1e-6  # count-based metrics are integral


def _candidate_deltas(spec: GoalSpec, cand: Candidates):
    """(d_src f32[K], d_dest f32[K]) — change of the goal metric on the
    source / destination broker if the candidate applies."""
    kind = spec.kind
    if kind in ("capacity", "resource_distribution"):
        return cand.delta_src[:, spec.resource], cand.delta_dest[:, spec.resource]
    if kind in ("replica_capacity", "replica_distribution"):
        d = cand.d_replica_count.to(torch.float32)
        return -d, d
    if kind == "leader_replica_distribution":
        d = cand.d_leader_count.to(torch.float32)
        return -d, d
    if kind == "potential_nw_out":
        return -cand.d_potential_nw_out, cand.d_potential_nw_out
    if kind == "leader_bytes_in":
        return -cand.d_leader_bytes_in_src, cand.d_leader_bytes_in_dest
    raise NotImplementedError(f"goal kind {kind}")


# ---------------------------------------------------------------------------
# Rack machinery (RackAwareGoal.java:33, RackAwareDistributionGoal.java:65)
# ---------------------------------------------------------------------------

def _sibling_info(model: TensorClusterModel, replica_ids: torch.Tensor):
    """Siblings' replica ids / brokers / racks (i32[K, max_rf]) with a mask
    excluding the replica itself and pads."""
    parts = model.replica_partition[replica_ids]
    sib = model.partition_replicas[parts]
    sib_valid = (sib >= 0) & (sib != replica_ids[:, None])
    sib_safe = torch.where(sib >= 0, sib, 0)
    sib_broker = model.replica_broker[sib_safe]
    sib_rack = model.broker_rack[sib_broker]
    return sib, sib_broker, sib_rack, sib_valid


def _rack_quota(model: TensorClusterModel, partition: torch.Tensor) -> torch.Tensor:
    """f32 ceil(rf / num_racks) of each partition: an i32 divided by a
    Python int is f32 in the JAX package too."""
    return torch.ceil(model.partition_replication_factor()[partition] / model.num_racks)


def _replica_rack_conflict(spec: GoalSpec, model: TensorClusterModel) -> torch.Tensor:
    """bool[R] — ``rack``: a sibling of the replica's partition shares its
    rack, and only the higher-id replica of each conflicting pair is
    flagged; ``rack_distribution``: the replica ranks at or past its
    (partition, rack) quota ceil(rf / num_racks) among the lower-id
    replicas on its rack."""
    if spec.kind not in ("rack", "rack_distribution"):
        raise NotImplementedError(f"goal kind {spec.kind}")
    R = model.num_replicas_padded
    r_idx = torch.arange(R, dtype=torch.int32, device=model.device)
    sib, _, sib_rack, sib_valid = _sibling_info(model, r_idx)
    own_rack = model.broker_rack[model.replica_broker]
    same_rack = sib_valid & (sib_rack == own_rack[:, None])
    if spec.kind == "rack":
        conflict = (same_rack & (sib < r_idx[:, None])).any(dim=1)
    else:
        rank_in_rack = (same_rack & (sib < r_idx[:, None])).sum(dim=1)
        conflict = rank_in_rack >= _rack_quota(model, model.replica_partition)
    return conflict & model.replica_valid


def _rack_ok_for(spec: GoalSpec, model: TensorClusterModel, replica: torch.Tensor,
                 dest: torch.Tensor, partition: torch.Tensor) -> torch.Tensor:
    """Rack legality of moving ``replica`` (of ``partition``) onto ``dest``."""
    if spec.kind not in ("rack", "rack_distribution"):
        raise NotImplementedError(f"goal kind {spec.kind}")
    _, _, sib_rack, sib_valid = _sibling_info(model, replica)
    dest_rack = model.broker_rack[dest]
    same_as_dest = sib_valid & (sib_rack == dest_rack[:, None])
    if spec.kind == "rack":
        return ~same_as_dest.any(dim=1)
    return (1 + same_as_dest.sum(dim=1)) <= _rack_quota(model, partition)


def _swap_rack_ok(spec: GoalSpec, model: TensorClusterModel, cand: Candidates) -> torch.Tensor:
    r2 = torch.where(cand.dest_replica >= 0, cand.dest_replica, 0)
    return _rack_ok_for(spec, model, cand.replica, cand.dest, cand.partition) & \
        _rack_ok_for(spec, model, r2, cand.src, cand.partition2)


# ---------------------------------------------------------------------------
# Feasibility / acceptance / score
# ---------------------------------------------------------------------------

def _src_unhealthy(model: TensorClusterModel, cand: Candidates,
                   arrays: BrokerArrays) -> torch.Tensor:
    return (~arrays.alive[cand.src]) | model.replica_offline_now()[cand.replica]


def self_feasible(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                  cand: Candidates, constraint: BalancingConstraint,
                  bands=None) -> torch.Tensor:
    """bool[K] — candidate is a legal self-improvement for this goal."""
    require_supported(spec)
    kind = spec.kind
    unhealthy = _src_unhealthy(model, cand, arrays)
    if kind == "preferred_leader":
        # A transfer to the partition's preferred replica, or off a DEMOTED
        # source to any eligible sibling (the candidate generator already excludes
        # demoted, dead and excluded destinations).
        preferred = model.preferred_leader_replica()[cand.partition]
        wrong = _wrong_leader_mask(model)[cand.replica]
        src_demoted = model.broker_state[cand.src] == BrokerState.DEMOTED
        return (cand.is_leadership() & wrong
                & ((cand.dest_replica == preferred) | src_demoted))
    if kind == "min_topic_leaders":
        return _min_leader_feasible(model, arrays, cand, constraint, unhealthy)
    if kind in INTRA_DISK_KINDS:
        return _intra_disk_feasible(spec, model, arrays, cand, constraint)
    if kind in ("rack", "rack_distribution"):
        conflict = _replica_rack_conflict(spec, model)[cand.replica]
        ok_dest = _rack_ok_for(spec, model, cand.replica, cand.dest, cand.partition)
        return cand.is_move() & (conflict | unhealthy) & ok_dest
    if kind == "topic_replica_distribution":
        lower_t, upper_t = _topic_limits(model, arrays, constraint)
        tbc = topic_counts(model, arrays)
        t = model.replica_topic[cand.replica]
        c_src = tbc[t, cand.src].to(torch.float32)
        c_dest = tbc[t, cand.dest].to(torch.float32)
        up, lo = upper_t[t], lower_t[t]
        helps = (c_src > up) | (c_dest < lo) | unhealthy
        stays = (c_dest + 1 <= up) & ((c_src - 1 >= lo) | unhealthy)
        return cand.is_move() & helps & stays
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = bands if bands is not None else limits(spec, model, arrays, constraint)
    d_src, d_dest = _candidate_deltas(spec, cand)
    src_m, dest_m = metric[cand.src], metric[cand.dest]
    src_after, dest_after = src_m + d_src, dest_m + d_dest
    eps = _metric_epsilon(spec)
    src_over = src_m > upper[cand.src] + eps
    dest_under = dest_m < lower[cand.dest] - eps
    helps = src_over | dest_under | unhealthy
    dest_ok = dest_after <= upper[cand.dest]
    src_ok = (src_after >= lower[cand.src]) | unhealthy
    moves_something = d_dest.abs() > 0
    return helps & dest_ok & src_ok & moves_something


def _min_leader_feasible(model: TensorClusterModel, arrays: BrokerArrays,
                         cand: Candidates, constraint: BalancingConstraint,
                         unhealthy: torch.Tensor) -> torch.Tensor:
    """A leadership transfer or leader-replica move of a designated topic
    into a broker short of its leaders, without starving the source."""
    designated = _designated_topic_mask(model, constraint)
    t = model.replica_topic[cand.replica]
    tlc = topic_leaders(model, arrays)
    need = constraint.min_topic_leaders_per_broker
    gains_leader = cand.is_leadership() | (cand.is_move() & model.replica_is_leader[cand.replica])
    dest_short = tlc[t, cand.dest] < need
    src_ok = (tlc[t, cand.src] - 1 >= need) | unhealthy
    return designated[t] & gains_leader & dest_short & src_ok


def _disk_contribs(model: TensorClusterModel, cand: Candidates):
    """(f32[K] the DISK load of each lane's replica, f32[K] that of its swap
    partner, replica 0's where there is none)."""
    disk = model.replica_load()[:, Resource.DISK]
    r2 = torch.where(cand.dest_replica >= 0, cand.dest_replica, 0)
    return disk[cand.replica], disk[r2]


def _intra_disk_feasible(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                         cand: Candidates, constraint: BalancingConstraint) -> torch.Tensor:
    """An intra-broker move out of an over-band (or dead) disk onto a disk of
    the same broker that stays within its band, or an intra-broker swap
    whose net exchange keeps both disks in band (``goals/kernels.py:427``).
    The satisfied goal's epsilon, so a satisfied goal has no feasible lane."""
    disk_load = disk_loads(model, arrays)
    lo_d, up_d = _disk_limits(spec, model, constraint, disk_load, arrays)
    s = cand.src_disk.clamp(min=0)
    d = cand.dest_disk.clamp(min=0)
    contrib, contrib2 = _disk_contribs(model, cand)
    src_dead = model.disk_capacity[s] < 0.0
    eps = _metric_epsilon(spec)
    src_over = disk_load[s] > up_d[s] + eps
    dest_under = disk_load[d] < lo_d[d] - eps
    helps = src_over | dest_under | src_dead
    same_broker = model.disk_broker[d] == cand.src
    valid_disks = (cand.src_disk >= 0) & (cand.dest_disk >= 0) & \
        (cand.src_disk != cand.dest_disk)
    dest_ok = (disk_load[d] + contrib <= up_d[d]) & (model.disk_capacity[d] > 0.0)
    src_stays = (disk_load[s] - contrib >= lo_d[s]) | src_dead | src_over
    move_ok = (cand.is_intra_move() & valid_disks & same_broker & helps
               & dest_ok & src_stays)
    net = contrib - contrib2
    swap_dest_ok = (disk_load[d] + net <= up_d[d]) & (model.disk_capacity[d] > 0.0)
    swap_src_ok = ((disk_load[s] - net >= lo_d[s]) | src_dead | src_over) & \
        ((disk_load[s] - net <= up_d[s]) | (net > 0))
    swap_ok = (cand.is_intra_swap() & valid_disks & same_broker & helps
               & swap_dest_ok & swap_src_ok)
    return move_ok | swap_ok


def accepts(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
            cand: Candidates, constraint: BalancingConstraint) -> torch.Tensor:
    """bool[K] — this already-optimized goal does not veto the candidate."""
    require_supported(spec)
    kind = spec.kind
    true = torch.ones((), dtype=torch.bool, device=cand.replica.device)
    if kind == "preferred_leader":
        # PreferredLeaderElectionGoal.actionAcceptance accepts everything: a
        # one-shot election pass, not a standing constraint.
        return torch.ones((cand.k,), dtype=torch.bool, device=cand.replica.device)
    if kind == "min_topic_leaders":
        # Veto actions that starve a designated topic's source broker, and
        # a swap whose reverse leg takes a designated leader off ``dest``.
        designated = _designated_topic_mask(model, constraint)
        t = model.replica_topic[cand.replica]
        loses_leader = cand.is_leadership() | \
            ((cand.is_move() | cand.is_swap()) & model.replica_is_leader[cand.replica])
        tlc = topic_leaders(model, arrays)
        need = constraint.min_topic_leaders_per_broker
        starves = designated[t] & loses_leader & \
            (tlc[t, cand.src] - 1 < need) & arrays.alive[cand.src]
        r2 = torch.where(cand.dest_replica >= 0, cand.dest_replica, 0)
        t2 = model.replica_topic[r2]
        starves2 = cand.is_swap() & designated[t2] & model.replica_is_leader[r2] & \
            (tlc[t2, cand.dest] - 1 < need) & arrays.alive[cand.dest]
        return ~(starves | starves2)
    if kind in INTRA_DISK_KINDS:
        # Veto any action landing a replica on a disk over its upper band:
        # a move, an intra move, or either leg of a swap (r1 onto r2's disk
        # with the net contrib - contrib2, r2 onto r1's with the reverse).
        disk_load = disk_loads(model, arrays)
        _, up_d = _disk_limits(spec, model, constraint, disk_load, arrays)
        d = cand.dest_disk.clamp(min=0)
        s = cand.src_disk.clamp(min=0)
        contrib, contrib2 = _disk_contribs(model, cand)
        is_swap = cand.is_swap() | cand.is_intra_swap()
        net_in = torch.where(is_swap, contrib - contrib2, contrib)
        changes_disk = (cand.is_move() | cand.is_intra_move() | is_swap) & \
            (cand.dest_disk >= 0)
        over = disk_load[d] + net_in > up_d[d]
        over_rev = is_swap & (cand.src_disk >= 0) & \
            (disk_load[s] + contrib2 - contrib > up_d[s])
        return ~((changes_disk & over) | over_rev)
    if kind in ("rack", "rack_distribution"):
        return torch.where(cand.is_move(),
                           _rack_ok_for(spec, model, cand.replica, cand.dest, cand.partition),
                           torch.where(cand.is_swap(), _swap_rack_ok(spec, model, cand), true))
    if kind == "topic_replica_distribution":
        lower_t, upper_t = _topic_limits(model, arrays, constraint)
        tbc = topic_counts(model, arrays)
        t = model.replica_topic[cand.replica]
        c_src = tbc[t, cand.src].to(torch.float32)
        c_dest = tbc[t, cand.dest].to(torch.float32)
        ok = (c_dest + 1 <= upper_t[t]) & (c_src - 1 >= lower_t[t])
        r2 = torch.where(cand.dest_replica >= 0, cand.dest_replica, 0)
        t2 = model.replica_topic[r2]
        c2_src = tbc[t2, cand.src].to(torch.float32)
        c2_dest = tbc[t2, cand.dest].to(torch.float32)
        swap_ok = ok & (c2_src + 1 <= upper_t[t2]) & (c2_dest - 1 >= lower_t[t2])
        return torch.where(cand.is_move(), ok, torch.where(cand.is_swap(), swap_ok, true))
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = limits(spec, model, arrays, constraint)
    d_src, d_dest = _candidate_deltas(spec, cand)
    dest_after = metric[cand.dest] + d_dest
    src_after = metric[cand.src] + d_src
    dest_ok = (dest_after <= upper[cand.dest]) | (d_dest <= 0)
    src_cap_ok = (src_after <= upper[cand.src]) | (d_src <= 0)
    if spec.is_hard or kind in ("potential_nw_out", "leader_bytes_in"):
        return dest_ok & src_cap_ok
    src_ok = (src_after >= lower[cand.src]) | (d_src >= 0) | (~arrays.alive[cand.src])
    dest_low_ok = (dest_after >= lower[cand.dest]) | (d_dest >= 0)
    return dest_ok & src_cap_ok & src_ok & dest_low_ok


_STRUCTURAL_KINDS = ("rack", "topic_replica_distribution", "rack_distribution",
                     "min_topic_leaders") + INTRA_DISK_KINDS
_ACCEPT_COUNTS = cuda.mode_counters("structural_accepts", _STRUCTURAL_KINDS)


def structural_accepts_plain(prev_specs, model: TensorClusterModel, arrays: BrokerArrays,
                             cand: Candidates, constraint: BalancingConstraint):
    """bool[K] — ``accepts`` of every spec in ``prev_specs``, ANDed."""
    out = torch.ones((cand.k,), dtype=torch.bool, device=cand.replica.device)
    for spec in prev_specs:
        out = out & accepts(spec, model, arrays, cand, constraint)
    return out


@cuda.counted("structural_accepts")
def structural_accepts(prev_specs, model: TensorClusterModel, arrays: BrokerArrays,
                       cand: Candidates, constraint: BalancingConstraint) -> torch.Tensor:
    """K5b.  Replaces ``cruise_control_tpu/analyzer/goals/kernels.py:464``
    ``accepts`` of the structural previous goals (``rack``,
    ``rack_distribution``, ``topic_replica_distribution``,
    ``min_topic_leaders``, the intra-broker disk kinds; the band kinds'
    vetoes are the channel budgets of the selection, and
    ``preferred_leader`` vetoes nothing): bool[K], False where an earlier
    goal vetoes the candidate.  Bound on the card: bytes (a
    lane's action, replica, endpoints and partner, its sibling rows and
    broker racks, its topic-count or leader-count rows).  CPU tensors take
    ``structural_accepts_plain``; CUDA tensors launch one thread per lane
    (``csrc/goal_masks.cu``, ``cc_structural_accepts``) that walks the
    partition's siblings for the rack tests (no sibling on the destination
    rack, or the ceil(rf / racks) quota), reads the (topic, broker) counts
    for the topic test, for moves and both legs of swaps, and the (topic,
    broker) leader counts for the min-leaders test of every action that
    takes a designated leader off a broker, and each earlier disk goal's
    upper disk band for the disk veto (any move, intra move or swap leg
    landing on a disk: the disk's load plus the net DISK load it receives
    against the band).  Exact booleans."""
    kinds = {s.kind for s in prev_specs}
    if not kinds <= set(_STRUCTURAL_KINDS):
        raise ValueError(f"structural_accepts takes {_STRUCTURAL_KINDS}, got {sorted(kinds)}")
    dev = cand.replica.device
    k = cand.k
    for name in ("action_type", "replica", "src", "dest", "dest_replica", "src_disk",
                 "dest_disk"):
        cuda.check(getattr(cand, name), name, torch.int32, (k,), dev)
    cuda.record("structural_accepts", (tuple(prev_specs), model, arrays, cand, constraint))
    if cuda.on_cpu(cand.replica):
        return structural_accepts_plain(prev_specs, model, arrays, cand, constraint)
    topic = "topic_replica_distribution" in kinds
    leaders = "min_topic_leaders" in kinds
    rack_dist = "rack_distribution" in kinds
    tbc = lower_t = upper_t = tlc = designated = prf = None
    if topic:
        tbc = topic_counts(model, arrays).contiguous()
        lower_t, upper_t = _topic_limits(model, arrays, constraint)
    if leaders:
        tlc = topic_leaders(model, arrays).contiguous()
        designated = _designated_topic_mask(model, constraint)
    if rack_dist:
        prf = model.partition_replication_factor()
    disk_load = None
    up_d = {}
    if kinds & set(INTRA_DISK_KINDS):
        disk_load = disk_loads(model, arrays)
        for spec in prev_specs:
            if spec.kind in INTRA_DISK_KINDS:
                up_d[spec.kind] = _disk_limits(spec, model, constraint, disk_load, arrays)[1]
    out = torch.empty((k,), dtype=torch.bool, device=dev)
    if k > 0:
        cuda.launch("structural_accepts", int("rack" in kinds), int(rack_dist), int(topic),
                    int(leaders), int("intra_disk_capacity" in up_d),
                    int("intra_disk_distribution" in up_d), k, model.num_brokers, model.max_rf,
                    constraint.min_topic_leaders_per_broker, model.num_racks,
                    cand.action_type, cand.replica, cand.src, cand.dest, cand.dest_replica,
                    model.replica_topic, model.replica_partition, model.replica_broker,
                    model.partition_replicas, model.broker_rack, tbc, lower_t, upper_t,
                    model.replica_is_leader, arrays.alive, tlc, designated, prf, out,
                    disk_load, up_d.get("intra_disk_capacity"),
                    up_d.get("intra_disk_distribution"), cand.src_disk, cand.dest_disk,
                    model.replica_load_leader, model.replica_load_follower)
        structural_accepts.launches += 1
        for kind in kinds:
            _ACCEPT_COUNTS[kind].launches += 1
    return out


def _band_accept_inputs(specs, model: TensorClusterModel, arrays: BrokerArrays,
                        cand: Candidates, constraint: BalancingConstraint):
    """The stacked tables of ``accepts_band_batch``: (metric, lower, upper)
    f32[S, B], (d_src, d_dest) f32[S, K] and cap_style bool[S]."""
    B = model.num_brokers
    metric = torch.stack([broker_metric(s, model, arrays, constraint).expand(B)
                          for s in specs])
    bands = [limits(s, model, arrays, constraint) for s in specs]
    lower = torch.stack([lo.expand(B) for lo, _ in bands])
    upper = torch.stack([up.expand(B) for _, up in bands])
    deltas = [_candidate_deltas(s, cand) for s in specs]
    d_src = torch.stack([d for d, _ in deltas])
    d_dest = torch.stack([d for _, d in deltas])
    cap_style = _cap_style(tuple(s.is_hard or s.kind in ("potential_nw_out", "leader_bytes_in")
                                 for s in specs), metric.device)
    return metric, lower, upper, d_src, d_dest, cap_style


# Never evicted: the captured step graphs read these tensors by address.
@functools.lru_cache(maxsize=None)
def _cap_style(flags: Tuple[bool, ...], device: torch.device) -> torch.Tensor:
    """bool[S] on ``device``, uploaded once per stack: a host-to-device copy
    inside a step would break its CUDA-graph capture."""
    return torch.tensor(flags, dtype=torch.bool).to(device)


def accepts_band_batch_plain(metric, lower, upper, d_src, d_dest, cap_style, alive,
                             src, dest) -> torch.Tensor:
    """bool[K] — the JAX package's ``accepts_band_batch`` on its stacked
    tables (``goals/kernels.py:966-975``)."""
    dest_after = metric[:, dest] + d_dest
    src_after = metric[:, src] + d_src
    dest_ok = (dest_after <= upper[:, dest]) | (d_dest <= 0)
    src_cap_ok = (src_after <= upper[:, src]) | (d_src <= 0)
    src_ok = (src_after >= lower[:, src]) | (d_src >= 0) | (~alive[src])[None, :]
    dest_low_ok = (dest_after >= lower[:, dest]) | (d_dest >= 0)
    return (dest_ok & src_cap_ok & (cap_style[:, None] | (src_ok & dest_low_ok))).all(dim=0)


def accepts_band_batch(specs, model: TensorClusterModel, arrays: BrokerArrays,
                       cand: Candidates, constraint: BalancingConstraint) -> torch.Tensor:
    """bool[K] — the AND of ``accepts`` over the band-kind ``specs``.
    Replaces ``cruise_control_tpu/analyzer/goals/kernels.py:931``
    ``accepts_band_batch`` (reached by the ``_DBG_NO_BUDGETS`` ablation of
    the optimizer, where the band checks stand in for the channel budgets).
    Bound on the card: bytes (8 S + 8 bytes a candidate, the [S, B] tables,
    one byte written).  CPU tensors take ``accepts_band_batch_plain``; CUDA
    tensors launch ``csrc/band_accepts.cu`` (``cc_band_accepts``): one
    thread per candidate walking the S specs, each ``metric + delta`` one
    separately rounded add, so the two agree bit for bit."""
    specs = [s for s in specs if is_band_kind(s)]
    dev = cand.replica.device
    if not specs:
        return torch.ones((cand.k,), dtype=torch.bool, device=dev)
    tables = _band_accept_inputs(specs, model, arrays, cand, constraint)
    return band_accepts(*tables, arrays.alive, cand.src, cand.dest)


@cuda.counted("band_accepts")
def band_accepts(metric, lower, upper, d_src, d_dest, cap_style, alive, src,
                 dest) -> torch.Tensor:
    """The launch of ``accepts_band_batch`` on its stacked tables (see
    there); the CPU takes ``accepts_band_batch_plain``."""
    S, B = metric.shape
    k = src.shape[0]
    dev = src.device
    for name, t in (("metric", metric), ("lower", lower), ("upper", upper)):
        cuda.check(t, name, torch.float32, (S, B), dev)
    cuda.check(d_src, "d_src", torch.float32, (S, k), dev)
    cuda.check(d_dest, "d_dest", torch.float32, (S, k), dev)
    cuda.check(cap_style, "cap_style", torch.bool, (S,), dev)
    cuda.check(alive, "alive", torch.bool, (B,), dev)
    cuda.check(src, "src", torch.int32, (k,), dev)
    cuda.check(dest, "dest", torch.int32, (k,), dev)
    cuda.record("band_accepts", (metric, lower, upper, d_src, d_dest, cap_style, alive,
                                 src, dest))
    if cuda.on_cpu(src):
        return accepts_band_batch_plain(metric, lower, upper, d_src, d_dest, cap_style,
                                        alive, src, dest)
    out = torch.empty((k,), dtype=torch.bool, device=dev)
    if k > 0:
        cuda.launch("band_accepts", S, B, k, metric, lower, upper, d_src, d_dest, cap_style,
                    alive, src, dest, out)
        band_accepts.launches += 1
    return out


def score(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
          cand: Candidates, constraint: BalancingConstraint,
          bands=None) -> torch.Tensor:
    """f32[K] — improvement of the goal objective (higher is better)."""
    require_supported(spec)
    kind = spec.kind
    unhealthy = _src_unhealthy(model, cand, arrays)
    fzero = torch.zeros((), dtype=torch.float32, device=cand.replica.device)
    bonus = torch.where(unhealthy & cand.is_move(), _f32(_OFFLINE_BONUS, fzero), fzero)
    if kind == "preferred_leader":
        preferred = model.preferred_leader_replica()[cand.partition]
        wrong = _wrong_leader_mask(model)[cand.replica]
        src_demoted = model.broker_state[cand.src] == BrokerState.DEMOTED
        to_pref = cand.dest_replica == preferred
        fixes = cand.is_leadership() & wrong & (to_pref | src_demoted)
        # The preferred replica first; any other sibling still fixes a
        # demoted source.
        return torch.where(fixes, torch.where(to_pref, _f32(1.0, fzero), _f32(0.5, fzero)),
                           fzero)
    if kind == "min_topic_leaders":
        tlc = topic_leaders(model, arrays).to(torch.float32)
        t = model.replica_topic[cand.replica]
        need = float(constraint.min_topic_leaders_per_broker)
        designated = _designated_topic_mask(model, constraint)[t]
        gain = torch.clamp(torch.clamp(need - tlc[t, cand.dest], min=0.0), max=1.0)
        c_src = tlc[t, cand.src]
        loss = torch.clamp(need - (c_src - 1.0), min=0.0) - torch.clamp(need - c_src, min=0.0)
        return torch.where(designated, gain - torch.clamp(loss, max=1.0), fzero) + bonus
    if kind in INTRA_DISK_KINDS:
        # The two disks' deviation from their bands before and after the
        # net transfer (the contribution for a move, the exchange difference
        # for a swap), and the offline bonus off a dead disk.
        disk_load = disk_loads(model, arrays)
        lo_d, up_d = _disk_limits(spec, model, constraint, disk_load, arrays)
        s = cand.src_disk.clamp(min=0)
        d = cand.dest_disk.clamp(min=0)
        contrib, contrib2 = _disk_contribs(model, cand)
        net = torch.where(cand.is_intra_swap(), contrib - contrib2, contrib)

        def dev(load, disk):
            return torch.clamp(load - up_d[disk], min=0.0) + \
                torch.clamp(lo_d[disk] - load, min=0.0)

        before = dev(disk_load[s], s) + dev(disk_load[d], d)
        after = dev(disk_load[s] - net, s) + dev(disk_load[d] + net, d)
        dead_bonus = torch.where(model.disk_capacity[s] < 0.0, _f32(_OFFLINE_BONUS, fzero),
                                 fzero)
        return torch.where(cand.is_intra_move() | cand.is_intra_swap(),
                           before - after + dead_bonus, fzero)
    if kind in ("rack", "rack_distribution"):
        _, _, sib_rack, sib_valid = _sibling_info(model, cand.replica)
        own_rack = model.broker_rack[cand.src]
        dest_rack = model.broker_rack[cand.dest]
        before = (sib_valid & (sib_rack == own_rack[:, None])).sum(dim=1)
        after = (sib_valid & (sib_rack == dest_rack[:, None])).sum(dim=1)
        return (before - after).to(torch.float32) + bonus
    if kind == "topic_replica_distribution":
        tbc = topic_counts(model, arrays).to(torch.float32)
        t = model.replica_topic[cand.replica]
        avg_t = _topic_avg(model, arrays)[t]
        c_src = tbc[t, cand.src]
        c_dest = tbc[t, cand.dest]
        before = _sq_sum(c_src - avg_t, c_dest - avg_t)
        after = _sq_sum(c_src - 1 - avg_t, c_dest + 1 - avg_t)
        return (before - after) + bonus
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = bands if bands is not None else limits(spec, model, arrays, constraint)
    d_src, d_dest = _candidate_deltas(spec, cand)
    src_m, dest_m = metric[cand.src], metric[cand.dest]
    if kind in ("capacity", "potential_nw_out", "replica_capacity"):
        def excess(m, b):
            return torch.clamp(m - upper[b], min=0.0)
        before = excess(src_m, cand.src) + excess(dest_m, cand.dest)
        after = excess(src_m + d_src, cand.src) + excess(dest_m + d_dest, cand.dest)
        return before - after + bonus
    target = (lower + upper) * 0.5
    target = torch.where(upper >= _BIG, metric, target)
    before = _sq_sum(src_m - target[cand.src], dest_m - target[cand.dest])
    after = _sq_sum(src_m + d_src - target[cand.src], dest_m + d_dest - target[cand.dest])
    return before - after + bonus


# ---------------------------------------------------------------------------
# K5 — per-candidate masks and score
# ---------------------------------------------------------------------------

_THRESHOLD_KINDS = ("capacity", "potential_nw_out", "replica_capacity")
# Which candidate delta a band kind reads: 0-3 a resource column of
# delta_src / delta_dest, 4 replica count, 5 leader count, 6 potential
# NW_OUT, 7 leader bytes-in (the order of ``_candidate_deltas``).
_DELTA_OF_KIND = {"replica_capacity": 4, "replica_distribution": 4,
                  "leader_replica_distribution": 5, "potential_nw_out": 6,
                  "leader_bytes_in": 7}
(_MODE_THRESHOLD, _MODE_DISTRIBUTION, _MODE_TOPIC, _MODE_RACK, _MODE_PREFERRED,
 _MODE_MIN_LEADERS, _MODE_RACK_DIST, _MODE_INTRA_DISK) = range(8)
_MASK_COUNTS = cuda.mode_counters("goal_masks", SUPPORTED_KINDS)


def goal_masks_plain(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                     cand: Candidates, constraint: BalancingConstraint, bands=None,
                     accepted=None):
    """(score f32[K], eligible bool[K]) from the goal functions above:
    ``eligible = valid & self_feasible & accepted & score > MIN_SCORE``
    (``cruise_control_tpu/analyzer/optimizer.py:1154``)."""
    feasible = self_feasible(spec, model, arrays, cand, constraint, bands=bands)
    sc = score(spec, model, arrays, cand, constraint, bands=bands)
    eligible = cand.valid & feasible & (sc > MIN_SCORE)
    if accepted is not None:
        eligible = eligible & accepted
    return sc, eligible


@cuda.counted("goal_masks")
def goal_masks(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
               cand: Candidates, constraint: BalancingConstraint, bands=None,
               accepted=None):
    """K5.  Replaces ``cruise_control_tpu/analyzer/goals/kernels.py:550``
    ``score``, ``:354`` ``self_feasible`` and ``:256`` ``_candidate_deltas``
    with the ``eligible`` line ``optimizer.py:1154``, for every goal kind
    (the band kinds, ``topic_replica_distribution``, ``rack``,
    ``preferred_leader``, ``min_topic_leaders``, ``rack_distribution`` and,
    as mode 7, the intra-broker disk kinds: intra moves and intra swaps
    against both disks' bands, ``goals/kernels.py:427,578``); ``accepted``
    (the cross-goal vetoes, K5b) comes in as a mask.  Bound on
    the card: bytes (about 40-80 bytes a lane read through the gathers, 5
    written).  CPU tensors take ``goal_masks_plain``; CUDA tensors launch
    one thread per lane that gathers its broker, topic, leader-count,
    preferred-replica or sibling rows and does the arithmetic with
    round-to-nearest intrinsics in the plain version's order (``fma`` only
    where ``_sq_sum`` has it), so the two agree bit for bit."""
    require_supported(spec)
    dev = cand.replica.device
    k = cand.k
    for name in ("action_type", "replica", "src", "dest", "dest_replica",
                 "d_replica_count", "d_leader_count", "src_disk", "dest_disk"):
        cuda.check(getattr(cand, name), name, torch.int32, (k,), dev)
    cuda.check(cand.valid, "valid", torch.bool, (k,), dev)
    if accepted is not None:
        cuda.check(accepted, "accepted", torch.bool, (k,), dev)
    cuda.record("goal_masks", (spec, model, arrays, cand, constraint, bands, accepted))
    if cuda.on_cpu(cand.replica):
        return goal_masks_plain(spec, model, arrays, cand, constraint, bands, accepted)
    kind = spec.kind
    metric = lower = upper = tbc = lower_t = upper_t = avg_t = conflict = None
    tlc = designated = prf = disk_load = lo_d = up_d = None
    delta_sel = 0
    if kind in INTRA_DISK_KINDS:
        mode = _MODE_INTRA_DISK
        disk_load = disk_loads(model, arrays)
        lo_d, up_d = _disk_limits(spec, model, constraint, disk_load, arrays)
    elif kind in ("rack", "rack_distribution"):
        mode = _MODE_RACK if kind == "rack" else _MODE_RACK_DIST
        conflict = _replica_rack_conflict(spec, model)
        if kind == "rack_distribution":
            prf = model.partition_replication_factor()
    elif kind == "topic_replica_distribution":
        mode = _MODE_TOPIC
        tbc = topic_counts(model, arrays).contiguous()
        lower_t, upper_t = _topic_limits(model, arrays, constraint)
        avg_t = _topic_avg(model, arrays)
    elif kind == "preferred_leader":
        mode = _MODE_PREFERRED
    elif kind == "min_topic_leaders":
        mode = _MODE_MIN_LEADERS
        tlc = topic_leaders(model, arrays).contiguous()
        designated = _designated_topic_mask(model, constraint)
    else:
        mode = _MODE_THRESHOLD if kind in _THRESHOLD_KINDS else _MODE_DISTRIBUTION
        delta_sel = _DELTA_OF_KIND.get(kind, spec.resource)
        metric = broker_metric(spec, model, arrays, constraint).contiguous()
        lower, upper = bands if bands is not None else limits(spec, model, arrays,
                                                              constraint)
        lower = lower.expand(model.num_brokers).contiguous()
        upper = upper.expand(model.num_brokers).contiguous()
    score_out = torch.empty((k,), dtype=torch.float32, device=dev)
    eligible = torch.empty((k,), dtype=torch.bool, device=dev)
    if k > 0:
        cuda.launch("goal_masks", mode, delta_sel, k, model.num_brokers, model.max_rf,
                    constraint.min_topic_leaders_per_broker, model.num_racks,
                    float(np.float32(_metric_epsilon(spec))),
                    cand.action_type, cand.replica, cand.src, cand.dest, cand.valid,
                    accepted, cand.delta_src.contiguous(), cand.delta_dest.contiguous(),
                    cand.d_replica_count, cand.d_leader_count,
                    cand.d_potential_nw_out.contiguous(),
                    cand.d_leader_bytes_in_src.contiguous(),
                    cand.d_leader_bytes_in_dest.contiguous(),
                    arrays.alive, metric, lower, upper, model.replica_offline_now(),
                    model.replica_topic, model.replica_partition, model.replica_broker,
                    conflict, tbc, lower_t, upper_t, avg_t,
                    model.partition_replicas, model.broker_rack, score_out, eligible,
                    cand.dest_replica, model.broker_state, model.replica_is_leader,
                    model.replica_valid, tlc, designated, prf, disk_load, lo_d, up_d,
                    model.disk_capacity, model.disk_broker, cand.src_disk, cand.dest_disk,
                    model.replica_load_leader, model.replica_load_follower)
        goal_masks.launches += 1
        _MASK_COUNTS[kind].launches += 1
    return score_out, eligible


# ---------------------------------------------------------------------------
# Candidate-generation hints
# ---------------------------------------------------------------------------

def source_pressure(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                    constraint: BalancingConstraint, bands=None) -> torch.Tensor:
    """f32[B] — how urgently each broker needs to shed."""
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = bands if bands is not None else limits(spec, model, arrays, constraint)
    over = torch.clamp(metric - upper, min=0.0)
    scale = upper.abs().clamp(min=1.0)
    pressure = over / scale
    eps = _metric_epsilon(spec)
    under_exists = (arrays.alive & (metric < lower - eps)).any()
    target = torch.where(upper >= _BIG, metric, (lower + upper) * 0.5)
    donor = torch.clamp(metric - target, min=0.0) / scale * 0.01
    pressure = pressure + torch.where(under_exists, donor, torch.zeros_like(donor))
    dead = (~arrays.alive) & arrays.valid & (arrays.replica_count > 0)
    big = _f32(_BIG, metric)
    return torch.where(dead, big, torch.where(arrays.valid, pressure, -big))


def dest_room(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
              constraint: BalancingConstraint, bands=None) -> torch.Tensor:
    """f32[B] — headroom under the goal's upper limit (candidate dests)."""
    require_supported(spec)
    if spec.kind == "min_topic_leaders":
        # Destinations are exactly the brokers short of designated leaders.
        shortfall = _min_topic_leader_shortfall(model, arrays, constraint)
        return torch.where(arrays.alive, shortfall, _f32(-_BIG, shortfall))
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = bands if bands is not None else limits(spec, model, arrays, constraint)
    room = torch.clamp(upper, max=_BIG) - metric
    room = room + torch.clamp(lower - metric, min=0.0) * 10.0
    return torch.where(arrays.alive, room, _f32(-_BIG, room))


def source_replica_relevance(spec: GoalSpec, model: TensorClusterModel,
                             arrays: BrokerArrays, constraint: BalancingConstraint,
                             bands=None) -> torch.Tensor:
    """f32[R] — ranking for choosing which replicas to propose moving."""
    require_supported(spec)
    kind = spec.kind
    big = _f32(_BIG, arrays.load)
    one = _f32(1.0, big)
    if kind == "preferred_leader":
        return torch.where(_wrong_leader_mask(model) & model.replica_valid, one, -big)
    if kind == "min_topic_leaders":
        # Donor leaders of designated topics on brokers above the minimum
        # (plus any designated leader on a dead broker).
        designated = _designated_topic_mask(model, constraint)[model.replica_topic]
        cnt = topic_leaders(model, arrays)[model.replica_topic, model.replica_broker]
        donor = model.replica_is_leader & designated & \
            (cnt > constraint.min_topic_leaders_per_broker)
        dead_src = ~arrays.alive[model.replica_broker]
        base = torch.where(donor | (designated & model.replica_is_leader & dead_src), one,
                           -big)
        return torch.where(model.replica_valid, base, -big)
    if kind in INTRA_DISK_KINDS:
        # Replicas on over-band and dead disks, and on disks above their
        # band's midpoint on brokers with an under-band disk (donors);
        # bigger replicas first.
        disk_load = disk_loads(model, arrays)
        lo_d, up_d = _disk_limits(spec, model, constraint, disk_load, arrays)
        s = model.replica_disk.clamp(min=0)
        on_disk = model.replica_disk >= 0
        over = disk_load[s] > up_d[s]
        dead = model.disk_capacity[s] < 0.0
        under = (model.disk_valid & (disk_load < lo_d)).to(torch.int32)
        seg = torch.where(model.disk_valid, model.disk_broker, 0).long()
        broker_has_under = torch.zeros((model.num_brokers,), dtype=torch.int32,
                                       device=seg.device).scatter_reduce_(
                                           0, seg, under, "amax") > 0
        donor = broker_has_under[model.replica_broker] & \
            (disk_load[s] > (lo_d[s] + up_d[s]) * 0.5)
        size = model.replica_load()[:, Resource.DISK]
        scale = size.max().clamp(min=1e-9)
        base = torch.where(dead, big,
                           torch.where(over | donor, 1.0 + 1e-3 * size / scale, -big))
        return torch.where(model.replica_valid & on_disk, base, -big)
    pressure = source_pressure(spec, model, arrays, constraint,
                               bands=bands)[model.replica_broker]
    if kind in ("rack", "rack_distribution"):
        conflict = _replica_rack_conflict(spec, model)
        base = torch.where(conflict, _f32(1.0, big), -big)
    elif kind == "topic_replica_distribution":
        lower_t, upper_t = _topic_limits(model, arrays, constraint)
        tbc = topic_counts(model, arrays).to(torch.float32)
        t, b = model.replica_topic, model.replica_broker
        c = tbc[t, b]
        over = c > upper_t[t]
        under_exists = ((tbc < lower_t[:, None]) & arrays.alive[None, :]).any(dim=1)
        avg_t = _topic_avg(model, arrays)
        donor = under_exists[t] & (c > avg_t[t])
        relevant = over | donor
        pair = t * model.num_brokers + b
        rank = _within_group_rank(pair, torch.where(relevant, c, -big),
                                  model.num_topics * model.num_brokers, "pair")
        overage = torch.where(over, c - upper_t[t], torch.clamp(c - avg_t[t], min=1.0))
        pnorm = pressure / pressure.abs().max().clamp(min=1e-9)
        base = torch.where(relevant,
                           -(rank.to(torch.float32) + 1.0) / overage.clamp(min=1.0)
                           + 0.25 * over.to(torch.float32) + 0.5 * pnorm,
                           -big)
    else:
        relevant = pressure > 0
        if kind in ("leader_replica_distribution", "leader_bytes_in"):
            relevant = relevant & model.replica_is_leader
        tiebreak = _replica_metric_contribution(spec, model)
        scale = tiebreak.abs().max().clamp(min=1e-9)
        rank = _within_group_rank(model.replica_broker,
                                  torch.where(relevant, tiebreak, -big), model.num_brokers,
                                  "broker")
        pnorm = pressure / pressure.abs().max().clamp(min=1e-9)
        base = torch.where(relevant,
                           -rank.to(torch.float32) + 0.5 * pnorm + 1e-3 * tiebreak / scale,
                           -big)
    offline = model.replica_offline_now() | (~arrays.alive[model.replica_broker])
    base = torch.where(offline, big, base)
    return torch.where(model.replica_valid, base, -big)


@cuda.counted("group_rank")
def _within_group_rank(group: torch.Tensor, key_desc: torch.Tensor, num_groups: int,
                       form: str = "broker") -> torch.Tensor:
    """K6 group rank.  Replaces ``cruise_control_tpu/analyzer/goals/
    kernels.py:791-805`` ``_within_group_rank``: i32[N], each row's position
    among its group's rows (``group`` i32[N], ids in [0, num_groups)) when
    ordered by descending ``key_desc`` (f32[N], -0.0 equal to +0.0, not NaN;
    ties to the lower row; 0 = the group's best).  ``form`` names the
    grouping for ``cuda.record`` ("broker": S = B; "pair": S = T·B).  Bound
    on the card: bytes (N·8 read, N·4 written).  CPU tensors take
    ``within_group_rank_plain``; CUDA tensors launch ``cc_group_rank``: a
    count of each group, a scan, an unordered scatter of (key, row)
    composites into the groups' ranges and a count, a thread a row, of its
    group's composites above its own (a block through shared memory when it
    lies in one large group)."""
    n = group.shape[0]
    dev = group.device
    cuda.check(group, "group", torch.int32, (n,), dev)
    cuda.check(key_desc, "key_desc", torch.float32, (n,), dev)
    if num_groups < 0:
        raise ValueError(f"group rank: {num_groups} groups")
    args = (group, key_desc, num_groups, form)
    cuda.record("group_rank", args)
    cuda.record(f"group_rank[{form}]", args)
    if cuda.on_cpu(group):
        return within_group_rank_plain(group, key_desc)
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    words = 3 * n + 2 * (num_groups + 1) + 1
    work = torch.empty((words,), dtype=torch.int32, device=dev)
    cuda.launch("group_rank", n, num_groups, group, key_desc, out, work, words)
    _within_group_rank.launches += 1
    return out


def within_group_rank_plain(group: torch.Tensor, key_desc: torch.Tensor) -> torch.Tensor:
    """``_within_group_rank``'s plain twin: the JAX package's lexsort, the
    sorted groups' starts by ``cummax`` and the scatter back."""
    r = group.shape[0]
    ordr = order.lexsort2_plain(-key_desc, group)
    g_sorted = group[ordr]
    idx = torch.arange(r, dtype=torch.int32, device=group.device)
    is_start = torch.ones(r, dtype=torch.bool, device=group.device)
    is_start[1:] = g_sorted[1:] != g_sorted[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    out = torch.zeros((r,), dtype=torch.int32, device=group.device)
    out[ordr] = idx - seg_start
    return out


def _replica_metric_contribution(spec: GoalSpec, model: TensorClusterModel) -> torch.Tensor:
    kind = spec.kind
    load = model.replica_load()
    if kind in ("capacity", "resource_distribution"):
        return load[:, spec.resource]
    if kind == "potential_nw_out":
        return model.replica_load_leader[:, Resource.NW_OUT]
    if kind == "leader_bytes_in":
        return torch.where(model.replica_is_leader,
                           model.replica_load_leader[:, Resource.NW_IN],
                           torch.zeros((), device=load.device))
    return torch.ones(load.shape[0], dtype=torch.float32, device=load.device)


# ---------------------------------------------------------------------------
# Topic-level helpers (TopicReplicaDistributionGoal.java:58)
# ---------------------------------------------------------------------------

def _topic_avg(model: TensorClusterModel, arrays: BrokerArrays) -> torch.Tensor:
    totals = masked_segment_count(model.replica_topic, model.num_topics,
                                  model.replica_valid).to(torch.float32)
    return totals / arrays.num_alive.to(torch.float32)


def _topic_limits(model: TensorClusterModel, arrays: BrokerArrays,
                  constraint: BalancingConstraint):
    bp = _margin_pct(constraint.topic_replica_count_balance_threshold)
    avg = _topic_avg(model, arrays)
    return torch.floor(avg * (2.0 - bp)), torch.ceil(avg * bp)


# ---------------------------------------------------------------------------
# Frontier population (the packed NUM_ACTIVE slot)
# ---------------------------------------------------------------------------

def frontier_inputs(spec: GoalSpec, model: TensorClusterModel, arrays: BrokerArrays,
                     constraint: BalancingConstraint):
    """(metric, lower, upper, alive, valid, replica_count, eps): the broker
    rows ``frontier_mask`` reads for a band goal."""
    B = model.num_brokers
    metric = broker_metric(spec, model, arrays, constraint)
    lower, upper = limits(spec, model, arrays, constraint)
    return (metric.contiguous(), lower.expand(B).contiguous(),
            upper.expand(B).contiguous(), arrays.alive, arrays.valid,
            arrays.replica_count, float(np.float32(_metric_epsilon(spec))))


def frontier_mask_plain(metric, lower, upper, alive, valid, replica_count, eps: float):
    """(bool[B], i32[1] its population) — ``cruise_control_tpu/analyzer/
    goals/kernels.py:842`` ``frontier_active`` on a band goal's broker rows:
    the out-of-band and dead-with-replicas brokers, the biggest pull donors
    until their surplus covers twice the under-band deficit, and the
    roomiest receivers until their room covers twice the remaining surplus.
    The totals and running sums are ``ordered_sum`` / ``ordered_cumsum``:
    the JAX package's rounding, on any device."""
    B = metric.shape[0]
    dev = metric.device
    over = alive & (metric > upper + eps)
    under = alive & (metric < lower - eps)
    dead = (~alive) & valid & (replica_count > 0)
    under_exists = under.any()
    target = torch.where(upper >= _BIG, metric, (lower + upper) * 0.5)
    shed_to = torch.where(under_exists, torch.minimum(target, upper), upper)
    donor = alive & (metric > shed_to + eps)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    surplus = torch.where(alive, torch.clamp(metric - shed_to, min=0.0), zero)
    surplus = surplus + torch.where(dead, torch.clamp(metric, min=0.0), zero)
    total_surplus = order.ordered_sum(surplus)
    deficit = torch.where(under, torch.clamp(lower - metric, min=0.0), zero)
    total_deficit = order.ordered_sum(deficit)

    def leading(values, limit):
        ordr = order.argsort_plain(-values)
        v_sorted = values[ordr]
        before = order.ordered_cumsum(v_sorted) - v_sorted
        out = torch.zeros((B,), dtype=torch.bool, device=dev)
        out[ordr] = (before < 2.0 * limit) & (v_sorted > 0.0)
        return out

    donor = leading(torch.where(donor, surplus, zero), total_deficit)
    room = torch.where(alive & ~over,
                       torch.clamp(torch.clamp(upper, max=_BIG) - metric, min=0.0), zero)
    receivers = leading(room, total_surplus) & (total_surplus > 0.0)
    active = over | under | dead | donor | receivers
    return active, active.sum(dtype=torch.int32).reshape(1)


@cuda.counted("frontier_active")
def frontier_mask(metric, lower, upper, alive, valid, replica_count, eps: float):
    """K9, frontier mask.  Replaces ``cruise_control_tpu/analyzer/goals/
    kernels.py:842`` ``frontier_active``: ``(active bool[B], population
    i32[1])`` from a band goal's metric, band and broker flags.  Bound on
    the card: bytes (B rows of 18 bytes read, B + 4 written: a few
    kilobytes, so a launch costs more than the work).  CPU tensors take
    ``frontier_mask_plain``; CUDA tensors launch one block whose threads
    all take part in every step: the totals in the order of
    ``ordered_sum``; the donor surpluses and the receiver rooms each ranked
    on (value descending, index ascending) — the permutation of the stable
    argsort — by counting up to ``FRONTIER_RANK_MAX_BROKERS`` brokers and by
    a bitonic sort in registers and shared memory above; the running sums
    in the order of ``ordered_cumsum`` (in-block shuffle scans, one warp on
    the block totals), each position testing itself.  Exact against the
    plain twin."""
    B = metric.shape[0]
    dev = metric.device
    for name, t in (("metric", metric), ("lower", lower), ("upper", upper)):
        cuda.check(t, name, torch.float32, (B,), dev)
    cuda.check(alive, "alive", torch.bool, (B,), dev)
    cuda.check(valid, "valid", torch.bool, (B,), dev)
    cuda.check(replica_count, "replica_count", torch.int32, (B,), dev)
    cuda.record("frontier_active", (metric, lower, upper, alive, valid, replica_count, eps))
    if cuda.on_cpu(metric):
        return frontier_mask_plain(metric, lower, upper, alive, valid, replica_count, eps)
    if not 1 <= B <= FRONTIER_MAX_BROKERS:
        raise ValueError(f"frontier_active takes 1..{FRONTIER_MAX_BROKERS} brokers, got {B}")
    active = torch.empty((B,), dtype=torch.bool, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    frontier_mask_launch(metric, lower, upper, alive, valid, replica_count, eps, active, count)
    frontier_mask.launches += 1
    return active, count


def frontier_mask_launch(metric, lower, upper, alive, valid, replica_count, eps: float,
                         active: torch.Tensor, count: torch.Tensor,
                         rank_max: Optional[int] = None) -> None:
    """K9's frontier mask into ``active`` (bool[B]) and ``count`` (i32[1]) on
    CUDA tensors: ``frontier_mask``'s launch, uncounted; ``rank_max`` (at
    most 1,024) in place of ``FRONTIER_RANK_MAX_BROKERS`` picks the sort."""
    rank_max = FRONTIER_RANK_MAX_BROKERS if rank_max is None else rank_max
    cuda.launch("frontier_active", metric.shape[0], rank_max, eps, metric, lower, upper, alive,
                valid, replica_count, active, count)


# Brokers one frontier-mask block sorts in shared memory.
FRONTIER_MAX_BROKERS = 8192
# Up to this many brokers the frontier mask ranks its keys by counting, a
# thread a broker; above it a bitonic sort (at most 1,024: one block's
# threads).
FRONTIER_RANK_MAX_BROKERS = 128


# Never evicted: the captured step graphs read these tensors by address, so
# they must outlive every graph (a freed block would be reused under them).
@functools.lru_cache(maxsize=None)
def _batch_table(specs, device: torch.device):
    """(band bool[G], eps f32[G]) of ``specs`` on ``device``, uploaded once
    per stack: a goal's row is computed when it is of a band kind, with its
    metric epsilon."""
    band = torch.tensor([is_band_kind(s) for s in specs], dtype=torch.bool)
    eps = torch.tensor([float(np.float32(_metric_epsilon(s))) for s in specs],
                       dtype=torch.float32)
    return band.to(device), eps.to(device)


def frontier_inputs_batch(specs, model: TensorClusterModel, arrays: BrokerArrays,
                          constraint: BalancingConstraint):
    """(metric, lower, upper f32[G, B], band bool[G], eps f32[G], alive,
    valid, replica_count): the rows ``frontier_active_batch`` reads, each
    band goal's row from ``frontier_inputs`` and zeros for the others."""
    specs = tuple(specs)
    B = model.num_brokers
    zero = torch.zeros((B,), dtype=torch.float32, device=arrays.load.device)
    rows = [frontier_inputs(s, model, arrays, constraint)[:3] if is_band_kind(s)
            else (zero, zero, zero) for s in specs]
    band, eps = _batch_table(specs, arrays.load.device)
    return (torch.stack([r[0] for r in rows]), torch.stack([r[1] for r in rows]),
            torch.stack([r[2] for r in rows]), band, eps, arrays.alive, arrays.valid,
            arrays.replica_count)


def frontier_active_batch_plain(metric, lower, upper, band, eps, alive, valid,
                                replica_count):
    """(bool[G, B], i32[G] populations) — ``cruise_control_tpu/analyzer/
    goals/kernels.py:912`` ``frontier_active_batch``: ``frontier_mask_plain``
    on each band row, all false with a population of 0 on the others."""
    G, B = metric.shape
    dev = metric.device
    active = torch.zeros((G, B), dtype=torch.bool, device=dev)
    count = torch.zeros((G,), dtype=torch.int32, device=dev)
    for g, (on, e) in enumerate(zip(band.tolist(), eps.tolist())):
        if on:
            row, n = frontier_mask_plain(metric[g], lower[g], upper[g], alive, valid,
                                         replica_count, e)
            active[g] = row
            count[g] = n[0]
    return active, count


@cuda.counted("frontier_active_batch")
def frontier_active_batch(metric, lower, upper, band, eps, alive, valid, replica_count):
    """K9, batch.  Replaces ``cruise_control_tpu/analyzer/goals/kernels.py:912``
    ``frontier_active_batch`` (inside the pipeline's stack sweep,
    ``optimizer.py:2340`` ``_stack_frontiers``): ``(active bool[G, B],
    populations i32[G])`` from the stacked rows of ``frontier_inputs_batch``.
    Bound on the card: bytes (G rows of 13 bytes a broker and the shared
    broker rows read, G x (B + 4) written: tens of kilobytes, so the launch
    and each block's synchronised steps cost more than the traffic).  CPU
    tensors take ``frontier_active_batch_plain``; CUDA tensors launch one
    block per goal, each running the frontier mask's body on its row (a
    non-band row is written all false).  Exact against the plain twin."""
    G, B = metric.shape
    dev = metric.device
    for name, t in (("metric", metric), ("lower", lower), ("upper", upper)):
        cuda.check(t, name, torch.float32, (G, B), dev)
    cuda.check(band, "band", torch.bool, (G,), dev)
    cuda.check(eps, "eps", torch.float32, (G,), dev)
    cuda.check(alive, "alive", torch.bool, (B,), dev)
    cuda.check(valid, "valid", torch.bool, (B,), dev)
    cuda.check(replica_count, "replica_count", torch.int32, (B,), dev)
    cuda.record("frontier_active_batch", (metric, lower, upper, band, eps, alive, valid,
                                          replica_count))
    if cuda.on_cpu(metric):
        return frontier_active_batch_plain(metric, lower, upper, band, eps, alive, valid,
                                           replica_count)
    if not 1 <= B <= FRONTIER_MAX_BROKERS or not 1 <= G <= 65535:
        raise ValueError(f"frontier_active_batch takes 1..{FRONTIER_MAX_BROKERS} brokers "
                         f"and 1..65535 goals, got {B} and {G}")
    active = torch.empty((G, B), dtype=torch.bool, device=dev)
    count = torch.empty((G,), dtype=torch.int32, device=dev)
    frontier_batch_launch(metric, lower, upper, band, eps, alive, valid, replica_count,
                          active, count)
    frontier_active_batch.launches += 1
    return active, count


def frontier_batch_launch(metric, lower, upper, band, eps, alive, valid, replica_count,
                          active: torch.Tensor, count: torch.Tensor) -> None:
    """K9's batch into ``active`` (bool[G, B]) and ``count`` (i32[G]) on CUDA
    tensors: ``frontier_active_batch``'s launch, uncounted."""
    G, B = metric.shape
    cuda.launch("frontier_active_batch", G, B, FRONTIER_RANK_MAX_BROKERS, band, eps, metric,
                lower, upper, alive, valid, replica_count, active, count)


# ---------------------------------------------------------------------------
# K3 — bounded-depth exact repair
# ---------------------------------------------------------------------------

def bisect_depth(n: int) -> int:
    """``ceil(log2(n + 1))``: the JAX package's fixed bisection depth for a
    prefix cut over ``n`` lanes (the packed ``PACKED_BISECT_DEPTH`` slot)."""
    return max(1, math.ceil(math.log2(max(int(n), 1) + 1)))


def _prefix_order(score: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Segment-grouped, score-descending order: the JAX function's two
    stable argsorts (score descending, then segment)."""
    o1 = order.argsort_plain(-score)
    o2 = order.argsort_plain(seg[o1])
    return o1[o2]


def prefix_cut_admit_plain(score, seg, deltas, kept, cum_before, lo, hi,
                           num_segments: int) -> torch.Tensor:
    """The JAX package's ``_sorted_prefix_tables`` + ``prefix_cut_admit``:
    a global cumsum (``ordered_cumsum``: the JAX package's rounding) minus
    each segment's base gives the running channel totals; a position is
    admitted when no position up to and including it in its segment fails
    the band test (the cut the bisection finds)."""
    K = score.shape[0]
    dev = score.device
    ordr = _prefix_order(score, seg)
    s_seg = seg[ordr]
    s_deltas = torch.where(kept[ordr][:, None], deltas[ordr],
                           torch.zeros((), dtype=deltas.dtype, device=dev))
    cs = order.ordered_cumsum(s_deltas)
    pos = torch.arange(K, dtype=torch.int32, device=dev)
    seg_start = torch.full((num_segments,), K, dtype=torch.int32, device=dev)
    seg_start = seg_start.scatter_reduce_(0, s_seg.long(), pos, "amin")
    base = torch.where((seg_start > 0)[:, None], cs[(seg_start - 1).clamp(min=0)],
                       torch.zeros((), dtype=cs.dtype, device=dev))
    prefix = cum_before[s_seg] + cs - base[s_seg]
    hi_s, lo_s = hi[s_seg], lo[s_seg]
    zero = torch.zeros((), dtype=hi.dtype, device=dev)
    scale = torch.clamp(torch.maximum(
        torch.where(torch.isfinite(hi_s), hi_s.abs(), zero),
        torch.where(torch.isfinite(lo_s), lo_s.abs(), zero)), min=1.0)
    eps = 1e-6 * scale
    ok = ((prefix <= hi_s + eps) & (prefix >= lo_s - eps)).all(dim=1)
    badc = torch.cumsum((~ok).to(torch.int32), dim=0)
    bad_base = torch.where(seg_start > 0, badc[(seg_start - 1).clamp(min=0)], 0)
    admit_sorted = (badc - bad_base[s_seg]) == 0
    admit = torch.zeros((K,), dtype=torch.bool, device=dev)
    admit[ordr] = admit_sorted
    return kept & admit


# The segments a cut runs over: brokers, or (topic, broker) keys.
_CUT_COUNTS = cuda.mode_counters("prefix_cut", ("broker", "topic"))
# The most segments K3 groups with the row index's counting pass; above,
# a second stable sort.  Every block of the pass scans all S segment counts,
# so its work grows as S·blocks: at the large rung's 20,000 (topic, broker)
# keys one scatter launch took 0.38 ms on an H100 (solve_walls.py's
# profile).
COUNTING_MAX_SEGMENTS = 4096


@cuda.counted("prefix_cut")
def prefix_cut_admit(score: torch.Tensor, seg: torch.Tensor, deltas: torch.Tensor,
                     kept: torch.Tensor, cum_before: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, num_segments: int,
                     segments: str = "broker") -> torch.Tensor:
    """K3.  Replaces ``cruise_control_tpu/analyzer/goals/kernels.py:997,1031``
    (``_sorted_prefix_tables`` + ``prefix_cut_admit``): per segment, keep the
    longest score-ranked prefix of ``kept`` whose running totals
    (``cum_before`` plus the kept deltas) stay inside [lo, hi] at every
    position.  Segment ids lie in [0, S); a row outside is admitted nowhere.
    Bound on the card: bytes (K·(9+4C) + S·12C read, K written).  CPU
    tensors take ``prefix_cut_admit_plain``; CUDA tensors sort once (K6's
    ``cc_argsort`` of the negated score), group the score-ordered rows by
    segment with the row index's counting pass (``cc_segment_row_index``
    over ``seg[by_score]``, every row; above ``COUNTING_MAX_SEGMENTS`` a
    second ``cc_argsort``, over the segment ids, and
    ``cc_sorted_offsets``), and launch ``cc_prefix_cut``: the running
    totals in the order of ``ordered_cumsum`` rebuilt where they are
    tested, each segment cut at its first out-of-band position
    (``csrc/prefix_cut.cu``).  No host sync; scratch sized from (K, S, C).
    ``segments`` names what the segments are ("broker" or "topic"), for the
    launch counts."""
    dev = score.device
    K = score.shape[0]
    C = deltas.shape[1] if deltas.dim() == 2 else -1
    S = num_segments
    cuda.check(score, "score", torch.float32, (K,), dev)
    cuda.check(seg, "seg", torch.int32, (K,), dev)
    cuda.check(deltas, "deltas", torch.float32, (K, C), dev)
    cuda.check(kept, "kept", torch.bool, (K,), dev)
    for name, t in (("cum_before", cum_before), ("lo", lo), ("hi", hi)):
        cuda.check(t, name, torch.float32, (S, C), dev)
    cuda.record("prefix_cut", (score, seg, deltas, kept, cum_before, lo, hi,
                               num_segments, segments))
    if cuda.on_cpu(score):
        return prefix_cut_admit_plain(score, seg, deltas, kept, cum_before, lo,
                                      hi, num_segments)
    if not 1 <= C <= 16:
        raise ValueError(f"prefix_cut takes 1..16 channels, got {C}")
    out = torch.empty((K,), dtype=torch.bool, device=dev)
    if K == 0 or S <= 0:
        return out.zero_()
    sizes = prefix_cut_scratch(K, S, C)
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    prefix_cut_launch(score, seg, deltas, kept, cum_before, lo, hi, S,
                      torch.split(scratch, sizes), out)
    prefix_cut_admit.launches += 1
    _CUT_COUNTS[segments].launches += 1
    return out


def prefix_cut_scratch(K: int, S: int, C: int) -> list:
    """Sizes in int32 words of K3's scratch on the card, from (K, S, C)
    alone: the sorted rows and their segment ids, the grouping's rows and
    offsets, the counting pass's counts (none above
    ``COUNTING_MAX_SEGMENTS``: the sort groups), the first bad positions,
    the in-block scans, the level-1 values and the segment bases (float32);
    then a pad word that puts the next on an 8-byte boundary, the score
    order (int64), ``cc_argsort``'s scratch (the score sort's, then the
    regroup's), and above ``COUNTING_MAX_SEGMENTS`` the regroup's keys and
    its sorted keys."""
    index_words = regroup_words = 0
    if S <= COUNTING_MAX_SEGMENTS:
        index_words = S * sg.index_tiling(K, S)[2] + S
    else:
        regroup_words = K
    sizes = [K, K, K, S + 1, index_words, S, K * C, C * -(-K // 16), S * C]
    return sizes + [sum(sizes) & 1, 2 * K, order.argsort_work_words(K), regroup_words,
                    regroup_words]


def prefix_cut_launch(score, seg, deltas, kept, cum_before, lo, hi, num_segments: int,
                      parts, out) -> None:
    """K3's launches on the card into ``parts`` (views of the sizes of
    ``prefix_cut_scratch``) and ``out``: the score sort (``cc_argsort``),
    the grouping (the counting pass, or above ``COUNTING_MAX_SEGMENTS`` a
    second ``cc_argsort`` over the segment ids, which also writes the sorted
    ids for ``cc_sorted_offsets``), and ``cc_prefix_cut``."""
    K, C = deltas.shape
    S = num_segments
    (ordr, sorted_seg, rows, offsets, index_scratch, first_bad, inblock, level1, base, _,
     by_score, sort_work, keys, sorted_keys) = parts
    by_score = by_score.view(torch.int64)
    order.argsort_into(-score, None, by_score, sort_work, mode="score")
    if S <= COUNTING_MAX_SEGMENTS:
        warps, warp_rows, _ = sg.index_tiling(K, S)
        cuda.launch("segment_row_index", seg, None, by_score, K, S, warps, warp_rows,
                    offsets, rows, index_scratch)
    else:
        torch.index_select(torch.where((seg >= 0) & (seg < S), seg, S), 0, by_score,
                           out=keys)
        order.argsort_into(keys, S + 1, None, sort_work, out_idx32=rows, out_keys=sorted_keys,
                           mode="regroup")
        cuda.launch("sorted_offsets", sorted_keys, offsets, K, S)
    f32 = torch.float32
    cuda.launch("prefix_cut", by_score, rows, offsets, seg, deltas, kept, cum_before, lo,
                hi, ordr, sorted_seg, inblock.view(f32), level1.view(f32), base.view(f32),
                first_bad, out, K, S, C)


def prefix_admit_safe(score: torch.Tensor, seg: torch.Tensor, deltas: torch.Tensor,
                      kept: torch.Tensor, cum_before: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, num_segments: int,
                      segments: str = "broker") -> torch.Tensor:
    """Subset-closed prefix admit (``kernels.py:1062``): split every delta
    into d+ and d- and bound each one-sided running sum separately, through
    K3 on the 2C split channels."""
    dpos = torch.clamp(deltas, min=0.0)
    dneg = torch.clamp(deltas, max=0.0)
    inf = torch.full_like(hi, math.inf)
    return prefix_cut_admit(
        score, seg, torch.cat([dpos, dneg], dim=1).contiguous(), kept,
        torch.cat([cum_before, cum_before], dim=1).contiguous(),
        torch.cat([-inf, lo], dim=1).contiguous(),
        torch.cat([hi, inf], dim=1).contiguous(), num_segments, segments)
