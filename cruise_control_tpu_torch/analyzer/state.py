"""Per-step broker aggregate bundle, step invariants, request options, the
inter-goal pipeline's next-goal descriptor and warm-start seeding.

Counterpart of ``cruise_control_tpu/analyzer/state.py`` for the dense,
per-goal and pipelined paths.
``BrokerArrays.from_model`` is where K1 (``ops.segment.broker_aggregates``)
runs: once per optimizer step and once per satisfied check (under a
replica-sharded model over the rank's rows, with K15 across the ranks).
``WarmStart``, ``ModelDelta`` and ``model_delta`` are host code (numpy over
host copies of the models), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from cruise_control_tpu_torch.model.tensor_model import TENSOR_FIELDS, TensorClusterModel
from cruise_control_tpu_torch.ops.segment import segment_sum
from cruise_control_tpu_torch.parallel import collectives

# The goal kinds that balance the disks of each broker (JBOD).
INTRA_DISK_KINDS = ("intra_disk_capacity", "intra_disk_distribution")


@dataclasses.dataclass(frozen=True)
class BrokerArrays:
    load: torch.Tensor  # f32[B, 4]
    replica_count: torch.Tensor  # i32[B]
    leader_count: torch.Tensor  # i32[B]
    potential_nw_out: torch.Tensor  # f32[B]
    leader_bytes_in: torch.Tensor  # f32[B]
    alive: torch.Tensor  # bool[B]
    capacity: torch.Tensor  # f32[B, 4]
    valid: torch.Tensor  # bool[B]
    num_alive: torch.Tensor  # i32 scalar
    # i32[T, B] replicas per (topic, broker), computed once per step when a
    # topic goal is in play and read by every topic-kind function: under
    # jit XLA folds the JAX package's seven recomputations into one, eager
    # torch would pay each of them.
    topic_counts: Optional[torch.Tensor] = None
    # i32[T, B] leaders per (topic, broker), computed once per step when a
    # min-topic-leaders goal is in play, for the same reason.
    topic_leader_counts: Optional[torch.Tensor] = None
    # f32[D] DISK load per disk, computed once per step when an intra-broker
    # disk goal is in play, for the same reason.
    disk_load: Optional[torch.Tensor] = None
    # f32[D] the mean DISK utilization of each disk's broker over its live
    # disks (the distribution band's two per-broker sums), computed once per
    # step when IntraBrokerDiskUsageDistributionGoal is in play: its K5,
    # K5b and relevance each read it.
    disk_mean_util: Optional[torch.Tensor] = None

    @classmethod
    def from_model(cls, model: TensorClusterModel, with_topic_counts: bool = False,
                   with_topic_leaders: bool = False, with_disk_load: bool = False,
                   with_disk_means: bool = False, mesh=None) -> "BrokerArrays":
        """The step's per-broker arrays.  Under the search ``mesh`` that
        ``model`` is replica-sharded over (``model.replica_mesh``), K1's
        aggregates and the disk loads cover the rank's rows and combine
        across the ranks through K15 (``collectives.sharded_*``); otherwise
        they cover every row on this process, with no collective."""
        alive = model.alive_broker_mask()
        split = mesh is not None and model.replica_mesh is not None
        disk_load = None
        if with_disk_load or with_disk_means:
            disk_load = (collectives.sharded_disk_load(model, mesh) if split
                         else model.disk_load())
        load, rc, lc, pnw, lbi = (collectives.sharded_broker_aggregates(model, mesh)
                                  if split else model.aggregates())
        return cls(
            load=load, replica_count=rc, leader_count=lc,
            potential_nw_out=pnw, leader_bytes_in=lbi,
            alive=alive,
            capacity=model.broker_capacity,
            valid=model.broker_valid,
            num_alive=alive.sum().clamp(min=1).to(torch.int32),
            topic_counts=(model.topic_broker_replica_counts()
                          if with_topic_counts else None),
            topic_leader_counts=(model.topic_leader_counts()
                                 if with_topic_leaders else None),
            disk_load=disk_load,
            disk_mean_util=(disk_mean_utilization(model, disk_load)
                            if with_disk_means else None),
        )

    @classmethod
    def for_specs(cls, model: TensorClusterModel, specs, mesh=None) -> "BrokerArrays":
        """``from_model`` with the tables that ``specs`` read: (topic,
        broker) replica counts for a topic goal, leader counts for a
        min-topic-leaders goal, the disk loads for an intra-broker disk
        goal and the brokers' mean disk utilization for the distribution
        one."""
        kinds = {s.kind for s in specs}
        return cls.from_model(model, "topic_replica_distribution" in kinds,
                              "min_topic_leaders" in kinds,
                              bool(kinds & set(INTRA_DISK_KINDS)),
                              "intra_disk_distribution" in kinds, mesh)


def topic_counts(model: TensorClusterModel, arrays: BrokerArrays) -> torch.Tensor:
    """i32[T, B] — the step's shared topic×broker counts when present."""
    if arrays.topic_counts is not None:
        return arrays.topic_counts
    return model.topic_broker_replica_counts()


def disk_loads(model: TensorClusterModel, arrays: BrokerArrays) -> torch.Tensor:
    """f32[D] — the step's shared disk loads when present."""
    if arrays.disk_load is not None:
        return arrays.disk_load
    return model.disk_load()


def disk_sum_per_broker(values: torch.Tensor, model: TensorClusterModel,
                        mask: torch.Tensor) -> torch.Tensor:
    """f32[B] — ``values`` (f32[D]) of the disks set in ``mask`` summed per
    broker in disk order (``masked_segment_sum`` over ``disk_broker``; on
    the card K1's ``segment_sum``, in the same order)."""
    return segment_sum(values[:, None].contiguous(), model.disk_broker, mask,
                       model.num_brokers, "disk_broker")[:, 0]


def disk_mean_utilization(model: TensorClusterModel, disk_load: torch.Tensor) -> torch.Tensor:
    """f32[D] — each disk's broker's load over its live disks' capacity
    (``goals/kernels.py:160-167``); dead disks (capacity < 0) take no
    part."""
    ok = model.disk_valid & (model.disk_capacity > 0)
    cap = model.disk_capacity.clamp(min=1e-9)
    broker_load_d = disk_sum_per_broker(disk_load, model, ok)
    broker_cap_d = disk_sum_per_broker(
        torch.where(ok, model.disk_capacity, torch.zeros_like(cap)), model, ok).clamp(min=1e-9)
    return (broker_load_d / broker_cap_d)[model.disk_broker]


def disk_means(model: TensorClusterModel, arrays: BrokerArrays,
               disk_load: torch.Tensor) -> torch.Tensor:
    """f32[D] — the step's shared mean disk utilization when present."""
    if arrays is not None and arrays.disk_mean_util is not None:
        return arrays.disk_mean_util
    return disk_mean_utilization(model, disk_load)


def topic_leaders(model: TensorClusterModel, arrays: BrokerArrays) -> torch.Tensor:
    """i32[T, B] — the step's shared topic×broker leader counts when
    present."""
    if arrays.topic_leader_counts is not None:
        return arrays.topic_leader_counts
    return model.topic_leader_counts()


@dataclasses.dataclass(frozen=True)
class StepInvariants:
    """Step-invariant tensors of one goal fixpoint, computed once before the
    step loop (see the JAX package's StepInvariants for why replica moves,
    swaps and leadership transfers between alive brokers leave them fixed)."""

    upper_min: torch.Tensor  # f32[B, 8] — min over all optimized goals' upper sides
    lower_max: torch.Tensor  # f32[B, 8] — max over their lower sides
    spec_lower: torch.Tensor  # f32[B] — the current goal's own band
    spec_upper: torch.Tensor  # f32[B]
    topic_lower: Optional[torch.Tensor] = None  # f32[T] when a topic goal is in play
    topic_upper: Optional[torch.Tensor] = None  # f32[T]
    designated: Optional[torch.Tensor] = None  # bool[T] when a min-leaders goal is in play


@dataclasses.dataclass(frozen=True)
class FrontierInvariants:
    """The active frontier of one goal's chunked fixpoint (the JAX package's
    ``FrontierInvariants``, ``state.py:91-115``, without the mesh's
    ``shard_active``): the brokers that can still matter to the goal's next
    steps and the index maps between the full broker axis and a compacted
    axis bucketed to a power of two.  A compacted step runs its selection
    segment spaces over the compacted axis while the candidates keep their
    full broker ids.  The bucket is ``full_of_compact.shape[0]``.

    The JAX package's ``shard_active`` (the compact slots' liveness, placed
    ``P(search)``) is a layout hint for GSPMD with no effect on the values:
    a candidate whose source and destination are active has live slots, so
    the ``active`` clause already implies it (``optimizer.py:1163-1169``).
    A search mesh of the port issues its collectives itself and needs no
    such operand."""

    active: torch.Tensor           # bool[B] — full-axis membership mask
    compact_of_full: torch.Tensor  # i32[B] — compact id per broker, -1 when inactive
    full_of_compact: torch.Tensor  # i32[Bc] — full broker id per compact slot, -1 pad

    @property
    def bucket(self) -> int:
        return self.full_of_compact.shape[0]


def pow2_bucket(n: int, floor: int) -> int:
    """Smallest power-of-two-of-``floor`` bucket >= ``n``."""
    bucket = max(1, int(floor))
    n = max(1, int(n))
    while bucket < n:
        bucket *= 2
    return bucket


# Packed per-goal stats layout of the JAX package (``state.py:130-143``): one
# i32[PACKED_WIDTH] vector per goal; the fused stack stacks them into one
# i32[PACKED_WIDTH, G] matrix fetched once per group.
PACKED_STEPS = 0          # steps executed
PACKED_ACTIONS = 1        # actions accepted
PACKED_BEFORE = 2         # goal satisfied at entry (0/1)
PACKED_AFTER = 3          # goal satisfied at exit (0/1)
PACKED_CAPPED = 4         # hit the step budget while still applying (0/1)
PACKED_REPAIR_STEPS = 5   # steps whose selection repair saw a violation
PACKED_BISECT_DEPTH = 6   # max repair bisection depth
PACKED_LANES_LIVE = 7     # live candidate lanes at compaction, summed
PACKED_NUM_ACTIVE = 8     # frontier population at exit; -1 = non-band kind
PACKED_ANY_OFFLINE = 9    # offline replicas remain at exit (0/1)
PACKED_CONFLICT = 10      # brokers touched since the frontier sweep that lie
                          # inside the next goal's predicted seed frontier; 0
                          # when the chunk ran without pipeline accounting
PACKED_WIDTH = 11


# Flight-recorder per-step row layout (the JAX package's ``state.py:174-192``):
# with ``CRUISE_FLIGHT_RECORDER=1`` every executed gated step writes one
# i32[FLIGHT_WIDTH] row of telemetry at its chunk-local step index into the
# working state's flight buffer (``StepState.flight_buffer``), which rides
# the chunk's boundary fetch.  The f32 best eligible score is bitcast into
# the i32 row (FLIGHT_SCORE_BITS); the host decodes it with
# ``np.int32(...).view(np.float32)``.
FLIGHT_ACTIONS = 0      # candidates accepted this step
FLIGHT_FRONTIER = 1     # frontier population at step entry; -1 non-band
FLIGHT_REPAIR = 2       # selection repair saw a violation this step (0/1)
FLIGHT_BISECT = 3       # repair bisection depth this step
FLIGHT_LANES = 4        # live candidate lanes at compaction this step
FLIGHT_SCORE_BITS = 5   # best eligible candidate score, f32 bitcast to i32
FLIGHT_KIND = 6         # argmax action-kind index into FLIGHT_KINDS; -1 none
FLIGHT_WIDTH = 7


@dataclasses.dataclass(frozen=True)
class PipelineNextGoal:
    """Host-side descriptor of the next goal of a pipelined stack run (the
    JAX package's ``state.py:151-172``).  The chunk driver
    (``optimizer.frontier_fixpoint``) uses it to dispatch the next goal's
    opening chunk while the current goal's tail drains: ``seed_active`` is
    the next goal's frontier as the stack sweep predicted it, and the
    packed ``PACKED_CONFLICT`` slot (|touched ∩ seed_active|) discards the
    opener on the device when the current goal touched a broker inside it.
    ``chunk_len`` / ``max_steps`` / ``min_chunk`` give the first-chunk
    length policy of the next goal's own driver, so an adopted opener is
    the chunk a sequential driver would have dispatched."""

    spec: object                        # GoalSpec of the next goal
    prev_specs: tuple                   # the goals it runs under
    seed_active: Optional[np.ndarray]   # bool[B] predicted frontier, or None
    chunk_len: int                      # the next goal's chunk_steps
    max_steps: int                      # the next goal's step budget
    min_chunk: int = 4                  # the next goal's min_chunk


@dataclasses.dataclass(frozen=True)
class OptimizationOptions:
    """Per-request constraints (analyzer/OptimizationOptions.java:16)."""

    topic_excluded: torch.Tensor  # bool[T] excluded from partition movement
    broker_excluded_replica_move: torch.Tensor  # bool[B] may not receive replicas
    broker_excluded_leadership: torch.Tensor  # bool[B] may not receive leadership
    requested_dest_only: torch.Tensor  # bool[B] — if any set, moves must land on these
    only_move_immigrants: torch.Tensor  # bool scalar

    @classmethod
    def none(cls, model: TensorClusterModel) -> "OptimizationOptions":
        B, dev = model.num_brokers, model.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.bool, device=dev)

        return cls(
            topic_excluded=zeros(model.num_topics),
            broker_excluded_replica_move=zeros(B),
            broker_excluded_leadership=zeros(B),
            requested_dest_only=zeros(B),
            only_move_immigrants=zeros(),
        )

    def replace(self, **kw) -> "OptimizationOptions":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The gated step's working state
# ---------------------------------------------------------------------------

# Slots of ``StepState.counters`` (i32[CTR_WIDTH]), the carry of the JAX
# package's ``_goal_fixpoint_budget`` while loop.
CTR_STEPS = 0     # steps executed
CTR_TOTAL = 1     # actions accepted
CTR_LAST_N = 2    # actions of the last executed step (1 before the first)
CTR_REPAIR = 3    # steps whose repair saw a violation
CTR_DEPTH = 4     # max repair bisection depth
CTR_LANES = 5     # live lanes at compaction, summed
CTR_BUDGET = 6    # step budget
CTR_WIDTH = 7

# The model fields a step changes; every other field is read only.
MUTABLE_FIELDS = ("replica_broker", "replica_is_leader", "replica_disk")


@dataclasses.dataclass
class StepState:
    """What the gated step reads and updates in place: the working model,
    the request options and the counters.  On the CPU it is a working copy
    of the placement (``working``); on the card it is a CUDA graph's static
    buffers (``alloc_like`` once per shape, ``load`` per solve), which the
    captured step reads and writes at fixed addresses."""

    model: TensorClusterModel
    options: "OptimizationOptions"
    counters: torch.Tensor  # i32[CTR_WIDTH]
    # Flight-recorder buffers, i32[capacity, FLIGHT_WIDTH] by capacity, made
    # on first use and kept: a captured step graph writes its rows at the
    # buffer's fixed address.
    flight: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)

    def flight_buffer(self, capacity: int) -> torch.Tensor:
        """The flight buffer of ``capacity`` rows (contents undefined until
        the steps of a chunk write theirs)."""
        buf = self.flight.get(capacity)
        if buf is None:
            buf = self.flight[capacity] = torch.zeros(
                (capacity, FLIGHT_WIDTH), dtype=torch.int32, device=self.counters.device)
        return buf

    @classmethod
    def working(cls, model: TensorClusterModel,
                options: "OptimizationOptions") -> "StepState":
        """A copy of ``model``'s placement to step on; the read-only fields
        and ``options`` are shared, never written."""
        mutable = {f: getattr(model, f).clone() for f in MUTABLE_FIELDS}
        return cls(model=model.replace(**mutable), options=options,
                   counters=torch.zeros((CTR_WIDTH,), dtype=torch.int32,
                                        device=model.device))

    @classmethod
    def alloc_like(cls, model: TensorClusterModel,
                   options: "OptimizationOptions") -> "StepState":
        """Fresh buffers of every field's shape (contents undefined)."""
        buf = {f: torch.empty_like(getattr(model, f),
                                   memory_format=torch.contiguous_format)
               for f in TENSOR_FIELDS}
        opts = {f.name: torch.empty_like(getattr(options, f.name))
                for f in dataclasses.fields(options)}
        return cls(model=model.replace(**buf), options=OptimizationOptions(**opts),
                   counters=torch.zeros((CTR_WIDTH,), dtype=torch.int32,
                                        device=model.device))

    def load(self, model: TensorClusterModel, options: "OptimizationOptions") -> None:
        """Copy every field of ``model`` and ``options`` into these buffers."""
        for f in TENSOR_FIELDS:
            getattr(self.model, f).copy_(getattr(model, f))
        for f in dataclasses.fields(options):
            getattr(self.options, f.name).copy_(getattr(options, f.name))

    def placement(self, model: TensorClusterModel) -> TensorClusterModel:
        """``model`` with this state's current placement, copied out."""
        return model.replace(**{f: getattr(self.model, f).clone()
                                for f in MUTABLE_FIELDS})


# ---------------------------------------------------------------------------
# Warm-start seeding (the JAX package's ``state.py:225-327``)
# ---------------------------------------------------------------------------

def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class ModelDelta:
    """Host-side diff of a previous converged model against a fresh one.

    ``changed_mask`` flags every broker whose aggregate load moved by more
    than a relative epsilon, whose replica set or leadership differs
    between the fresh placement and the previous converged one, or whose
    state changed.  ``magnitude`` is the relative L1 load delta over the
    whole cluster."""

    changed_mask: np.ndarray  # bool[B]
    magnitude: float
    num_changed: int

    @property
    def is_zero(self) -> bool:
        return self.num_changed == 0


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Seed of a warm-started solve: ``prev_model`` is the previous
    converged model (an ``OptimizerRun``'s ``model``), whose placement the
    solve starts from; ``active_mask`` (bool[B], host numpy) restricts each
    goal's first frontier to the changed and previously active brokers (a
    compacted convergence is still confirmed by a dense chunk, so a mask
    that misses a broker costs steps, never correctness);
    ``per_goal_satisfied`` carries the previous run's verdicts for the
    record."""

    prev_model: TensorClusterModel
    active_mask: Optional[np.ndarray] = None
    per_goal_satisfied: Optional[Dict[str, bool]] = None

    def compatible_with(self, model: TensorClusterModel) -> bool:
        """Seeding is sound only on an identical replica axis: the same
        padded shapes and the same replica -> partition identity and
        padding."""
        p = self.prev_model
        if (p.num_brokers != model.num_brokers
                or p.num_replicas_padded != model.num_replicas_padded
                or p.num_partitions != model.num_partitions
                or p.max_rf != model.max_rf):
            return False
        return bool(np.array_equal(_host(p.replica_partition),
                                   _host(model.replica_partition))
                    and np.array_equal(_host(p.replica_valid), _host(model.replica_valid)))


def model_delta(prev_model: TensorClusterModel, fresh_model: TensorClusterModel,
                rel_epsilon: float = 1e-3) -> Optional[ModelDelta]:
    """Diff the previous converged model against a fresh one into a
    changed-broker mask and a relative load-delta magnitude, or None when
    the two are not ``WarmStart.compatible_with`` each other (the caller
    then solves cold).  Numpy over host copies of the per-broker loads and
    the placement."""
    if not WarmStart(prev_model=prev_model).compatible_with(fresh_model):
        return None
    prev_load = _host(prev_model.broker_load()).astype(np.float64)
    new_load = _host(fresh_model.broker_load()).astype(np.float64)
    diff = np.abs(new_load - prev_load).sum(axis=1)
    total = max(float(np.abs(prev_load).sum()), 1e-9)
    load_changed = diff > rel_epsilon * max(total / max(prev_load.shape[0], 1), 1e-9)
    magnitude = float(diff.sum() / total)
    prev_rb = _host(prev_model.replica_broker)
    new_rb = _host(fresh_model.replica_broker)
    valid = _host(fresh_model.replica_valid)
    moved = (prev_rb != new_rb) & valid
    B = fresh_model.num_brokers
    placement_changed = np.zeros(B, bool)
    if moved.any():
        placement_changed[np.unique(prev_rb[moved])] = True
        placement_changed[np.unique(new_rb[moved])] = True
    lead_moved = (_host(prev_model.replica_is_leader)
                  != _host(fresh_model.replica_is_leader)) & valid
    if lead_moved.any():
        placement_changed[np.unique(new_rb[lead_moved])] = True
    # Dead brokers always join the mask: healing moves must see them.
    state_changed = _host(prev_model.broker_state) != _host(fresh_model.broker_state)
    changed = (load_changed | placement_changed | state_changed) & \
        _host(fresh_model.broker_valid)
    return ModelDelta(changed_mask=changed, magnitude=magnitude,
                      num_changed=int(changed.sum()))
