"""Per-step broker aggregate bundle, step invariants and request options.

Counterpart of ``cruise_control_tpu/analyzer/state.py`` for the dense path.
``BrokerArrays.from_model`` is where K1 (``ops.segment.broker_aggregates``)
runs: once per optimizer step and once per satisfied check.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel
from cruise_control_tpu_torch.ops.segment import broker_aggregates


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

    @classmethod
    def from_model(cls, model: TensorClusterModel,
                   with_topic_counts: bool = False) -> "BrokerArrays":
        alive = model.alive_broker_mask()
        load, rc, lc, pnw, lbi = broker_aggregates(
            model.replica_broker, model.replica_valid, model.replica_is_leader,
            model.replica_load_leader, model.replica_load_follower,
            model.num_brokers)
        return cls(
            load=load, replica_count=rc, leader_count=lc,
            potential_nw_out=pnw, leader_bytes_in=lbi,
            alive=alive,
            capacity=model.broker_capacity,
            valid=model.broker_valid,
            num_alive=alive.sum().clamp(min=1).to(torch.int32),
            topic_counts=(model.topic_broker_replica_counts()
                          if with_topic_counts else None),
        )


def topic_counts(model: TensorClusterModel, arrays: BrokerArrays) -> torch.Tensor:
    """i32[T, B] — the step's shared topic×broker counts when present."""
    if arrays.topic_counts is not None:
        return arrays.topic_counts
    return model.topic_broker_replica_counts()


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


def pow2_bucket(n: int, floor: int) -> int:
    """Smallest power-of-two-of-``floor`` bucket >= ``n``."""
    bucket = max(1, int(floor))
    n = max(1, int(n))
    while bucket < n:
        bucket *= 2
    return bucket


# Packed per-goal stats layout of the JAX package (first slots), kept for
# callers that read the same indices.
PACKED_STEPS = 0
PACKED_ACTIONS = 1
PACKED_BEFORE = 2
PACKED_AFTER = 3
PACKED_CAPPED = 4


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
