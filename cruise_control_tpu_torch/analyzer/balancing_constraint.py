"""Balancing thresholds bundle.

Parity with the reference's ``BalancingConstraint``
(analyzer/BalancingConstraint.java:20-75): per-resource balance percentages,
capacity thresholds, low-utilization thresholds, max replicas per broker,
over-provisioning bounds, and fast-mode timeout.  Kept as a plain frozen
dataclass of Python floats: they select code paths, they are not tensors.

Copied from ``cruise_control_tpu.analyzer.balancing_constraint`` without
``from_config``, which needs the config layer (not yet ported).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Reference: ResourceDistributionGoal.BALANCE_MARGIN = 0.9
# (goals/ResourceDistributionGoal.java:57) — the fraction of the configured
# balance headroom actually used, so proposals land safely inside limits.
BALANCE_MARGIN = 0.9


@dataclasses.dataclass(frozen=True)
class BalancingConstraint:
    resource_balance_threshold: Tuple[float, float, float, float]  # per Resource id
    capacity_threshold: Tuple[float, float, float, float]
    low_utilization_threshold: Tuple[float, float, float, float]
    replica_count_balance_threshold: float = 1.1
    leader_replica_count_balance_threshold: float = 1.1
    topic_replica_count_balance_threshold: float = 1.1
    max_replicas_per_broker: int = 10000
    overprovisioned_max_replicas_per_broker: int = 1500
    overprovisioned_min_brokers: int = 3
    overprovisioned_min_extra_racks: int = 2
    fast_mode_per_broker_move_timeout_ms: int = 500
    # Max actions one broker participates in per batched optimizer step
    # (moves.per.step; select_batched's rounds × subround lanes).
    moves_per_broker_step: int = 128
    # MinTopicLeadersPerBrokerGoal (config-static designated-topic ids +
    # required leaders per broker; reference: topics.with.min.leaders.per.broker).
    min_topic_leaders_per_broker: int = 1
    min_leader_topic_ids: Tuple[int, ...] = ()

    @classmethod
    def default(cls) -> "BalancingConstraint":
        return cls(
            resource_balance_threshold=(1.1, 1.1, 1.1, 1.1),
            capacity_threshold=(0.7, 0.8, 0.8, 0.8),
            low_utilization_threshold=(0.0, 0.0, 0.0, 0.0),
        )

    def balance_percentage(self, resource: int) -> float:
        """Headroom fraction actually used: 1 + (threshold-1)·margin
        (GoalUtils.computeResourceUtilizationBalanceThreshold)."""
        t = self.resource_balance_threshold[resource]
        return (t - 1.0) * BALANCE_MARGIN + 1.0
