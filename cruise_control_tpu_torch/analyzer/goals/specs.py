"""Goal specifications.

Each of the reference's goal classes (SURVEY.md §2.3, all 21 listed at
analyzer/goals/*.java) is represented here as a small frozen ``GoalSpec``
selecting a *kind* (the vectorized kernel family in ``kernels.py``) plus
static parameters (resource binding, hardness).  This is the data-driven
replacement for the reference's class-per-goal hierarchy rooted at
``AbstractGoal`` (analyzer/goals/AbstractGoal.java:45): behavior lives in
pure kernel functions; a spec is just the dispatch key, so a full goal list
compiles to a handful of XLA graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.common.resources import Resource


@dataclasses.dataclass(frozen=True)
class GoalSpec:
    name: str
    kind: str
    is_hard: bool = False
    resource: int = -1  # Resource id for resource-bound kinds

    # Which action families the goal uses to improve itself.
    uses_moves: bool = True
    uses_leadership: bool = False
    uses_intra_moves: bool = False
    # Pairwise exchanges (ActionType INTER/INTRA_BROKER_REPLICA_SWAP): lets
    # two brokers both near capacity trade a big replica for a small one
    # when no single move is feasible (ResourceDistributionGoal.java:383-440;
    # KafkaAssignerDiskUsageDistributionGoal.java:48 is swap-based).
    uses_swaps: bool = False
    uses_intra_swaps: bool = False
    # kafka-assigner compatibility mode (kafkaassigner/*.java): same kernel
    # families, flagged so mode-specific goal lists can be assembled.
    kafka_assigner_mode: bool = False


def _capacity(name: str, resource: Resource) -> GoalSpec:
    # Reference: goals/CapacityGoal.java:41 + resource bindings
    # (CpuCapacityGoal.java:12, DiskCapacityGoal, NetworkIn/OutboundCapacityGoal).
    # uses_swaps goes beyond the reference (whose CapacityGoal only moves):
    # two brokers both near the cap can still trade big-for-small when no
    # one-way move fits — strictly more fixable states, same invariants.
    return GoalSpec(name=name, kind="capacity", is_hard=True, resource=int(resource),
                    uses_moves=True, uses_leadership=resource in (Resource.CPU, Resource.NW_OUT),
                    uses_swaps=True)


def _distribution(name: str, resource: Resource) -> GoalSpec:
    # Reference: goals/ResourceDistributionGoal.java:55 + bindings; the
    # third rebalance mechanism (pairwise swaps, :383-440) is uses_swaps.
    return GoalSpec(name=name, kind="resource_distribution", is_hard=False, resource=int(resource),
                    uses_moves=True, uses_leadership=resource in (Resource.CPU, Resource.NW_OUT),
                    uses_swaps=True)


GOAL_SPECS: Dict[str, GoalSpec] = {
    "RackAwareGoal": GoalSpec("RackAwareGoal", "rack", is_hard=True),
    # Relaxed rack distribution (goals/RackAwareDistributionGoal.java:65):
    # same kernel family with even-distribution limits.
    "RackAwareDistributionGoal": GoalSpec("RackAwareDistributionGoal", "rack_distribution",
                                          is_hard=True),
    "ReplicaCapacityGoal": GoalSpec("ReplicaCapacityGoal", "replica_capacity", is_hard=True),
    "DiskCapacityGoal": _capacity("DiskCapacityGoal", Resource.DISK),
    "NetworkInboundCapacityGoal": _capacity("NetworkInboundCapacityGoal", Resource.NW_IN),
    "NetworkOutboundCapacityGoal": _capacity("NetworkOutboundCapacityGoal", Resource.NW_OUT),
    "CpuCapacityGoal": _capacity("CpuCapacityGoal", Resource.CPU),
    "ReplicaDistributionGoal": GoalSpec("ReplicaDistributionGoal", "replica_distribution"),
    "PotentialNwOutGoal": GoalSpec("PotentialNwOutGoal", "potential_nw_out"),
    "DiskUsageDistributionGoal": _distribution("DiskUsageDistributionGoal", Resource.DISK),
    "NetworkInboundUsageDistributionGoal": _distribution(
        "NetworkInboundUsageDistributionGoal", Resource.NW_IN),
    "NetworkOutboundUsageDistributionGoal": _distribution(
        "NetworkOutboundUsageDistributionGoal", Resource.NW_OUT),
    "CpuUsageDistributionGoal": _distribution("CpuUsageDistributionGoal", Resource.CPU),
    "TopicReplicaDistributionGoal": GoalSpec("TopicReplicaDistributionGoal",
                                             "topic_replica_distribution"),
    "LeaderReplicaDistributionGoal": GoalSpec("LeaderReplicaDistributionGoal",
                                              "leader_replica_distribution",
                                              uses_moves=True, uses_leadership=True),
    "LeaderBytesInDistributionGoal": GoalSpec("LeaderBytesInDistributionGoal",
                                              "leader_bytes_in", uses_moves=False,
                                              uses_leadership=True),
    # Make replica[0] the leader (goals/PreferredLeaderElectionGoal.java:36).
    "PreferredLeaderElectionGoal": GoalSpec("PreferredLeaderElectionGoal",
                                            "preferred_leader", uses_moves=False,
                                            uses_leadership=True),
    # ≥ configured leaders of designated topics per broker
    # (goals/MinTopicLeadersPerBrokerGoal.java:50).
    "MinTopicLeadersPerBrokerGoal": GoalSpec("MinTopicLeadersPerBrokerGoal",
                                             "min_topic_leaders", is_hard=True,
                                             uses_moves=True, uses_leadership=True),
    # JBOD intra-broker disk goals (goals/IntraBrokerDiskCapacityGoal.java:42,
    # IntraBrokerDiskUsageDistributionGoal.java:47) — rebalance-disk mode.
    "IntraBrokerDiskCapacityGoal": GoalSpec("IntraBrokerDiskCapacityGoal",
                                            "intra_disk_capacity", is_hard=True,
                                            uses_moves=False, uses_intra_moves=True),
    "IntraBrokerDiskUsageDistributionGoal": GoalSpec(
        "IntraBrokerDiskUsageDistributionGoal", "intra_disk_distribution",
        uses_moves=False, uses_intra_moves=True, uses_intra_swaps=True),
    # kafka-assigner compatibility modes (kafkaassigner/
    # KafkaAssignerEvenRackAwareGoal.java:42, round-robin rack-aware placement;
    # KafkaAssignerDiskUsageDistributionGoal.java:48, SWAP-based disk
    # balancing — pure pairwise exchanges, no one-way moves).
    "KafkaAssignerEvenRackAwareGoal": GoalSpec("KafkaAssignerEvenRackAwareGoal",
                                               "rack", is_hard=True,
                                               kafka_assigner_mode=True),
    "KafkaAssignerDiskUsageDistributionGoal": GoalSpec(
        "KafkaAssignerDiskUsageDistributionGoal", "resource_distribution",
        resource=int(Resource.DISK), kafka_assigner_mode=True,
        uses_moves=False, uses_swaps=True),
}

KAFKA_ASSIGNER_GOALS = [n for n, s in GOAL_SPECS.items() if s.kafka_assigner_mode]

# Reference default priority order (config/cruisecontrol.properties:98-126).
DEFAULT_GOAL_ORDER = [
    "RackAwareGoal",
    "MinTopicLeadersPerBrokerGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
]

DEFAULT_HARD_GOALS = [n for n in DEFAULT_GOAL_ORDER if GOAL_SPECS[n].is_hard]

INTRA_BROKER_GOAL_ORDER = [
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
]


def goals_by_priority(names: Sequence[str]) -> List[GoalSpec]:
    """Resolve goal names (short or fully qualified) in priority order
    (KafkaCruiseControlUtils.goalsByPriority analogue)."""
    out = []
    for name in names:
        short = name.rsplit(".", 1)[-1]
        if short not in GOAL_SPECS:
            raise ValueError(f"Unknown goal {name!r}")
        out.append(GOAL_SPECS[short])
    return out
