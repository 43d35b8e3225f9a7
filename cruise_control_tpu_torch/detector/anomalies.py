"""Anomaly types.

Parity with the reference's anomaly hierarchy (detector/*.java):
``KafkaAnomaly`` base with typed subclasses — ``BrokerFailures``,
``DiskFailures``, ``GoalViolations``, ``SlowBrokers`` (metric anomaly),
``TopicReplicationFactorAnomaly`` / ``TopicPartitionSizeAnomaly``,
``MaintenanceEvent`` — each carrying enough context for its ``fix()`` to
run the matching self-healing operation through the facade (the reference
delegates to servlet runnables: RemoveBrokersRunnable, RebalanceRunnable,
FixOfflineReplicasRunnable, DemoteBrokerRunnable — GoalViolations.java:84).
Anomaly priority drives the handler queue (AnomalyType ordinals,
notifier/AnomalyType.java: broker failure first).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, List, Optional, Sequence, Tuple


class AnomalyType(enum.IntEnum):
    """Priority order — lower value handled first
    (detector/notifier/KafkaAnomalyType.java)."""

    BROKER_FAILURE = 0
    DISK_FAILURE = 1
    METRIC_ANOMALY = 2
    GOAL_VIOLATION = 3
    TOPIC_ANOMALY = 4
    MAINTENANCE_EVENT = 5


_ids = itertools.count()


@dataclasses.dataclass
class Anomaly:
    """Base anomaly (core detector/Anomaly SPI + KafkaAnomaly)."""

    detection_time_ms: int
    anomaly_id: int = dataclasses.field(default_factory=lambda: next(_ids))

    @property
    def anomaly_type(self) -> AnomalyType:
        raise NotImplementedError

    def fix(self, context) -> bool:
        """Run the self-healing operation; returns True if a fix started.
        ``context`` is the CruiseControl facade."""
        raise NotImplementedError

    def reason(self) -> str:
        return self.__class__.__name__

    def to_dict(self) -> Dict[str, object]:
        return {"anomalyId": self.anomaly_id, "type": self.anomaly_type.name,
                "detectionTimeMs": self.detection_time_ms, "reason": self.reason()}


@dataclasses.dataclass
class BrokerFailures(Anomaly):
    """detector/BrokerFailures: brokers gone from the cluster."""

    failed_brokers: Dict[int, int] = dataclasses.field(default_factory=dict)  # id → failure time
    fix_by_removal: bool = True

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.BROKER_FAILURE

    def reason(self) -> str:
        return f"Broker failures detected: {sorted(self.failed_brokers)}"

    def fix(self, context) -> bool:
        if not self.failed_brokers:
            return False
        return context.remove_brokers(sorted(self.failed_brokers),
                                      reason=self.reason(), self_healing=True)


@dataclasses.dataclass
class DiskFailures(Anomaly):
    """detector/DiskFailures: offline logdirs on live brokers."""

    failed_disks: Dict[int, Tuple[str, ...]] = dataclasses.field(default_factory=dict)

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.DISK_FAILURE

    def reason(self) -> str:
        return f"Disk failures detected: {self.failed_disks}"

    def fix(self, context) -> bool:
        return context.fix_offline_replicas(reason=self.reason(),
                                            self_healing=True)


@dataclasses.dataclass
class GoalViolations(Anomaly):
    """detector/GoalViolations.java: fixable/unfixable violated goals."""

    fixable_goals: List[str] = dataclasses.field(default_factory=list)
    unfixable_goals: List[str] = dataclasses.field(default_factory=list)

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.GOAL_VIOLATION

    def reason(self) -> str:
        return (f"Goal violations: fixable={self.fixable_goals} "
                f"unfixable={self.unfixable_goals}")

    def fix(self, context) -> bool:
        if not self.fixable_goals:
            return False
        # Heal with the FULL configured stack, not just the violated goals:
        # a solve constrained only by the violated goal is free to break the
        # rest of the stack (e.g. a DiskCapacityGoal-only fix un-racks
        # replicas), turning one violation into a detect→fix flap.  The
        # reference's GOAL_VIOLATION self-healing likewise runs the
        # configured self-healing goals, which default to the whole stack.
        return context.rebalance(reason=self.reason(), self_healing=True)


@dataclasses.dataclass
class SlowBrokers(Anomaly):
    """detector/SlowBrokers (a metric anomaly): broker → slowness score;
    escalation: demote first, remove persistent offenders
    (SlowBrokerFinder.java:33-105)."""

    slow_brokers: Dict[int, float] = dataclasses.field(default_factory=dict)
    fix_by_removal: bool = False

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.METRIC_ANOMALY

    def reason(self) -> str:
        action = "remove" if self.fix_by_removal else "demote"
        return f"Slow brokers ({action}): {self.slow_brokers}"

    def fix(self, context) -> bool:
        brokers = sorted(self.slow_brokers)
        if not brokers:
            return False
        if self.fix_by_removal:
            return context.remove_brokers(brokers, reason=self.reason())
        return context.demote_brokers(brokers, reason=self.reason())


@dataclasses.dataclass
class TopicReplicationFactorAnomaly(Anomaly):
    """detector/TopicReplicationFactorAnomaly: topics off the desired RF."""

    bad_topics: Dict[str, int] = dataclasses.field(default_factory=dict)  # topic → current RF
    desired_rf: int = 3

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.TOPIC_ANOMALY

    def reason(self) -> str:
        return f"Topics violating RF={self.desired_rf}: {self.bad_topics}"

    def fix(self, context) -> bool:
        if not self.bad_topics:
            return False
        return context.update_topic_replication_factor(
            dict.fromkeys(self.bad_topics, self.desired_rf), reason=self.reason())


@dataclasses.dataclass
class TopicPartitionSizeAnomaly(Anomaly):
    """detector/TopicPartitionSizeAnomaly: oversized partitions (report-only)."""

    oversized: Dict[str, float] = dataclasses.field(default_factory=dict)
    size_threshold_mb: float = 1024.0

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.TOPIC_ANOMALY

    def reason(self) -> str:
        return f"Partitions above {self.size_threshold_mb} MB: {sorted(self.oversized)}"

    def fix(self, context) -> bool:
        return False  # reference: unfixable, surfaced for operators


class MaintenancePlanType(enum.Enum):
    """detector/MaintenancePlan types (MaintenancePlan.java)."""

    ADD_BROKER = "add_broker"
    REMOVE_BROKER = "remove_broker"
    DEMOTE_BROKER = "demote_broker"
    FIX_OFFLINE_REPLICAS = "fix_offline_replicas"
    REBALANCE = "rebalance"
    TOPIC_REPLICATION_FACTOR = "topic_replication_factor"


@dataclasses.dataclass
class MaintenanceEvent(Anomaly):
    """detector/MaintenanceEvent: operator-published plan consumed from the
    maintenance topic/queue."""

    plan_type: MaintenancePlanType = MaintenancePlanType.REBALANCE
    brokers: Tuple[int, ...] = ()
    topics_rf: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def anomaly_type(self) -> AnomalyType:
        return AnomalyType.MAINTENANCE_EVENT

    def reason(self) -> str:
        return f"Maintenance plan {self.plan_type.value} brokers={list(self.brokers)}"

    def dedup_key(self) -> Tuple:
        """IdempotenceCache key (detector/IdempotenceCache.java)."""
        return (self.plan_type, self.brokers, tuple(sorted(self.topics_rf.items())))

    def fix(self, context) -> bool:
        t = self.plan_type
        if t == MaintenancePlanType.ADD_BROKER:
            return context.add_brokers(list(self.brokers), reason=self.reason())
        if t == MaintenancePlanType.REMOVE_BROKER:
            return context.remove_brokers(list(self.brokers), reason=self.reason())
        if t == MaintenancePlanType.DEMOTE_BROKER:
            return context.demote_brokers(list(self.brokers), reason=self.reason())
        if t == MaintenancePlanType.FIX_OFFLINE_REPLICAS:
            return context.fix_offline_replicas(reason=self.reason(),
                                            self_healing=True)
        if t == MaintenancePlanType.TOPIC_REPLICATION_FACTOR:
            return context.update_topic_replication_factor(self.topics_rf,
                                                           reason=self.reason())
        return context.rebalance(goals=None, reason=self.reason())
