"""In-flight task admission control.

Parity with ``ExecutionTaskManager`` (executor/ExecutionTaskManager.java:37)
+ ``ExecutionTaskTracker`` (ExecutionTaskTracker.java): tracks per-broker
in-flight movement counts against per-type concurrency limits and hands out
the next executable tasks; buckets tasks by state for gauges/state
reporting; enforces the cluster-wide movement cap
(MAX_NUM_CLUSTER_MOVEMENTS_CONFIG).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set

from cruise_control_tpu_torch.executor.planner import ExecutionPlan
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskState, TaskType


class ConcurrencyType(enum.Enum):
    """executor/ConcurrencyType.java."""

    INTER_BROKER_REPLICA = "inter_broker_replica"
    INTRA_BROKER_REPLICA = "intra_broker_replica"
    LEADERSHIP = "leadership"


@dataclasses.dataclass
class ConcurrencyLimits:
    """Per-broker movement caps (ExecutorConfig defaults:
    num.concurrent.partition.movements.per.broker=10 etc.)."""

    inter_broker_per_broker: int = 10
    intra_broker_per_broker: int = 2
    leadership_cluster: int = 1000
    max_cluster_movements: int = 1250
    # max.num.cluster.partition.movements: cluster-wide cap on in-flight
    # inter-broker partition movements specifically (max.num.cluster.movements
    # caps ALL in-flight work, leadership included).
    max_cluster_partition_movements: int = 1250

    def for_type(self, t: ConcurrencyType) -> int:
        if t == ConcurrencyType.INTER_BROKER_REPLICA:
            return self.inter_broker_per_broker
        if t == ConcurrencyType.INTRA_BROKER_REPLICA:
            return self.intra_broker_per_broker
        return self.leadership_cluster


class ExecutionTaskManager:
    def __init__(self, plan: ExecutionPlan, limits: Optional[ConcurrencyLimits] = None):
        self._plan = plan
        self._limits = limits or ConcurrencyLimits()
        self._inflight_by_broker: Dict[int, int] = {}
        self._inflight: Set[int] = set()

    @property
    def limits(self) -> ConcurrencyLimits:
        return self._limits

    def set_limits(self, limits: ConcurrencyLimits) -> None:
        """Dynamic concurrency adjustment (ConcurrencyAdjuster hook)."""
        self._limits = limits

    def inflight_by_broker(self) -> Dict[int, int]:
        """Snapshot of per-broker in-flight movement counts (ledger/gauge
        surface; brokers with zero in-flight are omitted)."""
        return {b: n for b, n in self._inflight_by_broker.items() if n > 0}

    # -- admission ---------------------------------------------------------
    def next_inter_broker_tasks(self) -> List[ExecutionTask]:
        """Next executable inter-broker movements: walk each broker's
        strategy-ordered list, admit a task when every involved broker has
        in-flight headroom (ExecutionTaskManager.
        getInterBrokerReplicaMovementTasks semantics)."""
        cap = self._limits.inter_broker_per_broker
        out: List[ExecutionTask] = []
        total_active = len(self._inflight)
        partition_cap = min(self._limits.max_cluster_movements,
                            self._limits.max_cluster_partition_movements)
        for task in self._plan.inter_broker_tasks:
            if total_active + len(out) >= partition_cap:
                break
            if task.state != TaskState.PENDING or task.execution_id in self._inflight:
                continue
            brokers = task.brokers_involved()
            if all(self._inflight_by_broker.get(b, 0) < cap for b in brokers):
                out.append(task)
                for b in brokers:
                    self._inflight_by_broker[b] = self._inflight_by_broker.get(b, 0) + 1
                self._inflight.add(task.execution_id)
        return out

    def next_intra_broker_tasks(self) -> List[ExecutionTask]:
        cap = self._limits.intra_broker_per_broker
        out: List[ExecutionTask] = []
        for task in self._plan.intra_broker_tasks:
            if task.state != TaskState.PENDING or task.execution_id in self._inflight:
                continue
            brokers = task.brokers_involved()
            if all(self._inflight_by_broker.get(b, 0) < cap for b in brokers):
                out.append(task)
                for b in brokers:
                    self._inflight_by_broker[b] = self._inflight_by_broker.get(b, 0) + 1
                self._inflight.add(task.execution_id)
        return out

    def next_leadership_tasks(self) -> List[ExecutionTask]:
        cap = min(self._limits.leadership_cluster,
                  max(0, self._limits.max_cluster_movements - len(self._inflight)))
        out: List[ExecutionTask] = []
        for task in self._plan.leadership_tasks:
            if len(out) >= cap:
                break
            if task.state == TaskState.PENDING and task.execution_id not in self._inflight:
                out.append(task)
                self._inflight.add(task.execution_id)
        return out

    def finished(self, task: ExecutionTask) -> None:
        """Release in-flight accounting once a task reaches a terminal state."""
        if task.execution_id in self._inflight:
            self._inflight.discard(task.execution_id)
            if task.task_type != TaskType.LEADER_ACTION:
                for b in task.brokers_involved():
                    n = self._inflight_by_broker.get(b, 0)
                    if n > 0:
                        self._inflight_by_broker[b] = n - 1

    # -- state reporting ---------------------------------------------------
    def tasks_by_state(self) -> Dict[TaskState, List[ExecutionTask]]:
        buckets: Dict[TaskState, List[ExecutionTask]] = {s: [] for s in TaskState}
        for t in (self._plan.inter_broker_tasks + self._plan.intra_broker_tasks
                  + self._plan.leadership_tasks):
            buckets[t.state].append(t)
        return buckets

    def counts(self) -> Dict[str, int]:
        return {s.value: len(ts) for s, ts in self.tasks_by_state().items()}

    @property
    def all_done(self) -> bool:
        return all(not t.is_active for t in
                   (self._plan.inter_broker_tasks + self._plan.intra_broker_tasks
                    + self._plan.leadership_tasks))
