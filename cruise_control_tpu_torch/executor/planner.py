"""Execution task planning.

Parity with ``ExecutionTaskPlanner`` (executor/ExecutionTaskPlanner.java:65,
class doc :46-64): converts proposals into (1) a leadership-movement task
list, (2) per-broker *sorted* inter-broker movement sets ordered by the
configured replica-movement strategy — each movement task appears in both
its source and destination brokers' plans — and (3) intra-broker movement
tasks for disk-only changes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.executor.strategy import (BaseReplicaMovementStrategy,
                                                  ReplicaMovementStrategy,
                                                  StrategyContext)
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskType


@dataclasses.dataclass
class ExecutionPlan:
    inter_broker_tasks: List[ExecutionTask]
    intra_broker_tasks: List[ExecutionTask]
    leadership_tasks: List[ExecutionTask]
    # broker id → its inter-broker tasks in strategy order (task present in
    # both source and destination brokers' lists).
    tasks_by_broker: Dict[int, List[ExecutionTask]]

    @property
    def total_tasks(self) -> int:
        return (len(self.inter_broker_tasks) + len(self.intra_broker_tasks)
                + len(self.leadership_tasks))

    @property
    def total_bytes(self) -> int:
        """Total data volume the plan will move (leadership moves none)."""
        return sum(t.bytes_to_move for t in
                   self.inter_broker_tasks + self.intra_broker_tasks)


class ExecutionTaskPlanner:
    def __init__(self, strategy: Optional[ReplicaMovementStrategy] = None,
                 first_execution_id: int = 0):
        # ``first_execution_id`` lets a mid-execution replan mint task ids
        # that continue after the live plan's current maximum.
        self._strategy = strategy or BaseReplicaMovementStrategy()
        self._next_execution_id = first_execution_id

    def _new_task(self, proposal: ExecutionProposal, task_type: TaskType) -> ExecutionTask:
        t = ExecutionTask(self._next_execution_id, proposal, task_type)
        self._next_execution_id += 1
        return t

    def plan(self, proposals: Sequence[ExecutionProposal],
             context: Optional[StrategyContext] = None) -> ExecutionPlan:
        inter: List[ExecutionTask] = []
        intra: List[ExecutionTask] = []
        leader: List[ExecutionTask] = []
        for p in proposals:
            if p.replicas_to_add or p.replicas_to_remove:
                inter.append(self._new_task(p, TaskType.INTER_BROKER_REPLICA_ACTION))
            # Not elif: a proposal can carry both an inter-broker change and a
            # same-broker disk move for a different replica of the partition.
            if p._intra_broker_moves():
                intra.append(self._new_task(p, TaskType.INTRA_BROKER_REPLICA_ACTION))
            if p.has_leader_action:
                leader.append(self._new_task(p, TaskType.LEADER_ACTION))

        ordered = self._strategy.sorted_tasks(inter, context)
        by_broker: Dict[int, List[ExecutionTask]] = {}
        for t in ordered:
            for b in t.brokers_involved():
                by_broker.setdefault(b, []).append(t)
        return ExecutionPlan(inter_broker_tasks=ordered, intra_broker_tasks=intra,
                             leadership_tasks=leader, tasks_by_broker=by_broker)
