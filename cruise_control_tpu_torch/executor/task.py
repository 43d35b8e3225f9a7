"""Execution tasks and their state machine.

Parity with ``ExecutionTask``/``ExecutionTaskState``
(executor/ExecutionTask.java:41, ExecutionTaskState.java): a task wraps one
``ExecutionProposal`` with an execution id and a type, and walks
PENDING → IN_PROGRESS → {COMPLETED | ABORTING → ABORTED | DEAD}.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal

#: ``ExecutionProposal.partition_size`` is megabytes; ledger accounting is
#: bytes so throttle rates (bytes/sec) divide without unit juggling.
_MB = 1_000_000


class TaskType(enum.Enum):
    """executor/ExecutionTask.TaskType."""

    INTER_BROKER_REPLICA_ACTION = "inter_broker_replica_action"
    INTRA_BROKER_REPLICA_ACTION = "intra_broker_replica_action"
    LEADER_ACTION = "leader_action"


class TaskState(enum.Enum):
    """executor/ExecutionTaskState.java."""

    PENDING = "pending"
    IN_PROGRESS = "in_progress"
    ABORTING = "aborting"
    ABORTED = "aborted"
    DEAD = "dead"
    COMPLETED = "completed"


_VALID_TRANSITIONS = {
    # PENDING → ABORTED is the cancellation edge: a task dropped before
    # submission (replan cancel-what-changed, force-stop finalization, or a
    # circuit-broken destination).  It never carried in-flight bytes, which
    # the ledger's observe() distinguishes by the old state.
    TaskState.PENDING: {TaskState.IN_PROGRESS, TaskState.ABORTED},
    TaskState.IN_PROGRESS: {TaskState.ABORTING, TaskState.DEAD, TaskState.COMPLETED},
    TaskState.ABORTING: {TaskState.ABORTED, TaskState.DEAD},
    TaskState.ABORTED: set(),
    TaskState.DEAD: set(),
    TaskState.COMPLETED: set(),
}


@dataclasses.dataclass
class ExecutionTask:
    execution_id: int
    proposal: ExecutionProposal
    task_type: TaskType
    state: TaskState = TaskState.PENDING
    start_time_ms: int = -1
    end_time_ms: int = -1
    alert_time_ms: int = -1
    # Lifecycle observer (the execution ledger's hook): called after every
    # state transition as observer(task, old_state, new_state, now_ms).
    # Excluded from equality/repr — purely observational.
    observer: Optional[Callable[["ExecutionTask", TaskState, TaskState, int],
                                None]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def _transition(self, to: TaskState, now_ms: Optional[int] = None) -> None:
        if to not in _VALID_TRANSITIONS[self.state]:
            raise ValueError(f"illegal task transition {self.state} -> {to} "
                             f"(task {self.execution_id})")
        old = self.state
        self.state = to
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        if to == TaskState.IN_PROGRESS:
            self.start_time_ms = now
        elif to in (TaskState.COMPLETED, TaskState.ABORTED, TaskState.DEAD):
            self.end_time_ms = now
        if self.observer is not None:
            self.observer(self, old, to, now)

    def in_progress(self, now_ms: Optional[int] = None) -> None:
        self._transition(TaskState.IN_PROGRESS, now_ms)

    def completed(self, now_ms: Optional[int] = None) -> None:
        self._transition(TaskState.COMPLETED, now_ms)

    def aborting(self, now_ms: Optional[int] = None) -> None:
        self._transition(TaskState.ABORTING, now_ms)

    def aborted(self, now_ms: Optional[int] = None) -> None:
        self._transition(TaskState.ABORTED, now_ms)

    def cancel(self, now_ms: Optional[int] = None) -> None:
        """Abort a task that never started (PENDING → ABORTED)."""
        self._transition(TaskState.ABORTED, now_ms)

    def kill(self, now_ms: Optional[int] = None) -> None:
        self._transition(TaskState.DEAD, now_ms)

    @property
    def is_active(self) -> bool:
        return self.state in (TaskState.PENDING, TaskState.IN_PROGRESS,
                              TaskState.ABORTING)

    @property
    def bytes_to_move(self) -> int:
        """Data volume this task transfers, in bytes.

        Inter-broker: the partition's size lands once per NEW destination
        broker (existing replicas don't re-copy).  Intra-broker: once per
        disk move.  Leadership: metadata only, zero bytes.
        """
        p = self.proposal
        if self.task_type == TaskType.LEADER_ACTION:
            return 0
        if self.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION:
            n = len(p._intra_broker_moves())
        else:
            n = len(p.replicas_to_add)
        return int(p.partition_size * _MB) * n

    def brokers_involved(self):
        """Brokers this task touches (source + destination sets)."""
        p = self.proposal
        if self.task_type == TaskType.LEADER_ACTION:
            return {p.old_leader.broker, p.new_leader.broker}
        out = set(p.replicas_to_add) | set(p.replicas_to_remove)
        if self.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION:
            out |= {b for b, _, _ in p._intra_broker_moves()}
        return out

    def to_dict(self) -> dict:
        return {
            "executionId": self.execution_id,
            "type": self.task_type.value,
            "state": self.state.value,
            "proposal": self.proposal.to_dict(),
        }
