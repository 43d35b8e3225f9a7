"""Replica movement strategies.

Parity with the strategy SPI + implementations
(executor/strategy/ReplicaMovementStrategy.java and *.java): a strategy
orders a broker's pending inter-broker movement tasks; strategies compose
with ``chain`` (earlier strategies dominate, later ones break ties), and
the default chain ends with the by-execution-id base strategy so ordering
is always total and deterministic.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.executor.task import ExecutionTask


class ReplicaMovementStrategy:
    """SPI: smaller sort keys execute earlier."""

    name = "abstract"

    def sort_key(self, task: ExecutionTask, context: "StrategyContext"):
        raise NotImplementedError

    def chain(self, nxt: "ReplicaMovementStrategy") -> "ReplicaMovementStrategy":
        return _ChainedStrategy(self, nxt)

    def sorted_tasks(self, tasks: Sequence[ExecutionTask],
                     context: Optional["StrategyContext"] = None) -> List[ExecutionTask]:
        ctx = context or StrategyContext()
        final = self.chain(BaseReplicaMovementStrategy())
        return sorted(tasks, key=lambda t: final.sort_key(t, ctx))


class StrategyContext:
    """Cluster facts strategies consult (URP set, min-ISR info) — the
    reference passes a Cluster + StrategyOptions."""

    def __init__(self, under_replicated: Optional[Set[int]] = None,
                 under_min_isr: Optional[Set[int]] = None,
                 partitions_with_offline_replicas: Optional[Set[int]] = None):
        self.under_replicated = under_replicated or set()
        self.under_min_isr = under_min_isr or set()
        self.partitions_with_offline_replicas = partitions_with_offline_replicas or set()


class _ChainedStrategy(ReplicaMovementStrategy):
    def __init__(self, first: ReplicaMovementStrategy, second: ReplicaMovementStrategy):
        self._first = first
        self._second = second
        self.name = f"{first.name}+{second.name}"

    def sort_key(self, task, context):
        k1 = self._first.sort_key(task, context)
        k2 = self._second.sort_key(task, context)
        k1 = k1 if isinstance(k1, tuple) else (k1,)
        k2 = k2 if isinstance(k2, tuple) else (k2,)
        return k1 + k2


class BaseReplicaMovementStrategy(ReplicaMovementStrategy):
    """By execution id (BaseReplicaMovementStrategy.java) — the total-order
    fallback."""

    name = "base"

    def sort_key(self, task, context):
        return (task.execution_id,)


class PrioritizeLargeReplicaMovementStrategy(ReplicaMovementStrategy):
    """Large partitions first (PrioritizeLargeReplicaMovementStrategy.java)."""

    name = "prioritize-large"

    def sort_key(self, task, context):
        return (-task.proposal.partition_size,)


class PrioritizeSmallReplicaMovementStrategy(ReplicaMovementStrategy):
    """Small partitions first (PrioritizeSmallReplicaMovementStrategy.java)."""

    name = "prioritize-small"

    def sort_key(self, task, context):
        return (task.proposal.partition_size,)


class PostponeUrpReplicaMovementStrategy(ReplicaMovementStrategy):
    """Move partitions with no under-replicated state first
    (PostponeUrpReplicaMovementStrategy.java)."""

    name = "postpone-urp"

    def sort_key(self, task, context):
        return (1 if task.proposal.partition in context.under_replicated else 0,)


class PrioritizeMinIsrWithOfflineReplicasStrategy(ReplicaMovementStrategy):
    """(At/Under)MinISR partitions with offline replicas first
    (PrioritizeMinIsrWithOfflineReplicasStrategy.java)."""

    name = "prioritize-min-isr"

    def sort_key(self, task, context):
        p = task.proposal.partition
        urgent = (p in context.under_min_isr
                  and p in context.partitions_with_offline_replicas)
        return (0 if urgent else 1,)


STRATEGIES = {
    s.name: s for s in (
        BaseReplicaMovementStrategy(),
        PrioritizeLargeReplicaMovementStrategy(),
        PrioritizeSmallReplicaMovementStrategy(),
        PostponeUrpReplicaMovementStrategy(),
        PrioritizeMinIsrWithOfflineReplicasStrategy(),
    )
}


_BY_CLASS_NAME = {type(s).__name__: s for s in STRATEGIES.values()}


def resolve_strategy(names: Sequence[str]) -> ReplicaMovementStrategy:
    """Build a chained strategy from config names (ExecutorConfig
    default.replica.movement.strategies analogue).  Accepts short names
    ("prioritize-large"), class names, or fully-qualified class paths."""
    if not names:
        return BaseReplicaMovementStrategy()
    out: Optional[ReplicaMovementStrategy] = None
    for n in names:
        s = STRATEGIES.get(n) or _BY_CLASS_NAME.get(n.rsplit(".", 1)[-1])
        if s is None:
            raise ValueError(f"unknown replica movement strategy {n!r}")
        out = s if out is None else out.chain(s)
    return out
