"""Replication throttling around movement batches.

Parity with ``ReplicationThrottleHelper``
(executor/ReplicationThrottleHelper.java): before a batch of inter-broker
moves, set the leader/follower replication throttle rate on every involved
broker and mark the moving replicas as throttled (``"partition:broker"``
entries per topic); after the batch, remove exactly what was added, leaving
pre-existing operator-set throttles untouched.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from cruise_control_tpu_torch.executor.admin import ClusterAdmin, Tp
from cruise_control_tpu_torch.executor.task import ExecutionTask


class ReplicationThrottleHelper:
    def __init__(self, admin: ClusterAdmin, rate_bytes_per_sec: Optional[int] = None):
        self._admin = admin
        self._rate = rate_bytes_per_sec

    @property
    def rate_bytes_per_sec(self) -> Optional[int]:
        """The configured throttle rate (None = unthrottled) — the execution
        ledger reads this for its throttle-utilization accounting."""
        return self._rate

    def _throttled_replicas(self, tasks: Sequence[ExecutionTask],
                            partition_names: Sequence[Tp]) -> Dict[str, List[str]]:
        """topic → ["partition:broker", ...] covering old AND new replicas of
        every moving partition (both sides replicate during the move)."""
        out: Dict[str, List[str]] = {}
        for t in tasks:
            topic, part = partition_names[t.proposal.partition]
            brokers = {r.broker for r in t.proposal.old_replicas} | \
                      {r.broker for r in t.proposal.new_replicas}
            entries = out.setdefault(topic, [])
            for b in sorted(brokers):
                entries.append(f"{part}:{b}")
        return out

    def set_throttles(self, tasks: Sequence[ExecutionTask],
                      partition_names: Sequence[Tp]) -> None:
        if self._rate is None or not tasks:
            return
        brokers = sorted({b for t in tasks for b in t.brokers_involved()})
        self._admin.set_replication_throttles(
            self._rate, brokers, self._throttled_replicas(tasks, partition_names))

    def clear_throttles(self, tasks: Sequence[ExecutionTask],
                        partition_names: Sequence[Tp]) -> None:
        if self._rate is None or not tasks:
            return
        brokers = sorted({b for t in tasks for b in t.brokers_involved()})
        self._admin.clear_replication_throttles(
            brokers, self._throttled_replicas(tasks, partition_names))
