"""Proposal diff: initial vs optimized replica distributions.

Counterpart of ``cruise_control_tpu/analyzer/proposals.py`` (reference:
AnalyzerUtils.getDiff, ExecutionProposal.java:26): one proposal per changed
partition with the old leader, old replica list and new replica list
(leader first, then partition-table order).  A host-side numpy pass, run
once per optimization.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from cruise_control_tpu_torch import native
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel


class ReplicaPlacement(NamedTuple):
    """(broker, disk) placement (model/ReplicaPlacementInfo.java)."""

    broker: int
    disk: int = -1


class ExecutionProposal(NamedTuple):
    """One partition's reassignment (executor/ExecutionProposal.java:26)."""

    partition: int
    topic: int
    partition_size: float  # DISK footprint of the leader replica (MB)
    old_leader: ReplicaPlacement
    old_replicas: Tuple[ReplicaPlacement, ...]
    new_replicas: Tuple[ReplicaPlacement, ...]

    @property
    def new_leader(self) -> ReplicaPlacement:
        return self.new_replicas[0]

    @property
    def replicas_to_add(self) -> Tuple[int, ...]:
        old = {p.broker for p in self.old_replicas}
        return tuple(p.broker for p in self.new_replicas if p.broker not in old)

    @property
    def replicas_to_remove(self) -> Tuple[int, ...]:
        new = {p.broker for p in self.new_replicas}
        return tuple(p.broker for p in self.old_replicas if p.broker not in new)

    @property
    def has_replica_action(self) -> bool:
        return bool(self.replicas_to_add or self.replicas_to_remove
                    or self._intra_broker_moves())

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader.broker != self.new_leader.broker or \
            self.old_replicas[0].broker != self.new_replicas[0].broker

    def _intra_broker_moves(self) -> List[Tuple[int, int, int]]:
        old_by_broker = {p.broker: p.disk for p in self.old_replicas}
        return [(p.broker, old_by_broker[p.broker], p.disk) for p in self.new_replicas
                if p.broker in old_by_broker and old_by_broker[p.broker] != p.disk]

    def to_dict(self) -> Dict[str, object]:
        return {
            "partition": self.partition,
            "topic": self.topic,
            "partitionSize": self.partition_size,
            "oldLeader": self.old_leader.broker,
            "oldReplicas": [p.broker for p in self.old_replicas],
            "newReplicas": [p.broker for p in self.new_replicas],
        }


def renumber_brokers(proposals: List[ExecutionProposal],
                     broker_ids: List[int]) -> List[ExecutionProposal]:
    """Map dense model broker indices to the cluster's broker ids
    (``cruise_control_tpu/analyzer/proposals.py:89``): the model addresses
    brokers by dense index 0..B-1 in sorted-id order, the cluster by ids
    that need not be contiguous; the facade translates here before
    proposals reach the executor or a REST payload."""
    def pl(p: ReplicaPlacement) -> ReplicaPlacement:
        return ReplicaPlacement(int(broker_ids[p.broker]), p.disk)

    return [p._replace(
        old_leader=pl(p.old_leader),
        old_replicas=tuple(pl(x) for x in p.old_replicas),
        new_replicas=tuple(pl(x) for x in p.new_replicas)) for p in proposals]


def diff(initial: TensorClusterModel, final: TensorClusterModel) -> List[ExecutionProposal]:
    """Emit proposals for partitions whose placement or leadership changed."""
    def host(t):
        return t.detach().cpu().numpy()

    pr0, pr1 = host(initial.partition_replicas), host(final.partition_replicas)
    if pr0.shape != pr1.shape:
        raise ValueError("initial/final models have different partition tables")
    rb0, rd0, lead0 = (host(initial.replica_broker), host(initial.replica_disk),
                       host(initial.replica_is_leader))
    rb1, rd1, lead1 = (host(final.replica_broker), host(final.replica_disk),
                       host(final.replica_is_leader))
    load = np.where(lead0[:, None], host(initial.replica_load_leader),
                    host(initial.replica_load_follower))
    ptopic, pvalid = host(initial.partition_topic), host(initial.partition_valid)

    proposals: List[ExecutionProposal] = []
    for p in native.diff_partitions(pr0, rb0, rb1, rd0, rd1, lead0, lead1):
        if not pvalid[p]:
            continue
        slots = pr0[p][pr0[p] >= 0]
        if slots.size == 0:
            continue

        def ordered(rb, rd, lead):
            placements = [ReplicaPlacement(int(rb[r]), int(rd[r])) for r in slots]
            leader_pos = next((i for i, r in enumerate(slots) if lead[r]), 0)
            if leader_pos:
                placements = [placements[leader_pos]] + placements[:leader_pos] + \
                    placements[leader_pos + 1:]
            return tuple(placements)

        old = ordered(rb0, rd0, lead0)
        new = ordered(rb1, rd1, lead1)
        if old == new:
            continue
        proposals.append(ExecutionProposal(
            partition=int(p), topic=int(ptopic[p]),
            partition_size=float(load[slots, Resource.DISK].max()),
            old_leader=old[0], old_replicas=old, new_replicas=new))
    return proposals
