"""Cluster metadata: topology snapshot the monitor builds models from.

The stand-in for the reference's Kafka ``Cluster`` metadata +
``MetadataClient`` (common/MetadataClient.java — TTL-cached metadata with a
generation counter).  Real deployments populate this from a Kafka admin
client adapter; tests use it directly as the in-memory fake cluster-state
backend (SURVEY.md §4's "pure in-memory fake" translation of the
embedded-Kafka harness).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    topic: str
    partition: int
    leader: int                    # broker id (-1: offline)
    replicas: Tuple[int, ...]      # broker ids, preferred order (replica[0] preferred leader)
    offline_replicas: Tuple[int, ...] = ()

    @property
    def tp(self) -> Tuple[str, int]:
        return (self.topic, self.partition)


@dataclasses.dataclass(frozen=True)
class BrokerInfo:
    broker_id: int
    rack: str
    host: str = ""
    is_alive: bool = True
    logdirs: Tuple[str, ...] = ("/kafka-logs",)


@dataclasses.dataclass(frozen=True)
class ClusterMetadata:
    brokers: Tuple[BrokerInfo, ...]
    partitions: Tuple[PartitionInfo, ...]
    generation: int = 0

    def broker_ids(self) -> List[int]:
        return [b.broker_id for b in self.brokers]

    def topics(self) -> List[str]:
        seen: Dict[str, None] = {}
        for p in self.partitions:
            seen.setdefault(p.topic, None)
        return list(seen)

    def partitions_for_topic(self, topic: str) -> List[PartitionInfo]:
        return [p for p in self.partitions if p.topic == topic]

    def alive_broker_ids(self) -> List[int]:
        return [b.broker_id for b in self.brokers if b.is_alive]

    def partition_count(self) -> int:
        return len(self.partitions)

    def replica_count(self) -> int:
        return sum(len(p.replicas) for p in self.partitions)


class MetadataClient:
    """Generation-counted mutable holder over ClusterMetadata snapshots
    (common/MetadataClient.java analogue; refreshes come from an admin
    adapter or from tests mutating the fake cluster)."""

    def __init__(self, metadata: ClusterMetadata):
        self._lock = threading.Lock()
        self._metadata = dataclasses.replace(metadata, generation=max(metadata.generation, 1))

    def refresh(self, metadata: ClusterMetadata) -> ClusterMetadata:
        with self._lock:
            self._metadata = dataclasses.replace(
                metadata, generation=self._metadata.generation + 1)
            return self._metadata

    def cluster(self) -> ClusterMetadata:
        with self._lock:
            return self._metadata
