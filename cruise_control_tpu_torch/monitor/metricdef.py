"""Metric definitions.

Parity with the core metric registry (`cruise-control-core/.../metricdef/` —
``MetricDef``, ``MetricInfo``, ``ValueComputingStrategy``) and its Kafka
binding ``KafkaMetricDef``
(monitor/metricdefinition/KafkaMetricDef.java:42-102): a fixed id-indexed
registry of metric names with a window-collapse strategy (AVG / MAX /
LATEST) and a COMMON vs BROKER_ONLY scope split.  Ids are the metric-axis
column indices of the aggregation tensors, so the registry is frozen at
import time.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from cruise_control_tpu_torch.common.resources import Resource


class ValueComputingStrategy(enum.Enum):
    AVG = "avg"
    MAX = "max"
    LATEST = "latest"


@dataclasses.dataclass(frozen=True)
class MetricInfo:
    name: str
    metric_id: int
    strategy: ValueComputingStrategy
    group: Optional[str] = None  # resource-group name for group aggregates
    broker_only: bool = False


class MetricDef:
    """Immutable name→id→strategy registry (core MetricDef analogue)."""

    def __init__(self, infos: List[MetricInfo]):
        self._infos = tuple(infos)
        self._by_name: Dict[str, MetricInfo] = {i.name: i for i in infos}
        if len(self._by_name) != len(infos):
            raise ValueError("duplicate metric names")
        for idx, info in enumerate(infos):
            if info.metric_id != idx:
                raise ValueError(f"metric {info.name} id {info.metric_id} != index {idx}")

    def metric_info(self, name: str) -> MetricInfo:
        return self._by_name[name]

    def metric_info_by_id(self, metric_id: int) -> MetricInfo:
        return self._infos[metric_id]

    def all_metric_infos(self) -> Tuple[MetricInfo, ...]:
        return self._infos

    @property
    def num_metrics(self) -> int:
        return len(self._infos)

    def common_ids(self) -> List[int]:
        return [i.metric_id for i in self._infos if not i.broker_only]


def _build(entries) -> MetricDef:
    return MetricDef([MetricInfo(name=n, metric_id=i, strategy=s, group=g,
                                 broker_only=b)
                      for i, (n, s, g, b) in enumerate(entries)])


A, M, L = ValueComputingStrategy.AVG, ValueComputingStrategy.MAX, ValueComputingStrategy.LATEST

# The Kafka metric space (KafkaMetricDef.java:42-102).  COMMON metrics exist
# for partitions and brokers; BROKER_ONLY only in broker samples.
KAFKA_METRIC_DEF = _build([
    # name, strategy, resource-group, broker_only
    ("CPU_USAGE", A, "cpu", False),
    ("DISK_USAGE", L, "disk", False),
    ("LEADER_BYTES_IN", A, "networkInbound", False),
    ("LEADER_BYTES_OUT", A, "networkOutbound", False),
    ("PRODUCE_RATE", A, None, False),
    ("FETCH_RATE", A, None, False),
    ("MESSAGE_IN_RATE", A, None, False),
    ("REPLICATION_BYTES_IN_RATE", A, None, False),
    ("REPLICATION_BYTES_OUT_RATE", A, None, False),
    ("BROKER_PRODUCE_REQUEST_RATE", A, None, True),
    ("BROKER_CONSUMER_FETCH_REQUEST_RATE", A, None, True),
    ("BROKER_FOLLOWER_FETCH_REQUEST_RATE", A, None, True),
    ("BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT", A, None, True),
    ("BROKER_REQUEST_QUEUE_SIZE", M, None, True),
    ("BROKER_RESPONSE_QUEUE_SIZE", M, None, True),
    ("BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MAX", M, None, True),
    ("BROKER_PRODUCE_REQUEST_QUEUE_TIME_MS_MEAN", A, None, True),
    ("BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MAX", M, None, True),
    ("BROKER_CONSUMER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN", A, None, True),
    ("BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MAX", M, None, True),
    ("BROKER_FOLLOWER_FETCH_REQUEST_QUEUE_TIME_MS_MEAN", A, None, True),
    ("BROKER_LOG_FLUSH_RATE", A, None, True),
    ("BROKER_LOG_FLUSH_TIME_MS_MAX", M, None, True),
    ("BROKER_LOG_FLUSH_TIME_MS_MEAN", A, None, True),
    ("BROKER_LOG_FLUSH_TIME_MS_999TH", M, None, True),
])

# Resource → COMMON metric id providing its utilization (model building).
RESOURCE_TO_METRIC_ID: Dict[Resource, int] = {
    Resource.CPU: KAFKA_METRIC_DEF.metric_info("CPU_USAGE").metric_id,
    Resource.NW_IN: KAFKA_METRIC_DEF.metric_info("LEADER_BYTES_IN").metric_id,
    Resource.NW_OUT: KAFKA_METRIC_DEF.metric_info("LEADER_BYTES_OUT").metric_id,
    Resource.DISK: KAFKA_METRIC_DEF.metric_info("DISK_USAGE").metric_id,
}

REPLICATION_BYTES_IN_ID = KAFKA_METRIC_DEF.metric_info("REPLICATION_BYTES_IN_RATE").metric_id
