"""Metric sampling: sampler SPI, sample types, sample stores.

Parity with the reference's sampling stack (monitor/sampling/):
``MetricSampler`` SPI (MetricSampler.java:26,96) with ``SamplingMode``,
``PartitionMetricSample``/``BrokerMetricSample`` holders (holder/),
``SampleStore`` SPI with persistence + warm-start replay
(KafkaSampleStore.java:69 — here a JSONL file store; the Kafka-topic store
becomes an adapter at the edge), and the metric processor that derives
per-partition CPU from broker CPU weighted by bytes rates
(SamplingUtils.estimateLeaderCpuUtil, sampling/SamplingUtils.java:84-111).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.monitor.metadata import ClusterMetadata


class SamplingMode(enum.Enum):
    """Reference: MetricSampler.SamplingMode (MetricSampler.java:96)."""

    ALL = "all"
    BROKER_METRICS_ONLY = "broker_metrics_only"
    PARTITION_METRICS_ONLY = "partition_metrics_only"
    ONGOING_EXECUTION = "ongoing_execution"


@dataclasses.dataclass(frozen=True)
class PartitionMetricSample:
    """holder/PartitionMetricSample analogue: one (topic, partition) sample."""

    topic: str
    partition: int
    broker_id: int            # leader broker at sample time
    time_ms: int
    metrics: Dict[str, float]  # metric name → value (KAFKA_METRIC_DEF names)

    @property
    def entity(self) -> Tuple[str, int]:
        return (self.topic, self.partition)

    def to_json(self) -> str:
        return json.dumps({"type": "partition", "topic": self.topic,
                           "partition": self.partition, "broker": self.broker_id,
                           "time_ms": self.time_ms, "metrics": self.metrics})


@dataclasses.dataclass(frozen=True)
class BrokerMetricSample:
    """holder/BrokerMetricSample analogue."""

    broker_id: int
    time_ms: int
    metrics: Dict[str, float]

    @property
    def entity(self) -> int:
        return self.broker_id

    def to_json(self) -> str:
        return json.dumps({"type": "broker", "broker": self.broker_id,
                           "time_ms": self.time_ms, "metrics": self.metrics})


@dataclasses.dataclass
class Samples:
    partition_samples: List[PartitionMetricSample]
    broker_samples: List[BrokerMetricSample]


class MetricSampler:
    """SPI (MetricSampler.java:26): fetch samples for assigned partitions in
    a time range."""

    def get_samples(self, cluster: ClusterMetadata,
                    partitions: Sequence[Tuple[str, int]],
                    start_ms: int, end_ms: int,
                    mode: SamplingMode = SamplingMode.ALL) -> Samples:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyntheticWorkloadSampler(MetricSampler):
    """Deterministic synthetic sampler for tests/benchmarks: each partition
    carries a stable per-partition workload (seeded by hash) with optional
    time jitter — the in-memory analogue of the embedded-cluster fixtures."""

    def __init__(self, mean_nw_kb: float = 100.0, mean_disk_mb: float = 100.0,
                 cpu_per_kb: float = 0.001, seed: int = 0):
        self._nw = mean_nw_kb
        self._disk = mean_disk_mb
        self._cpu_per_kb = cpu_per_kb
        self._seed = seed

    def _partition_scale(self, topic: str, partition: int) -> float:
        # crc32, not hash(): builtin str hashing is randomized per process
        # (PYTHONHASHSEED), which made "deterministic" quietly mean
        # "deterministic within one interpreter" — plan sizes, and any test
        # or bench thresholds derived from them, drifted across runs.
        h = zlib.crc32(f"{self._seed}/{topic}/{partition}".encode()) & 0xFFFF
        return 0.25 + 1.5 * (h / 0xFFFF)

    def get_samples(self, cluster, partitions, start_ms, end_ms,
                    mode=SamplingMode.ALL) -> Samples:
        psamples: List[PartitionMetricSample] = []
        bsamples: List[BrokerMetricSample] = []
        by_tp = {p.tp: p for p in cluster.partitions}
        t = end_ms
        want_partitions = mode in (SamplingMode.ALL, SamplingMode.PARTITION_METRICS_ONLY,
                                   SamplingMode.ONGOING_EXECUTION)
        want_brokers = mode in (SamplingMode.ALL, SamplingMode.BROKER_METRICS_ONLY,
                                SamplingMode.ONGOING_EXECUTION)
        # Broker CPU derives from the leaders' workloads, so compute the
        # per-partition rows regardless of mode and only *emit* them when the
        # mode asks for partition samples.
        per_broker_cpu: Dict[int, float] = {}
        if want_partitions or want_brokers:
            for tp in partitions:
                info = by_tp.get(tuple(tp))
                if info is None or info.leader < 0:
                    continue
                s = self._partition_scale(*tp)
                nw_in = self._nw * s
                nw_out = 1.4 * self._nw * s
                cpu = self._cpu_per_kb * (nw_in + nw_out)
                per_broker_cpu[info.leader] = per_broker_cpu.get(info.leader, 0.0) + cpu
                if want_partitions:
                    psamples.append(PartitionMetricSample(
                        topic=tp[0], partition=tp[1], broker_id=info.leader, time_ms=t,
                        metrics={
                            "CPU_USAGE": cpu,
                            "DISK_USAGE": self._disk * s,
                            "LEADER_BYTES_IN": nw_in,
                            "LEADER_BYTES_OUT": nw_out,
                            "PRODUCE_RATE": 10.0 * s,
                            "FETCH_RATE": 14.0 * s,
                            "MESSAGE_IN_RATE": 100.0 * s,
                            "REPLICATION_BYTES_IN_RATE": nw_in * (len(info.replicas) - 1),
                            "REPLICATION_BYTES_OUT_RATE": nw_in * (len(info.replicas) - 1),
                        }))
        if want_brokers:
            for b in cluster.brokers:
                if not b.is_alive:
                    continue
                bsamples.append(BrokerMetricSample(
                    broker_id=b.broker_id, time_ms=t,
                    metrics={
                        "CPU_USAGE": per_broker_cpu.get(b.broker_id, 0.0),
                        "BROKER_REQUEST_QUEUE_SIZE": 1.0,
                        "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT": 0.9,
                        "BROKER_LOG_FLUSH_TIME_MS_999TH": 5.0,
                    }))
        return Samples(psamples, bsamples)


# ---------------------------------------------------------------------------
# Sample stores (SampleStore SPI; checkpoint/resume of derived samples)
# ---------------------------------------------------------------------------

class SampleStore:
    """SPI (sampling/SampleStore.java): persist derived samples and replay
    them on startup — the reference's checkpoint mechanism (SURVEY.md §5)."""

    def store_samples(self, samples: Samples) -> None:
        raise NotImplementedError

    def load_samples(self) -> Samples:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NoopSampleStore(SampleStore):
    def store_samples(self, samples: Samples) -> None:
        pass

    def load_samples(self) -> Samples:
        return Samples([], [])


class InMemorySampleStore(SampleStore):
    def __init__(self):
        self._lock = threading.Lock()
        self._p: List[PartitionMetricSample] = []
        self._b: List[BrokerMetricSample] = []

    def store_samples(self, samples: Samples) -> None:
        with self._lock:
            self._p.extend(samples.partition_samples)
            self._b.extend(samples.broker_samples)

    def load_samples(self) -> Samples:
        with self._lock:
            return Samples(list(self._p), list(self._b))


class FileSampleStore(SampleStore):
    """JSONL append-log store; replay on startup rebuilds aggregation windows
    without waiting (KafkaSampleStore.loadSamples warm-start semantics)."""

    def __init__(self, path: str):
        self._path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def store_samples(self, samples: Samples) -> None:
        with self._lock:
            for s in samples.partition_samples:
                self._f.write(s.to_json() + "\n")
            for s in samples.broker_samples:
                self._f.write(s.to_json() + "\n")
            self._f.flush()

    def load_samples(self) -> Samples:
        out = Samples([], [])
        if not os.path.exists(self._path):
            return out
        with open(self._path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if d["type"] == "partition":
                    out.partition_samples.append(PartitionMetricSample(
                        topic=d["topic"], partition=d["partition"],
                        broker_id=d["broker"], time_ms=d["time_ms"],
                        metrics=d["metrics"]))
                else:
                    out.broker_samples.append(BrokerMetricSample(
                        broker_id=d["broker"], time_ms=d["time_ms"],
                        metrics=d["metrics"]))
        return out

    def close(self) -> None:
        with self._lock:
            self._f.close()


def assign_partitions(cluster: ClusterMetadata, num_fetchers: int
                      ) -> List[List[Tuple[str, int]]]:
    """Topic-granular even spread of partitions over fetchers
    (DefaultMetricSamplerPartitionAssignor semantics)."""
    assignments: List[List[Tuple[str, int]]] = [[] for _ in range(num_fetchers)]
    sizes = [0] * num_fetchers
    topics = sorted(cluster.topics(),
                    key=lambda t: -len(cluster.partitions_for_topic(t)))
    for topic in topics:
        tps = [p.tp for p in cluster.partitions_for_topic(topic)]
        i = sizes.index(min(sizes))
        assignments[i].extend(tps)
        sizes[i] += len(tps)
    return assignments
