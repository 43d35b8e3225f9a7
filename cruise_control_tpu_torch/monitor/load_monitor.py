"""LoadMonitor: sampling orchestration + cluster-model generation.

Parity with the reference's ``LoadMonitor`` (monitor/LoadMonitor.java:78):
owns the partition/broker aggregators, the metadata client, the capacity
resolver and the sample store; fetches samples (optionally via multiple
fetcher assignments — MetricFetcherManager.java:37); answers completeness
queries; and builds the ``TensorClusterModel`` on demand
(``clusterModel(from,to,requirements)`` — LoadMonitor.java:455-520).

Model generation is the object-graph → struct-of-arrays seam: topics,
partitions and brokers are densified to integer ids, aggregated window
values become the replica leader/follower load rows, and
``model.build_model`` pads + places the tensors on the monitor's device
(the card unless the caller asks for ``device="cpu"``).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cruise_control_tpu_torch.common.resources import NUM_RESOURCES, Resource
from cruise_control_tpu_torch.common.tracing import TRACE
from cruise_control_tpu_torch.device import resolve_device
from cruise_control_tpu_torch.model.cpu_model import (DEFAULT_CPU_WEIGHT_OF_FOLLOWER,
                                                follower_cpu_util_from_leader_load)
from cruise_control_tpu_torch.model.tensor_model import BrokerState, TensorClusterModel, build_model
from cruise_control_tpu_torch.monitor.aggregator import AggregationResult, MetricSampleAggregator
from cruise_control_tpu_torch.monitor.capacity import BrokerCapacityResolver, StaticCapacityResolver
from cruise_control_tpu_torch.monitor.metadata import ClusterMetadata, MetadataClient
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF, RESOURCE_TO_METRIC_ID
from cruise_control_tpu_torch.monitor.sampling import (MetricSampler, NoopSampleStore,
                                                 SampleStore, Samples, SamplingMode)


@dataclasses.dataclass(frozen=True)
class ModelCompletenessRequirements:
    """monitor/ModelCompletenessRequirements.java: gates model generation."""

    min_required_num_windows: int = 1
    min_monitored_partitions_percentage: float = 0.0
    include_all_topics: bool = False

    def combine(self, other: "ModelCompletenessRequirements") -> "ModelCompletenessRequirements":
        return ModelCompletenessRequirements(
            min_required_num_windows=max(self.min_required_num_windows,
                                         other.min_required_num_windows),
            min_monitored_partitions_percentage=max(
                self.min_monitored_partitions_percentage,
                other.min_monitored_partitions_percentage),
            include_all_topics=self.include_all_topics or other.include_all_topics)


class NotEnoughValidWindowsError(Exception):
    """monitor: NotEnoughValidWindowsException analogue."""


class LoadMonitorState(enum.Enum):
    """LoadMonitorTaskRunner states (monitor/task/LoadMonitorTaskRunner.java:57)."""

    NOT_STARTED = "not_started"
    RUNNING = "running"
    PAUSED = "paused"
    SAMPLING = "sampling"
    BOOTSTRAPPING = "bootstrapping"
    TRAINING = "training"
    LOADING = "loading"


@dataclasses.dataclass
class ModelGeneration:
    """(metadata generation, aggregator generation) — staleness detection
    (monitor/ModelGeneration.java)."""

    cluster_generation: int
    load_generation: int

    def as_tuple(self) -> Tuple[int, int]:
        return (self.cluster_generation, self.load_generation)


class LoadMonitor:
    def __init__(self,
                 metadata_client: MetadataClient,
                 capacity_resolver: Optional[BrokerCapacityResolver] = None,
                 sample_store: Optional[SampleStore] = None,
                 num_partition_windows: int = 5,
                 partition_window_ms: int = 300_000,
                 num_broker_windows: int = 20,
                 broker_window_ms: int = 300_000,
                 min_samples_per_window: int = 1,
                 max_allowed_extrapolations: int = 5,
                 min_samples_per_broker_window: Optional[int] = None,
                 max_allowed_broker_extrapolations: Optional[int] = None,
                 follower_cpu_ratio: float = DEFAULT_CPU_WEIGHT_OF_FOLLOWER,
                 on_execution_store: Optional[SampleStore] = None,
                 device: Union[str, torch.device] = "cuda"):
        self._device = resolve_device(device)
        self._metadata = metadata_client
        self._capacity = capacity_resolver or StaticCapacityResolver()
        self._store = sample_store or NoopSampleStore()
        self._follower_cpu_ratio = follower_cpu_ratio
        self.partition_aggregator = MetricSampleAggregator(
            num_partition_windows, partition_window_ms, min_samples_per_window,
            max_allowed_extrapolations)
        # The broker aggregator has its own validity knobs
        # (min.samples.per.broker.metrics.window /
        # max.allowed.extrapolations.per.broker, MonitorConfig).
        self.broker_aggregator = MetricSampleAggregator(
            num_broker_windows, broker_window_ms,
            (min_samples_per_broker_window
             if min_samples_per_broker_window is not None
             else min_samples_per_window),
            (max_allowed_broker_extrapolations
             if max_allowed_broker_extrapolations is not None
             else max_allowed_extrapolations))
        self._lock = threading.RLock()
        self._state = LoadMonitorState.NOT_STARTED
        self._sampling_paused = False
        self._pause_reason: Optional[str] = None
        # Execution-time segregation (adjustSamplingModeBeforeExecution,
        # Executor.java:1051-1067 + KafkaPartitionMetricSampleOnExecutionStore):
        # while the executor runs, partition samples are rebalance-biased —
        # they are diverted to this store instead of the aggregator/main
        # store; broker samples keep flowing (the ConcurrencyAdjuster needs
        # live health).
        self._execution_mode = False
        self._on_execution_store = on_execution_store
        # Model-generation semaphore (LoadMonitor.java:92,165): bounds
        # concurrent model builds.
        self._model_semaphore = threading.Semaphore(2)
        self._monitored_pct_cache: Optional[Tuple[Tuple[int, int], float]] = None
        # Sensor registrations (LoadMonitor.java:180-195; Sensors.md:
        # valid-windows, monitored-partitions-percentage,
        # total-monitored-windows, cluster-model-creation-timer).
        from cruise_control_tpu_torch.common.sensors import SENSORS
        SENSORS.gauge("LoadMonitor.valid-windows",
                      lambda: self.partition_aggregator.valid_windows(),
                      help="Metric windows complete enough to model from")
        SENSORS.gauge("LoadMonitor.monitored-partitions-percentage",
                      self.monitored_partitions_percentage,
                      help="Fraction of partitions with valid metric samples")
        SENSORS.gauge("LoadMonitor.total-monitored-windows",
                      lambda: self.partition_aggregator.num_windows,
                      help="Metric windows currently retained")
        self._model_timer = SENSORS.timer(
            "LoadMonitor.cluster-model-creation-timer",
            help="Wall time to build a cluster model from the aggregator")

    # -- lifecycle / state -------------------------------------------------
    def start_up(self, skip_loading_samples: bool = False) -> None:
        """Replay persisted samples to warm the windows
        (LoadMonitor.startUp → KafkaSampleStore.loadSamples)."""
        with self._lock:
            if not skip_loading_samples:
                self._state = LoadMonitorState.LOADING
                self._ingest(self._store.load_samples(), persist=False)
            self._state = LoadMonitorState.RUNNING

    def state(self) -> LoadMonitorState:
        with self._lock:
            if self._sampling_paused:
                return LoadMonitorState.PAUSED
            return self._state

    def pause_sampling(self, reason: str = "") -> None:
        with self._lock:
            self._sampling_paused = True
            self._pause_reason = reason or None

    def resume_sampling(self) -> None:
        with self._lock:
            self._sampling_paused = False
            self._pause_reason = None

    def set_execution_mode(self, active: bool, reason: str = "") -> None:
        """Executor hook: switch sampling to ONGOING_EXECUTION instead of a
        full pause — broker metrics continue (live health for the
        ConcurrencyAdjuster), partition metrics divert to the segregated
        on-execution store.  An operator pause's reason is never clobbered
        (the execution only annotates the reason while nothing else owns it)."""
        with self._lock:
            self._execution_mode = active
            if not self._sampling_paused:
                self._pause_reason = ((reason or "ongoing execution")
                                      if active else None)

    @property
    def pause_reason(self) -> Optional[str]:
        return self._pause_reason

    def model_generation(self) -> ModelGeneration:
        return ModelGeneration(self._metadata.cluster().generation,
                               self.partition_aggregator.generation)

    def generation_changed(self, since) -> bool:
        """Has the model generation advanced past ``since`` (an
        ``as_tuple()`` value; None = no baseline → always True)?  The
        cruise loop's cheap poll predicate — no model build, just two
        counter reads."""
        return since is None or self.model_generation().as_tuple() != tuple(since)

    # -- sampling ----------------------------------------------------------
    def fetch_once(self, sampler: MetricSampler, start_ms: int, end_ms: int,
                   mode: SamplingMode = SamplingMode.ALL) -> int:
        """One sampling pass over all partitions (SamplingTask →
        MetricFetcherManager.fetchMetricSamples).  Returns #samples added."""
        with self._lock:
            if self._sampling_paused:
                return 0
            effective = mode
            if self._execution_mode and mode == SamplingMode.ALL:
                effective = SamplingMode.ONGOING_EXECUTION
        with TRACE.span("monitor.fetch", mode=effective.name) as sp:
            cluster = self._metadata.cluster()
            tps = [p.tp for p in cluster.partitions]
            samples = sampler.get_samples(cluster, tps, start_ms, end_ms,
                                          effective)
            if effective == SamplingMode.ONGOING_EXECUTION:
                n = self._ingest_on_execution(samples)
            else:
                n = self._ingest(samples, persist=True)
            sp.annotate(samples=n)
            return n

    def _ingest_on_execution(self, samples: Samples) -> int:
        """Broker samples flow normally (aggregated AND persisted, so
        broker-window history has no restart gap across a long execution);
        partition samples (biased by the rebalance traffic itself) go only
        to the segregated store."""
        n = self.broker_aggregator.add_samples(
            [(bs.entity, bs.time_ms, bs.metrics) for bs in samples.broker_samples])
        if samples.broker_samples and n:
            self._store.store_samples(Samples(
                partition_samples=[], broker_samples=samples.broker_samples))
        if samples.partition_samples and self._on_execution_store is not None:
            self._on_execution_store.store_samples(Samples(
                partition_samples=samples.partition_samples,
                broker_samples=[]))
        return n

    def bootstrap(self, sampler: MetricSampler, start_ms: int, end_ms: int,
                  step_ms: Optional[int] = None) -> int:
        """Replay a historical range window by window (BootstrapTask)."""
        with self._lock:
            self._state = LoadMonitorState.BOOTSTRAPPING
        step = step_ms or self.partition_aggregator.window_ms
        total = 0
        t = start_ms
        while t < end_ms:
            total += self.fetch_once(sampler, t, min(t + step, end_ms))
            t += step
        with self._lock:
            self._state = LoadMonitorState.RUNNING
        return total

    def _ingest(self, samples: Samples, persist: bool) -> int:
        n = self.partition_aggregator.add_samples(
            [(ps.entity, ps.time_ms, ps.metrics) for ps in samples.partition_samples])
        n += self.broker_aggregator.add_samples(
            [(bs.entity, bs.time_ms, bs.metrics) for bs in samples.broker_samples])
        if persist and n:
            self._store.store_samples(samples)
        return n

    def broker_history(self):
        """The (broker × window × metric) history tensor the device detector
        scores per tick — the broker aggregator's ``AggregationResult``
        (``values`` f32[E, W, M] plus the ``window_valid`` mask and
        ``generation`` stamp the scorer's dispatch cache keys on)."""
        return self.broker_aggregator.aggregate()

    def broker_health_metrics(self) -> Dict[int, Dict[str, float]]:
        """{broker → {metric name → latest collapsed value}} for the
        executor's ConcurrencyAdjuster (Executor.java:335-447 reads live
        request-queue depth / handler idle ratio from the broker metric
        history)."""
        agg = self.broker_aggregator.aggregate()
        out: Dict[int, Dict[str, float]] = {}
        names = [KAFKA_METRIC_DEF.metric_info_by_id(m).name
                 for m in range(agg.collapsed.shape[1])]
        for row, broker_id in enumerate(agg.entities):
            if not agg.entity_valid[row]:
                continue
            out[int(broker_id)] = {
                name: float(agg.collapsed[row, m])
                for m, name in enumerate(names)}
        return out

    # -- completeness ------------------------------------------------------
    def monitored_partitions_percentage(self) -> float:
        # Generation-cached: this is a sensor read on the /state and
        # /metrics hot paths, and a full window aggregation per scrape is a
        # heavyweight recomputation at the 1M-replica scale.
        gen = (self._metadata.cluster().generation,
               self.partition_aggregator.generation)
        cached = self._monitored_pct_cache
        if cached is not None and cached[0] == gen:
            return cached[1]
        agg = self.partition_aggregator.aggregate()
        total = self._metadata.cluster().partition_count()
        pct = float(agg.entity_valid.sum()) / total if total else 0.0
        self._monitored_pct_cache = (gen, pct)
        return pct

    def meets_completeness_requirements(self, req: ModelCompletenessRequirements) -> bool:
        if self.partition_aggregator.valid_windows() < req.min_required_num_windows:
            return False
        return self.monitored_partitions_percentage() >= \
            req.min_monitored_partitions_percentage

    # -- model generation --------------------------------------------------
    def cluster_model(self,
                      requirements: Optional[ModelCompletenessRequirements] = None,
                      allow_capacity_estimation: bool = True,
                      pad_replicas_to: Optional[int] = None) -> TensorClusterModel:
        """Build the tensor cluster model from aggregated partition metrics +
        metadata + capacities (LoadMonitor.clusterModel, LoadMonitor.java:455)."""
        return self.cluster_model_and_naming(requirements, allow_capacity_estimation,
                                             pad_replicas_to)[0]

    def cluster_model_and_naming(
            self, requirements: Optional[ModelCompletenessRequirements] = None,
            allow_capacity_estimation: bool = True,
            pad_replicas_to: Optional[int] = None
    ) -> Tuple[TensorClusterModel, Dict[str, object]]:
        """Model + the dense-id↔name maps derived from the SAME metadata
        snapshot.  Callers that later translate dense indices back to cluster
        ids (proposal renumbering, executor requests) must use this naming,
        not a fresh ``naming()`` read — membership can change mid-operation
        and would silently misaddress every proposal."""
        req = requirements or ModelCompletenessRequirements()
        with self._model_semaphore, self._model_timer.time(), \
                TRACE.span("monitor.cluster_model") as sp:
            cluster = self._metadata.cluster()
            sp.annotate(brokers=len(cluster.brokers),
                        partitions=cluster.partition_count())
            if self.partition_aggregator.valid_windows() < req.min_required_num_windows:
                raise NotEnoughValidWindowsError(
                    f"have {self.partition_aggregator.valid_windows()} valid windows, "
                    f"need {req.min_required_num_windows}")
            agg = self.partition_aggregator.aggregate()
            pct = 0.0
            total = cluster.partition_count()
            if total:
                pct = float(agg.entity_valid.sum()) / total
            if pct < req.min_monitored_partitions_percentage:
                raise NotEnoughValidWindowsError(
                    f"monitored partition percentage {pct:.3f} below "
                    f"{req.min_monitored_partitions_percentage:.3f}")
            model = self._build_model(cluster, agg, allow_capacity_estimation,
                                      pad_replicas_to)
            return model, self.naming_for(cluster)

    def _build_model(self, cluster: ClusterMetadata, agg: AggregationResult,
                     allow_capacity_estimation: bool,
                     pad_replicas_to: Optional[int]) -> TensorClusterModel:
        # Row map from the aggregation snapshot itself (not the live aggregator),
        # so concurrently registered entities cannot index past the arrays.
        entity_rows = {e: i for i, e in enumerate(agg.entities)}

        topics = cluster.topics()
        topic_id = {t: i for i, t in enumerate(topics)}
        broker_ids = sorted(cluster.broker_ids())
        broker_idx = {b: i for i, b in enumerate(broker_ids)}
        racks: Dict[str, int] = {}
        brokers_by_id = {b.broker_id: b for b in cluster.brokers}
        for b in cluster.brokers:
            racks.setdefault(b.rack, len(racks))
        hosts: Dict[str, int] = {}
        for b in cluster.brokers:
            hosts.setdefault(b.host or f"host-{b.broker_id}", len(hosts))

        # Partition table ordered (topic, partition).
        parts = sorted(cluster.partitions, key=lambda p: (topic_id[p.topic], p.partition))
        part_gid = {p.tp: i for i, p in enumerate(parts)}

        rb, rp, rt, rl, roff = [], [], [], [], []
        load_lead, load_foll = [], []
        cpu_id = RESOURCE_TO_METRIC_ID[Resource.CPU]
        nwi_id = RESOURCE_TO_METRIC_ID[Resource.NW_IN]
        nwo_id = RESOURCE_TO_METRIC_ID[Resource.NW_OUT]
        dsk_id = RESOURCE_TO_METRIC_ID[Resource.DISK]
        for p in parts:
            row = entity_rows.get(p.tp)
            if row is not None and agg.entity_valid[row]:
                vals = agg.collapsed[row]
                cpu, nwi = float(vals[cpu_id]), float(vals[nwi_id])
                nwo, dsk = float(vals[nwo_id]), float(vals[dsk_id])
            else:
                cpu = nwi = nwo = dsk = 0.0
            f_cpu = follower_cpu_util_from_leader_load(nwi, nwo, cpu,
                                                       self._follower_cpu_ratio)
            lead_row = np.array([cpu, nwi, nwo, dsk], np.float32)
            foll_row = np.array([f_cpu, nwi, 0.0, dsk], np.float32)
            gid = part_gid[p.tp]
            for b in p.replicas:
                rb.append(broker_idx[b])
                rp.append(gid)
                rt.append(topic_id[p.topic])
                rl.append(b == p.leader)
                roff.append(b in p.offline_replicas)
                load_lead.append(lead_row)
                load_foll.append(foll_row)

        bcap = np.zeros((len(broker_ids), NUM_RESOURCES), np.float32)
        brack = np.zeros(len(broker_ids), np.int32)
        bhost = np.zeros(len(broker_ids), np.int32)
        bstate = np.zeros(len(broker_ids), np.int8)
        for b_id, i in broker_idx.items():
            info = brokers_by_id[b_id]
            cap = self._capacity.capacity_for_broker(
                info.rack, info.host, b_id, allow_capacity_estimation)
            bcap[i] = cap.as_row()
            brack[i] = racks[info.rack]
            bhost[i] = hosts[info.host or f"host-{b_id}"]
            bstate[i] = BrokerState.ALIVE if info.is_alive else BrokerState.DEAD

        model = build_model(
            replica_broker=np.asarray(rb, np.int32),
            replica_partition=np.asarray(rp, np.int32),
            replica_topic=np.asarray(rt, np.int32),
            replica_is_leader=np.asarray(rl, bool),
            replica_load_leader=np.stack(load_lead) if load_lead else
            np.zeros((0, NUM_RESOURCES), np.float32),
            replica_load_follower=np.stack(load_foll) if load_foll else
            np.zeros((0, NUM_RESOURCES), np.float32),
            broker_capacity=bcap,
            broker_rack=brack,
            broker_host=bhost,
            broker_state=bstate,
            partition_topic=np.asarray([topic_id[p.topic] for p in parts], np.int32),
            pad_replicas_to=pad_replicas_to,
            device=self._device,
        )
        # Offline markers from metadata (offline logdir replicas).
        if any(roff):
            off = np.zeros(model.num_replicas_padded, bool)
            off[: len(roff)] = roff
            model = model.replace(replica_offline=torch.from_numpy(off).to(self._device))
        return model

    # -- naming maps for the API layer ------------------------------------
    def naming(self) -> Dict[str, object]:
        """Dense-id ↔ name maps from the CURRENT metadata snapshot.  For
        translating a model's dense indices use the naming returned by
        ``cluster_model_and_naming`` (same snapshot as the model)."""
        return self.naming_for(self._metadata.cluster())

    @staticmethod
    def naming_for(cluster: ClusterMetadata) -> Dict[str, object]:
        topics = cluster.topics()
        topic_id = {t: i for i, t in enumerate(topics)}
        parts = sorted(cluster.partitions,
                       key=lambda p: (topic_id[p.topic], p.partition))
        return {
            "topics": topics,
            "partitions": [p.tp for p in parts],
            "brokers": sorted(cluster.broker_ids()),
        }
