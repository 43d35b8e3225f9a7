"""Framework configuration definitions, grouped per subsystem.

Parity with the reference's config/constants/*.java groups (MonitorConfig,
AnalyzerConfig, ExecutorConfig, AnomalyDetectorConfig, WebServerConfig —
aggregated by config/KafkaCruiseControlConfig.java:37).  Defaults mirror
config/cruisecontrol.properties where the reference ships one.
"""

from __future__ import annotations

from cruise_control_tpu_torch.config.configdef import ConfigDef, Importance, Range, Type

# ---------------------------------------------------------------------------
# Analyzer group (reference: config/constants/AnalyzerConfig.java)
# ---------------------------------------------------------------------------

DEFAULT_GOALS_CONFIG = "default.goals"
GOALS_CONFIG = "goals"
HARD_GOALS_CONFIG = "hard.goals"
INTRA_BROKER_GOALS_CONFIG = "intra.broker.goals"
CPU_BALANCE_THRESHOLD_CONFIG = "cpu.balance.threshold"
DISK_BALANCE_THRESHOLD_CONFIG = "disk.balance.threshold"
NETWORK_INBOUND_BALANCE_THRESHOLD_CONFIG = "network.inbound.balance.threshold"
NETWORK_OUTBOUND_BALANCE_THRESHOLD_CONFIG = "network.outbound.balance.threshold"
REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG = "replica.count.balance.threshold"
LEADER_REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG = "leader.replica.count.balance.threshold"
TOPIC_REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG = "topic.replica.count.balance.threshold"
CPU_CAPACITY_THRESHOLD_CONFIG = "cpu.capacity.threshold"
DISK_CAPACITY_THRESHOLD_CONFIG = "disk.capacity.threshold"
NETWORK_INBOUND_CAPACITY_THRESHOLD_CONFIG = "network.inbound.capacity.threshold"
NETWORK_OUTBOUND_CAPACITY_THRESHOLD_CONFIG = "network.outbound.capacity.threshold"
CPU_LOW_UTILIZATION_THRESHOLD_CONFIG = "cpu.low.utilization.threshold"
DISK_LOW_UTILIZATION_THRESHOLD_CONFIG = "disk.low.utilization.threshold"
NETWORK_INBOUND_LOW_UTILIZATION_THRESHOLD_CONFIG = "network.inbound.low.utilization.threshold"
NETWORK_OUTBOUND_LOW_UTILIZATION_THRESHOLD_CONFIG = "network.outbound.low.utilization.threshold"
MAX_REPLICAS_PER_BROKER_CONFIG = "max.replicas.per.broker"
PROPOSAL_EXPIRATION_MS_CONFIG = "proposal.expiration.ms"
NUM_PROPOSAL_PRECOMPUTE_THREADS_CONFIG = "num.proposal.precompute.threads"
MAX_CANDIDATES_PER_STEP_CONFIG = "max.candidates.per.step"
MAX_OPTIMIZER_STEPS_CONFIG = "max.optimizer.steps"
MOVES_PER_STEP_CONFIG = "moves.per.step"
FAST_MODE_PER_BROKER_MOVE_TIMEOUT_MS_CONFIG = "fast.mode.per.broker.move.timeout.ms"
ALLOW_CAPACITY_ESTIMATION_CONFIG = "allow.capacity.estimation"
TOPICS_EXCLUDED_FROM_PARTITION_MOVEMENT_CONFIG = "topics.excluded.from.partition.movement"
GOAL_BALANCEDNESS_PRIORITY_WEIGHT_CONFIG = "goal.balancedness.priority.weight"
GOAL_BALANCEDNESS_STRICTNESS_WEIGHT_CONFIG = "goal.balancedness.strictness.weight"
OVERPROVISIONED_MAX_REPLICAS_PER_BROKER_CONFIG = "overprovisioned.max.replicas.per.broker"
OVERPROVISIONED_MIN_BROKERS_CONFIG = "overprovisioned.min.brokers"
OVERPROVISIONED_MIN_EXTRA_RACKS_CONFIG = "overprovisioned.min.extra.racks"
COMPILE_CACHE_DIR_CONFIG = "compile.cache.dir"
COMPILE_CACHE_WARMUP_CONFIG = "compile.cache.warmup"
TPU_COMPILE_CEILING_CONFIG = "tpu.compile.ceiling"
ANALYZER_FLIGHT_RECORDER_CONFIG = "analyzer.flight.recorder"
WARM_START_ENABLED_CONFIG = "analyzer.warm.start.enabled"
WARM_START_DELTA_THRESHOLD_CONFIG = "analyzer.warm.start.delta.threshold"
CRUISE_ENABLED_CONFIG = "analyzer.cruise.enabled"
CRUISE_INTERVAL_MS_CONFIG = "analyzer.cruise.interval.ms"

DEFAULT_GOAL_NAMES = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
    "ReplicaDistributionGoal",
    "PotentialNwOutGoal",
    "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal",
    "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal",
    "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal",
    "LeaderBytesInDistributionGoal",
]

# Every registered goal (GOAL_SPECS) — the full 21-goal surface of the
# reference (config/cruisecontrol.properties:98-126 lists the same set).
SUPPORTED_GOAL_NAMES = DEFAULT_GOAL_NAMES + [
    "RackAwareDistributionGoal",
    "MinTopicLeadersPerBrokerGoal",
    "PreferredLeaderElectionGoal",
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
    "KafkaAssignerEvenRackAwareGoal",
    "KafkaAssignerDiskUsageDistributionGoal",
]

HARD_GOAL_NAMES = [
    "RackAwareGoal",
    "ReplicaCapacityGoal",
    "DiskCapacityGoal",
    "NetworkInboundCapacityGoal",
    "NetworkOutboundCapacityGoal",
    "CpuCapacityGoal",
]

INTRA_BROKER_GOAL_NAMES = [
    "IntraBrokerDiskCapacityGoal",
    "IntraBrokerDiskUsageDistributionGoal",
]


def analyzer_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define(DEFAULT_GOALS_CONFIG, Type.LIST, DEFAULT_GOAL_NAMES, importance=Importance.HIGH,
             doc="Goals optimized for precomputed proposals, in priority order.", group="analyzer")
    d.define(GOALS_CONFIG, Type.LIST, SUPPORTED_GOAL_NAMES, importance=Importance.HIGH,
             doc="All supported goals.", group="analyzer")
    d.define(HARD_GOALS_CONFIG, Type.LIST, HARD_GOAL_NAMES, importance=Importance.HIGH,
             doc="Goals that must be satisfied for a proposal to be valid.", group="analyzer")
    d.define(INTRA_BROKER_GOALS_CONFIG, Type.LIST, INTRA_BROKER_GOAL_NAMES, importance=Importance.MEDIUM,
             doc="Goals for intra-broker (cross-disk) rebalancing.", group="analyzer")
    for key in (CPU_BALANCE_THRESHOLD_CONFIG, DISK_BALANCE_THRESHOLD_CONFIG,
                NETWORK_INBOUND_BALANCE_THRESHOLD_CONFIG, NETWORK_OUTBOUND_BALANCE_THRESHOLD_CONFIG,
                REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG, LEADER_REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG,
                TOPIC_REPLICA_COUNT_BALANCE_THRESHOLD_CONFIG):
        d.define(key, Type.DOUBLE, 1.1, Range.at_least(1.0), Importance.HIGH,
                 doc="Maximum allowed ratio of per-broker utilization/count to cluster average.",
                 group="analyzer")
    d.define(CPU_CAPACITY_THRESHOLD_CONFIG, Type.DOUBLE, 0.7, Range.between(0.0, 1.0), Importance.HIGH,
             doc="Max fraction of CPU capacity usable by a broker.", group="analyzer")
    for key in (DISK_CAPACITY_THRESHOLD_CONFIG, NETWORK_INBOUND_CAPACITY_THRESHOLD_CONFIG,
                NETWORK_OUTBOUND_CAPACITY_THRESHOLD_CONFIG):
        d.define(key, Type.DOUBLE, 0.8, Range.between(0.0, 1.0), Importance.HIGH,
                 doc="Max fraction of capacity usable by a broker.", group="analyzer")
    for key in (CPU_LOW_UTILIZATION_THRESHOLD_CONFIG, DISK_LOW_UTILIZATION_THRESHOLD_CONFIG,
                NETWORK_INBOUND_LOW_UTILIZATION_THRESHOLD_CONFIG,
                NETWORK_OUTBOUND_LOW_UTILIZATION_THRESHOLD_CONFIG):
        d.define(key, Type.DOUBLE, 0.0, Range.between(0.0, 1.0), Importance.MEDIUM,
                 doc="Cluster considered over-provisioned for the resource below this utilization.",
                 group="analyzer")
    d.define(MAX_REPLICAS_PER_BROKER_CONFIG, Type.LONG, 10000, Range.at_least(1), Importance.MEDIUM,
             doc="Hard cap on replicas per broker (ReplicaCapacityGoal).", group="analyzer")
    d.define(PROPOSAL_EXPIRATION_MS_CONFIG, Type.LONG, 60000, Range.at_least(0), Importance.MEDIUM,
             doc="Precomputed proposals are invalidated after this long.", group="analyzer")
    d.define(NUM_PROPOSAL_PRECOMPUTE_THREADS_CONFIG, Type.INT, 1, Range.at_least(0), Importance.LOW,
             doc="Number of background proposal precompute threads (0 disables).",
             group="analyzer")
    d.define(MAX_CANDIDATES_PER_STEP_CONFIG, Type.INT, 16384, Range.at_least(1), Importance.MEDIUM,
             doc="Candidate balancing actions scored per batched optimizer step (TPU batch size).",
             group="analyzer")
    d.define(MAX_OPTIMIZER_STEPS_CONFIG, Type.INT, 4096, Range.at_least(1), Importance.MEDIUM,
             doc="Upper bound on batched greedy steps per goal.", group="analyzer")
    d.define(MOVES_PER_STEP_CONFIG, Type.INT, 128, Range.at_least(1), Importance.MEDIUM,
             doc="Max actions one broker may participate in per batched step "
                 "(selection rounds x subround lanes).", group="analyzer")
    d.define(FAST_MODE_PER_BROKER_MOVE_TIMEOUT_MS_CONFIG, Type.LONG, 500, Range.at_least(1),
             Importance.LOW, doc="Per-broker move timeout in fast mode.", group="analyzer")
    d.define(ALLOW_CAPACITY_ESTIMATION_CONFIG, Type.BOOLEAN, True, importance=Importance.MEDIUM,
             doc="Permit broker-capacity estimation when exact capacity is unavailable.",
             group="analyzer")
    d.define(TOPICS_EXCLUDED_FROM_PARTITION_MOVEMENT_CONFIG, Type.STRING, "", importance=Importance.MEDIUM,
             doc="Regex of topics whose replicas must not move.", group="analyzer")
    d.define(GOAL_BALANCEDNESS_PRIORITY_WEIGHT_CONFIG, Type.DOUBLE, 1.1, Range.at_least(1.0),
             Importance.LOW, doc="Balancedness weight multiplier by goal priority.", group="analyzer")
    d.define(GOAL_BALANCEDNESS_STRICTNESS_WEIGHT_CONFIG, Type.DOUBLE, 1.5, Range.at_least(1.0),
             Importance.LOW, doc="Balancedness weight multiplier for hard goals.", group="analyzer")
    d.define(OVERPROVISIONED_MAX_REPLICAS_PER_BROKER_CONFIG, Type.LONG, 1500, Range.at_least(0),
             Importance.LOW, doc="Replica ceiling used when emitting over-provisioned verdicts.",
             group="analyzer")
    d.define(OVERPROVISIONED_MIN_BROKERS_CONFIG, Type.INT, 3, Range.at_least(1), Importance.LOW,
             doc="Minimum broker count any over-provisioned recommendation must keep.", group="analyzer")
    d.define(OVERPROVISIONED_MIN_EXTRA_RACKS_CONFIG, Type.INT, 2, Range.at_least(0), Importance.LOW,
             doc="Extra racks beyond max RF any over-provisioned recommendation must keep.",
             group="analyzer")
    d.define(COMPILE_CACHE_DIR_CONFIG, Type.STRING, "", importance=Importance.MEDIUM,
             doc="Directory for JAX's persistent compilation cache (compiled optimizer "
                 "programs survive process restarts).  Empty selects the default under "
                 "the app data dir; the CRUISE_COMPILE_CACHE_DIR env var overrides; "
                 "'off' disables persistence.", group="analyzer")
    d.define(COMPILE_CACHE_WARMUP_CONFIG, Type.BOOLEAN, False, importance=Importance.LOW,
             doc="Compile the default goal stack against the current cluster shape at "
                 "startup so the first rebalance request pays no compile wait (cheap "
                 "when the persistent compile cache is already warm).", group="analyzer")
    d.define(TPU_COMPILE_CEILING_CONFIG, Type.STRING, "off", importance=Importance.LOW,
             doc="Candidate-batch compile ceiling gate (propagated to the "
                 "CRUISE_TPU_COMPILE_CEILING env var): 'off' (default) never caps, "
                 "'auto' caps S*D batches at 32768 on the tpu backend (set this for "
                 "deployments on a tunneled TPU, whose remote-compile service hangs "
                 "on wide programs), an integer imposes that cap on any backend. "
                 "Clamps are counted by GoalOptimizer.compile-ceiling-clamps.",
             group="analyzer")
    d.define(ANALYZER_FLIGHT_RECORDER_CONFIG, Type.BOOLEAN, False, importance=Importance.LOW,
             doc="Enable the solve flight recorder (propagated to the "
                 "CRUISE_FLIGHT_RECORDER env var): every optimizer chunk returns "
                 "a per-step telemetry buffer (actions, frontier size, repair "
                 "activity, best score, action kind) piggybacked on its existing "
                 "boundary fetch — zero extra dispatches or host round trips.  "
                 "Surfaced via GET /flight, analyzer.goal trace spans, and the "
                 "GoalOptimizer.actions-per-step / steps-to-90pct-actions "
                 "sensors.", group="analyzer")
    d.define(WARM_START_ENABLED_CONFIG, Type.BOOLEAN, False, importance=Importance.MEDIUM,
             doc="Seed request-path solves from the standing proposal when the "
                 "host-side model-delta probe reports a small enough change: a "
                 "zero-delta request serves the standing proposals after one "
                 "on-device confirm sweep (no fixpoint dispatch), a small delta "
                 "warm-starts the fixpoint from the previously-converged "
                 "placement.  Off: requests solve cold, bit-identical to the "
                 "pre-warm-start behavior.  The cruise loop always refreshes "
                 "warm regardless of this flag.", group="analyzer")
    d.define(WARM_START_DELTA_THRESHOLD_CONFIG, Type.DOUBLE, 0.05, Range.between(0.0, 1.0),
             Importance.LOW,
             doc="Max relative load delta (changed-load / total-load) for which a "
                 "warm-started solve is attempted; larger deltas solve cold.",
             group="analyzer")
    d.define(CRUISE_ENABLED_CONFIG, Type.BOOLEAN, False, importance=Importance.MEDIUM,
             doc="Run the cruise loop: a background thread that keeps ONE standing "
                 "proposal per cluster model, re-optimizing (warm-started) whenever "
                 "the load monitor's model generation advances, so /proposals and "
                 "/rebalance answer from the standing result instead of solving "
                 "from zero.", group="analyzer")
    d.define(CRUISE_INTERVAL_MS_CONFIG, Type.LONG, 30_000, Range.at_least(100),
             Importance.LOW,
             doc="Cruise loop poll interval: how often the loop checks whether the "
                 "model generation advanced past the standing proposal.",
             group="analyzer")
    return d


# ---------------------------------------------------------------------------
# Monitor group (reference: config/constants/MonitorConfig.java)
# ---------------------------------------------------------------------------

PARTITION_METRICS_WINDOW_MS_CONFIG = "partition.metrics.window.ms"
NUM_PARTITION_METRICS_WINDOWS_CONFIG = "num.partition.metrics.windows"
BROKER_METRICS_WINDOW_MS_CONFIG = "broker.metrics.window.ms"
NUM_BROKER_METRICS_WINDOWS_CONFIG = "num.broker.metrics.windows"
MIN_SAMPLES_PER_PARTITION_METRICS_WINDOW_CONFIG = "min.samples.per.partition.metrics.window"
MIN_SAMPLES_PER_BROKER_METRICS_WINDOW_CONFIG = "min.samples.per.broker.metrics.window"
METRIC_SAMPLING_INTERVAL_MS_CONFIG = "metric.sampling.interval.ms"
MIN_VALID_PARTITION_RATIO_CONFIG = "min.valid.partition.ratio"
MAX_ALLOWED_EXTRAPOLATIONS_PER_PARTITION_CONFIG = "max.allowed.extrapolations.per.partition"
MAX_ALLOWED_EXTRAPOLATIONS_PER_BROKER_CONFIG = "max.allowed.extrapolations.per.broker"
BROKER_CAPACITY_CONFIG_RESOLVER_CLASS_CONFIG = "broker.capacity.config.resolver.class"
CAPACITY_CONFIG_FILE_CONFIG = "capacity.config.file"
SAMPLE_STORE_CLASS_CONFIG = "sample.store.class"
METRIC_SAMPLER_CLASS_CONFIG = "metric.sampler.class"
SKIP_LOADING_SAMPLES_CONFIG = "skip.loading.samples"
MONITOR_STATE_UPDATE_INTERVAL_MS_CONFIG = "monitor.state.update.interval.ms"
BOOTSTRAP_SERVERS_CONFIG = "bootstrap.servers"


def monitor_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define(PARTITION_METRICS_WINDOW_MS_CONFIG, Type.LONG, 300000, Range.at_least(1), Importance.HIGH,
             doc="Partition metric window span.", group="monitor")
    d.define(NUM_PARTITION_METRICS_WINDOWS_CONFIG, Type.INT, 5, Range.at_least(1), Importance.HIGH,
             doc="Number of partition metric windows retained.", group="monitor")
    d.define(BROKER_METRICS_WINDOW_MS_CONFIG, Type.LONG, 300000, Range.at_least(1), Importance.HIGH,
             doc="Broker metric window span.", group="monitor")
    d.define(NUM_BROKER_METRICS_WINDOWS_CONFIG, Type.INT, 20, Range.at_least(1), Importance.HIGH,
             doc="Number of broker metric windows retained.", group="monitor")
    d.define(MIN_SAMPLES_PER_PARTITION_METRICS_WINDOW_CONFIG, Type.INT, 1, Range.at_least(1),
             Importance.MEDIUM, doc="Samples required for a partition window to be valid.", group="monitor")
    d.define(MIN_SAMPLES_PER_BROKER_METRICS_WINDOW_CONFIG, Type.INT, 1, Range.at_least(1),
             Importance.MEDIUM, doc="Samples required for a broker window to be valid.", group="monitor")
    d.define(METRIC_SAMPLING_INTERVAL_MS_CONFIG, Type.LONG, 120000, Range.at_least(1), Importance.HIGH,
             doc="Sampling cadence.", group="monitor")
    d.define(MIN_VALID_PARTITION_RATIO_CONFIG, Type.DOUBLE, 0.95, Range.between(0.0, 1.0),
             Importance.HIGH, doc="Minimum monitored-partition ratio for model generation.", group="monitor")
    d.define(MAX_ALLOWED_EXTRAPOLATIONS_PER_PARTITION_CONFIG, Type.INT, 5, Range.at_least(0),
             Importance.MEDIUM, doc="Extrapolation budget per partition.", group="monitor")
    d.define(MAX_ALLOWED_EXTRAPOLATIONS_PER_BROKER_CONFIG, Type.INT, 5, Range.at_least(0),
             Importance.MEDIUM, doc="Extrapolation budget per broker.", group="monitor")
    d.define(BROKER_CAPACITY_CONFIG_RESOLVER_CLASS_CONFIG, Type.STRING,
             "cruise_control_tpu_torch.monitor.capacity.StaticCapacityResolver",
             importance=Importance.MEDIUM,
             doc="Capacity resolver plugin class (a non-empty "
                 "capacity.config.file selects FileCapacityResolver instead).",
             group="monitor")
    d.define(CAPACITY_CONFIG_FILE_CONFIG, Type.STRING, "", importance=Importance.MEDIUM,
             doc="Path to the JSON broker-capacity file.", group="monitor")
    d.define(SAMPLE_STORE_CLASS_CONFIG, Type.STRING,
             "cruise_control_tpu_torch.monitor.sampling.NoopSampleStore",
             importance=Importance.MEDIUM,
             doc="Sample store plugin class (with bootstrap.servers the app "
                 "binds cruise_control_tpu_torch.kafka.sample_store.KafkaSampleStore).",
             group="monitor")
    d.define(METRIC_SAMPLER_CLASS_CONFIG, Type.STRING,
             "cruise_control_tpu_torch.monitor.sampling.SyntheticWorkloadSampler",
             importance=Importance.MEDIUM,
             doc="Metric sampler plugin class (with bootstrap.servers the app "
                 "binds cruise_control_tpu_torch.kafka.sampler.KafkaMetricSampler).",
             group="monitor")
    d.define(BOOTSTRAP_SERVERS_CONFIG, Type.LIST, [], importance=Importance.HIGH,
             doc="host:port Kafka bootstrap endpoints.  Non-empty selects the "
                 "wire-protocol production bindings (KafkaClusterAdmin, "
                 "KafkaMetricSampler, KafkaSampleStore, metadata refresh); "
                 "empty runs fully in-memory.", group="monitor")
    d.define(SKIP_LOADING_SAMPLES_CONFIG, Type.BOOLEAN, False, importance=Importance.LOW,
             doc="Skip replaying persisted samples on startup.", group="monitor")
    d.define(MONITOR_STATE_UPDATE_INTERVAL_MS_CONFIG, Type.LONG, 30000, Range.at_least(1),
             Importance.LOW, doc="Sensor update cadence.", group="monitor")
    return d


# ---------------------------------------------------------------------------
# Executor group (reference: config/constants/ExecutorConfig.java)
# ---------------------------------------------------------------------------

NUM_CONCURRENT_PARTITION_MOVEMENTS_PER_BROKER_CONFIG = "num.concurrent.partition.movements.per.broker"
NUM_CONCURRENT_INTRA_BROKER_PARTITION_MOVEMENTS_CONFIG = "num.concurrent.intra.broker.partition.movements"
NUM_CONCURRENT_LEADER_MOVEMENTS_CONFIG = "num.concurrent.leader.movements"
MAX_NUM_CLUSTER_MOVEMENTS_CONFIG = "max.num.cluster.movements"
MAX_NUM_CLUSTER_PARTITION_MOVEMENTS_CONFIG = "max.num.cluster.partition.movements"
EXECUTION_PROGRESS_CHECK_INTERVAL_MS_CONFIG = "execution.progress.check.interval.ms"
DEFAULT_REPLICATION_THROTTLE_CONFIG = "default.replication.throttle"
REPLICA_MOVEMENT_STRATEGIES_CONFIG = "replica.movement.strategies"
DEFAULT_REPLICA_MOVEMENT_STRATEGIES_CONFIG = "default.replica.movement.strategies"
EXECUTOR_CONCURRENCY_ADJUSTER_ENABLED_CONFIG = "concurrency.adjuster.enabled"
CONCURRENCY_ADJUSTER_INTERVAL_MS_CONFIG = "concurrency.adjuster.interval.ms"
CONCURRENCY_ADJUSTER_MAX_PARTITION_MOVEMENTS_PER_BROKER_CONFIG = \
    "concurrency.adjuster.max.partition.movements.per.broker"
CONCURRENCY_ADJUSTER_MIN_PARTITION_MOVEMENTS_PER_BROKER_CONFIG = \
    "concurrency.adjuster.min.partition.movements.per.broker"
LEADER_MOVEMENT_TIMEOUT_MS_CONFIG = "leader.movement.timeout.ms"
REMOVED_BROKERS_RETENTION_MS_CONFIG = "removed.brokers.retention.ms"
DEMOTED_BROKERS_RETENTION_MS_CONFIG = "demoted.brokers.retention.ms"


def executor_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define(NUM_CONCURRENT_PARTITION_MOVEMENTS_PER_BROKER_CONFIG, Type.INT, 10, Range.at_least(1),
             Importance.HIGH, doc="Max concurrent inter-broker replica movements per broker.",
             group="executor")
    d.define(NUM_CONCURRENT_INTRA_BROKER_PARTITION_MOVEMENTS_CONFIG, Type.INT, 2, Range.at_least(1),
             Importance.MEDIUM, doc="Max concurrent intra-broker (disk) movements per broker.",
             group="executor")
    d.define(NUM_CONCURRENT_LEADER_MOVEMENTS_CONFIG, Type.INT, 1000, Range.at_least(1),
             Importance.MEDIUM, doc="Max leadership movements per batch.", group="executor")
    d.define(MAX_NUM_CLUSTER_MOVEMENTS_CONFIG, Type.INT, 1250, Range.at_least(1), Importance.MEDIUM,
             doc="Global cap on in-flight movements cluster-wide.", group="executor")
    d.define(MAX_NUM_CLUSTER_PARTITION_MOVEMENTS_CONFIG, Type.INT, 1250, Range.at_least(1),
             Importance.MEDIUM, doc="Global cap on in-flight partition movements.", group="executor")
    d.define(EXECUTION_PROGRESS_CHECK_INTERVAL_MS_CONFIG, Type.LONG, 10000, Range.at_least(1),
             Importance.MEDIUM, doc="Poll interval for in-flight task progress.", group="executor")
    d.define(DEFAULT_REPLICATION_THROTTLE_CONFIG, Type.LONG, -1, importance=Importance.MEDIUM,
             doc="Replication throttle in bytes/sec (-1 = no throttle).", group="executor")
    d.define(REPLICA_MOVEMENT_STRATEGIES_CONFIG, Type.LIST,
             ["PrioritizeMinIsrWithOfflineReplicasStrategy", "PostponeUrpReplicaMovementStrategy",
              "PrioritizeLargeReplicaMovementStrategy", "PrioritizeSmallReplicaMovementStrategy",
              "BaseReplicaMovementStrategy"],
             importance=Importance.LOW, doc="Supported replica movement strategies.", group="executor")
    d.define(DEFAULT_REPLICA_MOVEMENT_STRATEGIES_CONFIG, Type.LIST, ["BaseReplicaMovementStrategy"],
             importance=Importance.LOW, doc="Default strategy chain.", group="executor")
    d.define(EXECUTOR_CONCURRENCY_ADJUSTER_ENABLED_CONFIG, Type.BOOLEAN, False,
             importance=Importance.LOW, doc="Auto-scale movement concurrency from broker metrics.",
             group="executor")
    d.define(CONCURRENCY_ADJUSTER_INTERVAL_MS_CONFIG, Type.LONG, 360000, Range.at_least(1),
             Importance.LOW, doc="Concurrency adjuster cadence.", group="executor")
    d.define(CONCURRENCY_ADJUSTER_MAX_PARTITION_MOVEMENTS_PER_BROKER_CONFIG, Type.INT, 12,
             Range.at_least(1), Importance.LOW, doc="Upper bound for auto-adjusted concurrency.",
             group="executor")
    d.define(CONCURRENCY_ADJUSTER_MIN_PARTITION_MOVEMENTS_PER_BROKER_CONFIG, Type.INT, 1,
             Range.at_least(1), Importance.LOW, doc="Lower bound for auto-adjusted concurrency.",
             group="executor")
    d.define(LEADER_MOVEMENT_TIMEOUT_MS_CONFIG, Type.LONG, 180000, Range.at_least(1), Importance.LOW,
             doc="Timeout for a leadership movement batch.", group="executor")
    d.define(REMOVED_BROKERS_RETENTION_MS_CONFIG, Type.LONG, 86400000, Range.at_least(0),
             Importance.LOW, doc="How long removed brokers stay excluded from placement.",
             group="executor")
    d.define(DEMOTED_BROKERS_RETENTION_MS_CONFIG, Type.LONG, 86400000, Range.at_least(0),
             Importance.LOW, doc="How long demoted brokers stay excluded from leadership.",
             group="executor")
    return d


# ---------------------------------------------------------------------------
# Anomaly detector group (reference: config/constants/AnomalyDetectorConfig.java)
# ---------------------------------------------------------------------------

ANOMALY_DETECTION_INTERVAL_MS_CONFIG = "anomaly.detection.interval.ms"
ANOMALY_DETECTION_GOALS_CONFIG = "anomaly.detection.goals"
ANOMALY_NOTIFIER_CLASS_CONFIG = "anomaly.notifier.class"
SELF_HEALING_ENABLED_CONFIG = "self.healing.enabled"
BROKER_FAILURE_ALERT_THRESHOLD_MS_CONFIG = "broker.failure.alert.threshold.ms"
BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS_CONFIG = "broker.failure.self.healing.threshold.ms"
METRIC_ANOMALY_FINDER_CLASSES_CONFIG = "metric.anomaly.finder.class"
SLOW_BROKER_DEMOTION_SCORE_CONFIG = "slow.broker.demotion.score"
SLOW_BROKER_DECOMMISSION_SCORE_CONFIG = "slow.broker.decommission.score"
SLOW_BROKER_BYTES_IN_RATE_DETECTION_THRESHOLD_CONFIG = "slow.broker.bytes.in.rate.detection.threshold"
SLOW_BROKER_LOG_FLUSH_TIME_THRESHOLD_MS_CONFIG = "slow.broker.log.flush.time.threshold.ms"
SLOW_BROKER_METRIC_HISTORY_PERCENTILE_THRESHOLD_CONFIG = "slow.broker.metric.history.percentile.threshold"
SLOW_BROKER_METRIC_HISTORY_MARGIN_CONFIG = "slow.broker.metric.history.margin"
SLOW_BROKER_PEER_METRIC_PERCENTILE_THRESHOLD_CONFIG = "slow.broker.peer.metric.percentile.threshold"
SLOW_BROKER_PEER_METRIC_MARGIN_CONFIG = "slow.broker.peer.metric.margin"
SELF_HEALING_EXCLUDE_RECENTLY_DEMOTED_BROKERS_CONFIG = "self.healing.exclude.recently.demoted.brokers"
SELF_HEALING_EXCLUDE_RECENTLY_REMOVED_BROKERS_CONFIG = "self.healing.exclude.recently.removed.brokers"
TOPIC_ANOMALY_FINDER_CLASSES_CONFIG = "topic.anomaly.finder.class"
SELF_HEALING_PARTITION_SIZE_THRESHOLD_MB_CONFIG = \
    "self.healing.partition.size.threshold.mb"
METRIC_ANOMALY_PERCENTILE_UPPER_THRESHOLD_CONFIG = \
    "metric.anomaly.percentile.upper.threshold"
METRIC_ANOMALY_UPPER_MARGIN_CONFIG = "metric.anomaly.upper.margin"
SELF_HEALING_TARGET_TOPIC_REPLICATION_FACTOR_CONFIG = "self.healing.target.topic.replication.factor"
PROVISIONER_CLASS_CONFIG = "provisioner.class"
NUM_CACHED_RECENT_ANOMALY_STATES_CONFIG = "num.cached.recent.anomaly.states"
ANOMALY_DETECTOR_DEVICE_SCORING_CONFIG = "anomaly.detector.device.scoring"


def anomaly_detector_config_def() -> ConfigDef:
    d = ConfigDef()
    d.define(ANOMALY_DETECTION_INTERVAL_MS_CONFIG, Type.LONG, 300000, Range.at_least(1),
             Importance.HIGH, doc="Detector cadence.", group="detector")
    d.define(ANOMALY_DETECTION_GOALS_CONFIG, Type.LIST,
             ["RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal"],
             importance=Importance.HIGH, doc="Goals checked by the goal-violation detector.",
             group="detector")
    d.define(ANOMALY_NOTIFIER_CLASS_CONFIG, Type.STRING,
             "cruise_control_tpu_torch.detector.notifier.SelfHealingNotifier",
             importance=Importance.MEDIUM, doc="Anomaly notifier plugin.", group="detector")
    d.define(SELF_HEALING_ENABLED_CONFIG, Type.BOOLEAN, False, importance=Importance.HIGH,
             doc="Master switch for self-healing of all anomaly types.", group="detector")
    d.define(BROKER_FAILURE_ALERT_THRESHOLD_MS_CONFIG, Type.LONG, 900000, Range.at_least(0),
             Importance.MEDIUM, doc="Alert after a broker has been down this long.", group="detector")
    d.define(BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS_CONFIG, Type.LONG, 1800000, Range.at_least(0),
             Importance.MEDIUM, doc="Self-heal after a broker has been down this long.",
             group="detector")
    d.define(METRIC_ANOMALY_FINDER_CLASSES_CONFIG, Type.LIST,
             ["cruise_control_tpu_torch.detector.detectors.SlowBrokerFinder"],
             importance=Importance.MEDIUM, doc="Metric anomaly finder plugins.", group="detector")
    d.define(SLOW_BROKER_DEMOTION_SCORE_CONFIG, Type.INT, 5, Range.at_least(1), Importance.LOW,
             doc="Slowness score at which a broker is demoted.", group="detector")
    d.define(SLOW_BROKER_DECOMMISSION_SCORE_CONFIG, Type.INT, 50, Range.at_least(1), Importance.LOW,
             doc="Slowness score at which a broker is removed.", group="detector")
    d.define(SLOW_BROKER_BYTES_IN_RATE_DETECTION_THRESHOLD_CONFIG, Type.DOUBLE, 1024.0,
             Range.at_least(0.0), Importance.LOW,
             doc="Minimum bytes-in rate (KB/s) for slow-broker detection to apply.", group="detector")
    d.define(SLOW_BROKER_LOG_FLUSH_TIME_THRESHOLD_MS_CONFIG, Type.DOUBLE, 1000.0, Range.at_least(0.0),
             Importance.LOW, doc="Log-flush-time p999 threshold in ms.", group="detector")
    d.define(SLOW_BROKER_METRIC_HISTORY_PERCENTILE_THRESHOLD_CONFIG, Type.DOUBLE, 90.0,
             Range.between(0.0, 100.0), Importance.LOW,
             doc="History percentile a broker must exceed to look slow vs itself.", group="detector")
    d.define(SLOW_BROKER_METRIC_HISTORY_MARGIN_CONFIG, Type.DOUBLE, 3.0, Range.at_least(1.0),
             Importance.LOW, doc="Multiplicative margin over own history.", group="detector")
    d.define(SLOW_BROKER_PEER_METRIC_PERCENTILE_THRESHOLD_CONFIG, Type.DOUBLE, 50.0,
             Range.between(0.0, 100.0), Importance.LOW,
             doc="Peer percentile a broker must exceed to look slow vs peers.", group="detector")
    d.define(SLOW_BROKER_PEER_METRIC_MARGIN_CONFIG, Type.DOUBLE, 10.0, Range.at_least(1.0),
             Importance.LOW, doc="Multiplicative margin over peers.", group="detector")
    d.define(SELF_HEALING_EXCLUDE_RECENTLY_DEMOTED_BROKERS_CONFIG, Type.BOOLEAN, True,
             importance=Importance.LOW, doc="Exclude recently demoted brokers from self-healing.",
             group="detector")
    d.define(SELF_HEALING_EXCLUDE_RECENTLY_REMOVED_BROKERS_CONFIG, Type.BOOLEAN, True,
             importance=Importance.LOW, doc="Exclude recently removed brokers from self-healing.",
             group="detector")
    d.define(TOPIC_ANOMALY_FINDER_CLASSES_CONFIG, Type.LIST,
             ["cruise_control_tpu_torch.detector.detectors.TopicReplicationFactorAnomalyFinder",
              "cruise_control_tpu_torch.detector.detectors.PartitionSizeAnomalyFinder"],
             importance=Importance.LOW, doc="Topic anomaly finder plugins.", group="detector")
    d.define(SELF_HEALING_TARGET_TOPIC_REPLICATION_FACTOR_CONFIG, Type.INT, 3, Range.at_least(1),
             Importance.LOW, doc="Desired topic replication factor.", group="detector")
    d.define(SELF_HEALING_PARTITION_SIZE_THRESHOLD_MB_CONFIG, Type.DOUBLE, float("inf"),
             importance=Importance.LOW,
             doc="Partitions larger than this are reported as topic anomalies "
                 "(PartitionSizeAnomalyFinder; inf disables).", group="detector")
    d.define(METRIC_ANOMALY_PERCENTILE_UPPER_THRESHOLD_CONFIG, Type.DOUBLE, 95.0,
             Range.between(0.0, 100.0), Importance.LOW,
             doc="Percentile of a broker's own metric history anchoring the "
                 "percentile anomaly finder.", group="detector")
    d.define(METRIC_ANOMALY_UPPER_MARGIN_CONFIG, Type.DOUBLE, 0.5, Range.at_least(0.0),
             Importance.LOW,
             doc="Fractional margin over the history percentile before a "
                 "metric counts as anomalous.", group="detector")
    d.define(PROVISIONER_CLASS_CONFIG, Type.STRING,
             "cruise_control_tpu_torch.detector.provisioner.NoopProvisioner",
             importance=Importance.LOW, doc="Provisioner (rightsizing) plugin.", group="detector")
    d.define(NUM_CACHED_RECENT_ANOMALY_STATES_CONFIG, Type.INT, 10, Range.between(1, 100),
             Importance.LOW, doc="Ring-buffer size of recent anomalies per type.", group="detector")
    d.define(ANOMALY_DETECTOR_DEVICE_SCORING_CONFIG, Type.BOOLEAN, True,
             importance=Importance.MEDIUM,
             doc="Score anomalies on-device: goal violations through the fused "
                 "stack-satisfied sweep and metric/slow-broker finders as one "
                 "batched program per tick (detector/device.py).  Off falls "
                 "back to the scalar host detectors.", group="detector")
    return d


# ---------------------------------------------------------------------------
# Web server group (reference: config/constants/WebServerConfig.java)
# ---------------------------------------------------------------------------

WEBSERVER_HTTP_PORT_CONFIG = "webserver.http.port"
WEBSERVER_HTTP_ADDRESS_CONFIG = "webserver.http.address"
WEBSERVER_API_URLPREFIX_CONFIG = "webserver.api.urlprefix"
WEBSERVER_SECURITY_ENABLE_CONFIG = "webserver.security.enable"
WEBSERVER_SECURITY_PROVIDER_CONFIG = "webserver.security.provider"
SPNEGO_KEYTAB_FILE_CONFIG = "spnego.keytab.file"
SPNEGO_PRINCIPAL_CONFIG = "spnego.principal"
WEBSERVER_AUTH_CREDENTIALS_FILE_CONFIG = "webserver.auth.credentials.file"
WEBSERVER_UI_DISKPATH_CONFIG = "webserver.ui.diskpath"
TWO_STEP_VERIFICATION_ENABLED_CONFIG = "two.step.verification.enabled"
TWO_STEP_PURGATORY_RETENTION_TIME_MS_CONFIG = "two.step.purgatory.retention.time.ms"
TWO_STEP_PURGATORY_MAX_REQUESTS_CONFIG = "two.step.purgatory.max.requests"
MAX_ACTIVE_USER_TASKS_CONFIG = "max.active.user.tasks"
COMPLETED_USER_TASK_RETENTION_TIME_MS_CONFIG = "completed.user.task.retention.time.ms"
MAX_CACHED_COMPLETED_USER_TASKS_CONFIG = "max.cached.completed.user.tasks"


def webserver_config_def() -> ConfigDef:
    d = ConfigDef()
    # 0 = OS-assigned ephemeral port (tests / parallel deployments).
    d.define(WEBSERVER_HTTP_PORT_CONFIG, Type.INT, 9090, Range.between(0, 65535), Importance.HIGH,
             doc="HTTP port.", group="webserver")
    d.define(WEBSERVER_HTTP_ADDRESS_CONFIG, Type.STRING, "127.0.0.1", importance=Importance.HIGH,
             doc="Bind address.", group="webserver")
    d.define(WEBSERVER_API_URLPREFIX_CONFIG, Type.STRING, "/kafkacruisecontrol/*",
             importance=Importance.MEDIUM, doc="API URL prefix.", group="webserver")
    d.define(WEBSERVER_SECURITY_ENABLE_CONFIG, Type.BOOLEAN, False, importance=Importance.MEDIUM,
             doc="Enable authn/authz.", group="webserver")
    d.define(WEBSERVER_SECURITY_PROVIDER_CONFIG, Type.STRING,
             "cruise_control_tpu_torch.api.server.BasicSecurityProvider",
             importance=Importance.MEDIUM, doc="Security provider plugin.", group="webserver")
    d.define(WEBSERVER_AUTH_CREDENTIALS_FILE_CONFIG, Type.STRING, "", importance=Importance.MEDIUM,
             doc="Credentials file for basic auth.", group="webserver")
    d.define(WEBSERVER_UI_DISKPATH_CONFIG, Type.STRING, "", importance=Importance.LOW,
             doc="Directory of static web-UI assets served at / (the "
                 "cruise-control-ui dist dir in the reference, "
                 "WebServerConfig.java:79); empty serves the built-in "
                 "status page.", group="webserver")
    d.define(SPNEGO_KEYTAB_FILE_CONFIG, Type.STRING, "", importance=Importance.LOW,
             doc="Service keytab for the SPNEGO security provider.", group="webserver")
    d.define(SPNEGO_PRINCIPAL_CONFIG, Type.STRING, "", importance=Importance.LOW,
             doc="SPNEGO service principal (service/host@REALM).", group="webserver")
    d.define(TWO_STEP_VERIFICATION_ENABLED_CONFIG, Type.BOOLEAN, False, importance=Importance.MEDIUM,
             doc="Park POST requests for admin review before running.", group="webserver")
    d.define(TWO_STEP_PURGATORY_RETENTION_TIME_MS_CONFIG, Type.LONG, 1209600000, Range.at_least(1),
             Importance.LOW, doc="Purgatory request retention.", group="webserver")
    d.define(TWO_STEP_PURGATORY_MAX_REQUESTS_CONFIG, Type.INT, 25, Range.at_least(1), Importance.LOW,
             doc="Max requests parked in purgatory.", group="webserver")
    d.define(MAX_ACTIVE_USER_TASKS_CONFIG, Type.INT, 5, Range.at_least(1), Importance.MEDIUM,
             doc="Max concurrently active user tasks.", group="webserver")
    d.define(COMPLETED_USER_TASK_RETENTION_TIME_MS_CONFIG, Type.LONG, 86400000, Range.at_least(1),
             Importance.LOW, doc="Completed user task retention.", group="webserver")
    d.define(MAX_CACHED_COMPLETED_USER_TASKS_CONFIG, Type.INT, 100, Range.at_least(1),
             Importance.LOW, doc="Max retained completed user tasks.", group="webserver")
    return d


def cruise_control_config_def() -> ConfigDef:
    """The full framework ConfigDef (KafkaCruiseControlConfig analogue)."""
    d = ConfigDef()
    d.merge(analyzer_config_def())
    d.merge(monitor_config_def())
    d.merge(executor_config_def())
    d.merge(anomaly_detector_config_def())
    d.merge(webserver_config_def())
    return d
