"""Anomaly detectors.

Parity with the reference's detector suite (SURVEY.md §2.6):

- ``GoalViolationDetector`` (GoalViolationDetector.java:55): re-checks the
  detection goals on a fresh cluster model, splits violations into fixable
  vs unfixable, skips when offline replicas exist (defers to the failure
  detectors).
- ``BrokerFailureDetector`` (BrokerFailureDetector.java:44): diffs the
  expected broker set against live metadata; failure times persisted to a
  JSON file so grace periods survive restarts (the reference persists them
  in its own ZK path).
- ``DiskFailureDetector`` (DiskFailureDetector.java:34): offline logdirs via
  the admin's describe_logdirs.
- ``MetricAnomalyDetector`` + ``PercentileMetricAnomalyFinder`` (core SPI,
  cruise-control-core detector/metricanomaly/) and ``SlowBrokerFinder``
  (SlowBrokerFinder.java:33-105): log-flush-time 999th percentile, raw and
  normalized by bytes-in, compared against the broker's own history
  percentile AND its peers; slowness-score escalation demotion → removal;
  unfixable when too many brokers look slow at once.
- ``TopicAnomalyDetector`` with RF and partition-size finders
  (TopicReplicationFactorAnomalyFinder.java, PartitionSizeAnomalyFinder).
- ``MaintenanceEventDetector`` + queue-backed reader with idempotence cache
  (MaintenanceEventTopicReader.java:25, IdempotenceCache.java).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from cruise_control_tpu_torch.detector.anomalies import (Anomaly, BrokerFailures, DiskFailures,
                                                   GoalViolations, MaintenanceEvent,
                                                   SlowBrokers,
                                                   TopicPartitionSizeAnomaly,
                                                   TopicReplicationFactorAnomaly)
from cruise_control_tpu_torch.monitor.load_monitor import (LoadMonitor,
                                                     NotEnoughValidWindowsError)
from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF


class GoalViolationDetector:
    def __init__(self, load_monitor: LoadMonitor, detection_goals: Sequence[str],
                 constraint: Optional[BalancingConstraint] = None,
                 provisioner=None,
                 balancedness_priority_weight: float = 1.1,
                 balancedness_strictness_weight: float = 1.5):
        from cruise_control_tpu_torch.analyzer.balancedness import (
            MAX_BALANCEDNESS_SCORE, balancedness_cost_by_goal)
        self._lm = load_monitor
        self._goals = list(detection_goals)
        self._constraint = constraint or BalancingConstraint.default()
        # Provisioner SPI (detector/Provisioner.java): receives UNDER/OVER
        # recommendations aggregated over the detection pass
        # (GoalViolationDetector.java:160-237 optionally right-sizes).
        self._provisioner = provisioner
        self.last_checked_generation: Optional[Tuple[int, int]] = None
        self.last_provision_response = None
        self.last_rightsize_result = None
        # Rolling balancedness (GoalViolationDetector.java:63-64,106):
        # refreshed on every detection pass; 100 until the first pass.
        self._balancedness_costs = (
            balancedness_cost_by_goal(goals_by_priority(self._goals),
                                      balancedness_priority_weight,
                                      balancedness_strictness_weight)
            if self._goals else {})  # empty detection set = detector disabled
        self.balancedness_score: float = MAX_BALANCEDNESS_SCORE

    def _goal_satisfactions(self, model):
        """Per-goal satisfied flags plus the any-offline-replica verdict.

        The scalar path costs one device round-trip per goal; the device
        subclass (``detector.device.DeviceGoalViolationDetector``) answers
        both questions in ONE fused stack-satisfied sweep dispatch.  Returns
        ``(sat, any_offline)`` where ``sat`` is a list of bools in
        ``goals_by_priority`` order (None when offline replicas exist — the
        caller defers to the failure detectors without evaluating goals)."""
        if bool(model.replica_offline_now().any()):
            return None, True
        specs = goals_by_priority(self._goals)
        arrays = BrokerArrays.for_specs(model, specs)
        sat = [bool(kernels.goal_satisfied(spec, model, arrays,
                                           self._constraint))
               for spec in specs]
        return sat, False

    def detect(self, now_ms: int) -> Optional[GoalViolations]:
        from cruise_control_tpu_torch.analyzer.balancedness import (
            BALANCEDNESS_SCORE_WITH_OFFLINE_REPLICAS, balancedness_score)
        try:
            model = self._lm.cluster_model()
        except NotEnoughValidWindowsError:
            return None
        sat, any_offline = self._goal_satisfactions(model)
        if any_offline:
            # Defer to broker/disk failure detectors (GoalViolationDetector
            # skips when offline replicas exist, :160-237); the score is
            # pinned to the offline sentinel meanwhile (:69,281).
            self.balancedness_score = BALANCEDNESS_SCORE_WITH_OFFLINE_REPLICAS
            return None
        gen = self._lm.model_generation().as_tuple()
        self.last_checked_generation = gen
        fixable: List[str] = []
        unfixable: List[str] = []
        rf_max = int(model.partition_replication_factor().cpu().numpy().max(initial=0))
        from cruise_control_tpu_torch.analyzer.provisioning import (
            ProvisionResponse, ProvisionStatus, host_view,
            provision_verdict_for_goal)
        provision = ProvisionResponse()
        view = host_view(model)
        for spec, satisfied in zip(goals_by_priority(self._goals), sat):
            provision.aggregate(provision_verdict_for_goal(
                spec, model, self._constraint, satisfied, view))
            if satisfied:
                continue
            if spec.kind in ("rack", "rack_distribution") and rf_max > model.num_racks:
                unfixable.append(spec.name)
            else:
                fixable.append(spec.name)
        self.last_provision_response = provision
        self.balancedness_score = balancedness_score(
            self._balancedness_costs, fixable + unfixable)
        if self._provisioner is not None and provision.status in (
                ProvisionStatus.UNDER_PROVISIONED,
                ProvisionStatus.OVER_PROVISIONED):
            self.last_rightsize_result = self._provisioner.rightsize(
                provision.recommendations)
        if not fixable and not unfixable:
            return None
        return GoalViolations(detection_time_ms=now_ms, fixable_goals=fixable,
                              unfixable_goals=unfixable)


class BrokerFailureDetector:
    def __init__(self, metadata_client, persist_path: Optional[str] = None):
        self._md = metadata_client
        self._path = persist_path
        self._failure_times: Dict[int, int] = {}
        self._known: Set[int] = set()
        self._lock = threading.Lock()
        if persist_path and os.path.exists(persist_path):
            with open(persist_path) as f:
                self._failure_times = {int(k): int(v) for k, v in json.load(f).items()}

    def _persist(self) -> None:
        if self._path:
            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            with open(self._path, "w") as f:
                json.dump(self._failure_times, f)

    def detect(self, now_ms: int) -> Optional[BrokerFailures]:
        cluster = self._md.cluster()
        with self._lock:
            alive = set(cluster.alive_broker_ids())
            self._known |= {b.broker_id for b in cluster.brokers}
            failed = self._known - alive
            changed = False
            for b in failed:
                if b not in self._failure_times:
                    self._failure_times[b] = now_ms
                    changed = True
            for b in list(self._failure_times):
                if b in alive:
                    del self._failure_times[b]
                    changed = True
            if changed:
                self._persist()
            if not self._failure_times:
                return None
            return BrokerFailures(detection_time_ms=now_ms,
                                  failed_brokers=dict(self._failure_times))

    def forget(self, brokers: Sequence[int]) -> None:
        """Drop brokers that were healed/removed so they stop re-alerting."""
        with self._lock:
            for b in brokers:
                self._failure_times.pop(b, None)
                self._known.discard(b)
            self._persist()


class DiskFailureDetector:
    def __init__(self, admin, metadata_client):
        self._admin = admin
        self._md = metadata_client

    def detect(self, now_ms: int) -> Optional[DiskFailures]:
        alive = set(self._md.cluster().alive_broker_ids())
        failed: Dict[int, Tuple[str, ...]] = {}
        for broker, dirs in self._admin.describe_logdirs().items():
            if broker not in alive:
                continue  # whole-broker failure is the broker detector's job
            dead = tuple(ld for ld, ok in dirs.items() if not ok)
            if dead:
                failed[broker] = dead
        if not failed:
            return None
        return DiskFailures(detection_time_ms=now_ms, failed_disks=failed)


class PercentileMetricAnomalyFinder:
    """core detector/metricanomaly/PercentileMetricAnomalyFinder.java: flag
    brokers whose latest value exceeds the upper percentile of their own
    history by a margin."""

    def __init__(self, metric_name: str = "BROKER_LOG_FLUSH_TIME_MS_999TH",
                 upper_percentile: float = 95.0, margin: float = 1.5,
                 persistence: int = 1):
        # The default metric matches the reference's slow-broker signal so
        # the class is loadable via metric.anomaly.finder.class.  The 1.5x
        # default margin = the reference's metric.anomaly.upper.margin=0.5
        # over the history percentile.
        self.metric = metric_name
        self._pct = upper_percentile
        self._margin = margin
        # Optional: consecutive excursions required before reporting
        # (reference parity is 1 — report on detection; raise for noisy
        # metrics, noting an excursion folds into its own history next
        # window).
        self._persistence = persistence
        self._streak: Dict[int, int] = {}

    def configure(self, config: Dict[str, object]) -> None:
        """Plugin-style init (metric.anomaly.finder.class): the reference's
        PercentileMetricAnomalyFinderConfig keys — upper percentile and the
        fractional upper margin (threshold = percentile x (1 + margin))."""
        from cruise_control_tpu_torch.config import constants as C
        if C.METRIC_ANOMALY_PERCENTILE_UPPER_THRESHOLD_CONFIG in config:
            self._pct = float(
                config[C.METRIC_ANOMALY_PERCENTILE_UPPER_THRESHOLD_CONFIG])
        if C.METRIC_ANOMALY_UPPER_MARGIN_CONFIG in config:
            self._margin = 1.0 + float(
                config[C.METRIC_ANOMALY_UPPER_MARGIN_CONFIG])

    def anomalies(self, broker_agg) -> Dict[int, float]:
        res = broker_agg.aggregate()
        mid = KAFKA_METRIC_DEF.metric_info(self.metric).metric_id
        out: Dict[int, float] = {}
        vals = res.values[:, :, mid]  # [E, W]
        if vals.shape[1] < 3:
            return out
        for row, broker in enumerate(res.entities):
            history, latest = vals[row, :-1], vals[row, -1]
            if not res.window_valid[row, -1] or not res.window_valid[row, :-1].any():
                continue
            hist = history[res.window_valid[row, :-1]]
            threshold = np.percentile(hist, self._pct) * self._margin
            if latest > threshold and latest > 0:
                out[broker] = float(latest / max(threshold, 1e-9))
        return out

    def detect(self, broker_agg, now_ms: int) -> Optional[SlowBrokers]:
        """Finder SPI (metric.anomaly.finder.class): persistent percentile
        excursions surface as a demote-class metric anomaly carrying the
        excursion ratio as the score.  Guards mirror SlowBrokerFinder's:
        a broker must exceed its threshold on ``persistence`` consecutive
        passes, and a systemic event (more than half the brokers excursive
        at once — a cluster-wide load spike, not per-broker slowness)
        reports nothing."""
        found = self.anomalies(broker_agg)
        for b in list(self._streak):
            if b not in found:
                del self._streak[b]
        for b in found:
            self._streak[b] = self._streak.get(b, 0) + 1
        num_brokers = len(broker_agg.aggregate().entities)
        # Systemic guard (SlowBrokerFinder semantics): when most of a
        # non-trivial cluster looks anomalous at once it's a workload
        # event, not broker sickness — self-healing must not demote half
        # the fleet.
        if num_brokers >= 4 and len(found) > num_brokers // 2:
            return None
        persistent = {b: found[b] for b, n in self._streak.items()
                      if n >= self._persistence and b in found}
        if not persistent:
            return None
        return SlowBrokers(detection_time_ms=now_ms, slow_brokers=persistent,
                           fix_by_removal=False)


class SlowBrokerFinder:
    """SlowBrokerFinder.java:109 semantics, over the broker aggregator.

    A broker is *suspect* when its log-flush-time 999th (raw AND normalized
    by bytes-in) exceeds both (a) its own history's upper percentile and
    (b) the peer-cluster median by a factor.  Suspects accumulate a
    slowness score across detections; score ≥ demote threshold → demote,
    ≥ removal threshold → remove.  If more than half the cluster looks
    slow, the anomaly is unfixable (self-healing would destroy capacity) —
    reported with no brokers to fix.
    """

    METRIC = "BROKER_LOG_FLUSH_TIME_MS_999TH"
    BYTES_METRIC = "LEADER_BYTES_IN"

    def __init__(self, history_percentile: float = 90.0, history_margin: float = 3.0,
                 peer_percentile: float = 50.0, peer_margin: float = 3.0,
                 demote_score: int = 5, removal_score: int = 10,
                 bytes_in_rate_detection_threshold: float = 0.0,
                 log_flush_time_threshold_ms: float = 0.0):
        self._pct = history_percentile
        self._hist_margin = history_margin
        # slow.broker.peer.metric.percentile.threshold: which percentile of
        # the peer cluster's latest values anchors the peer comparison
        # (50 = the reference's median default).
        self._peer_pct = peer_percentile
        self._peer_margin = peer_margin
        self._demote = demote_score
        self._removal = removal_score
        # Absolute floors (slow.broker.bytes.in.rate.detection.threshold /
        # slow.broker.log.flush.time.threshold.ms): idle brokers (tiny
        # bytes-in denominators) and sub-threshold flush times never become
        # suspects regardless of relative excursions.
        self._min_bytes_in = bytes_in_rate_detection_threshold
        self._min_flush_ms = log_flush_time_threshold_ms
        self._scores: Dict[int, int] = {}

    def configure(self, config: Dict[str, object]) -> None:
        """Plugin-style init (metric.anomaly.finder.class): reads the eight
        slow.broker.* threshold keys (AnomalyDetectorConfig.java)."""
        from cruise_control_tpu_torch.config import constants as C
        key_attr = {
            C.SLOW_BROKER_METRIC_HISTORY_PERCENTILE_THRESHOLD_CONFIG: "_pct",
            C.SLOW_BROKER_METRIC_HISTORY_MARGIN_CONFIG: "_hist_margin",
            C.SLOW_BROKER_PEER_METRIC_PERCENTILE_THRESHOLD_CONFIG: "_peer_pct",
            C.SLOW_BROKER_PEER_METRIC_MARGIN_CONFIG: "_peer_margin",
            C.SLOW_BROKER_BYTES_IN_RATE_DETECTION_THRESHOLD_CONFIG: "_min_bytes_in",
            C.SLOW_BROKER_LOG_FLUSH_TIME_THRESHOLD_MS_CONFIG: "_min_flush_ms",
        }
        for key, attr in key_attr.items():
            if key in config:
                setattr(self, attr, float(config[key]))
        if C.SLOW_BROKER_DEMOTION_SCORE_CONFIG in config:
            self._demote = int(config[C.SLOW_BROKER_DEMOTION_SCORE_CONFIG])
        if C.SLOW_BROKER_DECOMMISSION_SCORE_CONFIG in config:
            self._removal = int(config[C.SLOW_BROKER_DECOMMISSION_SCORE_CONFIG])

    def _suspects(self, res, mid: int, bytes_mid: int) -> Set[int]:
        vals = res.values[:, :, mid]
        bts = np.maximum(res.values[:, :, bytes_mid], 1e-9)
        norm = vals / bts
        suspects: Set[int] = set()
        latest_all = []
        for row in range(vals.shape[0]):
            if res.window_valid[row, -1]:
                latest_all.append(vals[row, -1])
        peer_anchor = (np.percentile(latest_all, self._peer_pct)
                       if latest_all else 0.0)
        for row, broker in enumerate(res.entities):
            if not res.window_valid[row, -1] or vals.shape[1] < 3:
                continue
            hist_ok = res.window_valid[row, :-1]
            if not hist_ok.any():
                continue
            raw_now, norm_now = vals[row, -1], norm[row, -1]
            if bts[row, -1] < self._min_bytes_in or raw_now < self._min_flush_ms:
                continue
            raw_hist = np.percentile(vals[row, :-1][hist_ok], self._pct)
            norm_hist = np.percentile(norm[row, :-1][hist_ok], self._pct)
            own_slow = raw_now > raw_hist * self._hist_margin and \
                norm_now > norm_hist * self._hist_margin
            peer_slow = peer_anchor > 0 and raw_now > peer_anchor * self._peer_margin
            if own_slow and peer_slow:
                suspects.add(broker)
        return suspects

    def detect(self, broker_agg, now_ms: int) -> Optional[SlowBrokers]:
        res = broker_agg.aggregate()
        if res.values.shape[0] == 0 or res.values.shape[1] < 3:
            return None
        mid = KAFKA_METRIC_DEF.metric_info(self.METRIC).metric_id
        bmid = KAFKA_METRIC_DEF.metric_info(self.BYTES_METRIC).metric_id
        suspects = self._suspects(res, mid, bmid)
        for b in list(self._scores):
            if b not in suspects:
                self._scores[b] = max(self._scores[b] - 1, 0)
                if self._scores[b] == 0:
                    del self._scores[b]
        for b in suspects:
            self._scores[b] = self._scores.get(b, 0) + 1

        to_remove = {b: float(s) for b, s in self._scores.items() if s >= self._removal}
        to_demote = {b: float(s) for b, s in self._scores.items()
                     if self._demote <= s < self._removal}
        num_brokers = res.values.shape[0]
        if len(suspects) > num_brokers // 2:
            # Too many suspects ⇒ systemic (not per-broker) slowness; fixing
            # by demotion/removal would destroy capacity — report nothing
            # (the reference marks such anomalies unfixable).
            return None
        if to_remove:
            return SlowBrokers(detection_time_ms=now_ms, slow_brokers=to_remove,
                               fix_by_removal=True)
        if to_demote:
            return SlowBrokers(detection_time_ms=now_ms, slow_brokers=to_demote,
                               fix_by_removal=False)
        return None


class MetricAnomalyDetector:
    """Runs pluggable metric-anomaly finders over the broker metric history
    (detector/MetricAnomalyDetector.java:28; finder classes from
    metric.anomaly.finder.class).  A finder is anything with
    ``detect(broker_agg, now_ms) -> Anomaly | list[Anomaly] | None``
    (SlowBrokerFinder is the default, as in the reference)."""

    def __init__(self, load_monitor: LoadMonitor, finders: Sequence[object]):
        self._lm = load_monitor
        self.finders = list(finders)

    def detect(self, now_ms: int) -> List[Anomaly]:
        out: List[Anomaly] = []
        for finder in self.finders:
            found = finder.detect(self._lm.broker_aggregator, now_ms)
            if found is None:
                continue
            out.extend(found if isinstance(found, list) else [found])
        return out


class TopicReplicationFactorAnomalyFinder:
    """detector/TopicReplicationFactorAnomalyFinder.java: topics whose RF
    differs from the desired RF (self.healing.target.topic.replication.factor)."""

    def __init__(self, desired_rf: int = 3):
        self.desired_rf = desired_rf

    def configure(self, config: Dict[str, object]) -> None:
        from cruise_control_tpu_torch.config import constants as C
        if C.SELF_HEALING_TARGET_TOPIC_REPLICATION_FACTOR_CONFIG in config:
            self.desired_rf = int(
                config[C.SELF_HEALING_TARGET_TOPIC_REPLICATION_FACTOR_CONFIG])

    def find(self, cluster, load_monitor, excluded: Set[str],
             now_ms: int) -> List[Anomaly]:
        bad: Dict[str, int] = {}
        for p in cluster.partitions:
            if p.topic in excluded:
                continue
            if len(p.replicas) != self.desired_rf:
                bad[p.topic] = len(p.replicas)
        if not bad:
            return []
        return [TopicReplicationFactorAnomaly(
            detection_time_ms=now_ms, bad_topics=bad, desired_rf=self.desired_rf)]


class PartitionSizeAnomalyFinder:
    """detector/PartitionSizeAnomalyFinder: partitions whose disk footprint
    exceeds a threshold."""

    def __init__(self, size_threshold_mb: float = float("inf")):
        self.size_threshold_mb = size_threshold_mb

    def configure(self, config: Dict[str, object]) -> None:
        from cruise_control_tpu_torch.config import constants as C
        if C.SELF_HEALING_PARTITION_SIZE_THRESHOLD_MB_CONFIG in config:
            self.size_threshold_mb = float(
                config[C.SELF_HEALING_PARTITION_SIZE_THRESHOLD_MB_CONFIG])

    def find(self, cluster, load_monitor, excluded: Set[str],
             now_ms: int) -> List[Anomaly]:
        if load_monitor is None or not np.isfinite(self.size_threshold_mb):
            return []
        agg = load_monitor.partition_aggregator.aggregate()
        mid = KAFKA_METRIC_DEF.metric_info("DISK_USAGE").metric_id
        oversized = {}
        for row, tp in enumerate(agg.entities):
            if tp[0] in excluded:
                continue
            if agg.entity_valid[row] and agg.collapsed[row, mid] > self.size_threshold_mb:
                oversized[f"{tp[0]}-{tp[1]}"] = float(agg.collapsed[row, mid])
        if not oversized:
            return []
        return [TopicPartitionSizeAnomaly(
            detection_time_ms=now_ms, oversized=oversized,
            size_threshold_mb=self.size_threshold_mb)]


class TopicAnomalyDetector:
    """Runs pluggable topic-anomaly finders (TopicAnomalyDetector.java:24;
    classes from topic.anomaly.finder.class) against the metadata view."""

    def __init__(self, metadata_client, desired_rf: int = 3,
                 excluded_topics: Sequence[str] = (),
                 partition_size_threshold_mb: float = float("inf"),
                 load_monitor: Optional[LoadMonitor] = None,
                 finders: Optional[Sequence[object]] = None):
        self._md = metadata_client
        self._excluded = set(excluded_topics)
        self._lm = load_monitor
        self.finders = (list(finders) if finders is not None else
                        [TopicReplicationFactorAnomalyFinder(desired_rf),
                         PartitionSizeAnomalyFinder(partition_size_threshold_mb)])

    def detect(self, now_ms: int) -> List[Anomaly]:
        cluster = self._md.cluster()
        out: List[Anomaly] = []
        for finder in self.finders:
            out.extend(finder.find(cluster, self._lm, self._excluded, now_ms))
        return out


class MaintenanceEventReader:
    """Queue-backed plan source (MaintenanceEventTopicReader analogue);
    operators publish plans via the API layer."""

    def __init__(self):
        self._lock = threading.Lock()
        self._queue: deque = deque()

    def publish(self, event: MaintenanceEvent) -> None:
        with self._lock:
            self._queue.append(event)

    def drain(self) -> List[MaintenanceEvent]:
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            return out


class MaintenanceEventDetector:
    def __init__(self, reader: MaintenanceEventReader,
                 idempotence_ttl_ms: int = 3600_000):
        self._reader = reader
        self._ttl = idempotence_ttl_ms
        self._seen: Dict[Tuple, int] = {}

    def detect(self, now_ms: int) -> List[MaintenanceEvent]:
        for k, t in list(self._seen.items()):
            if now_ms - t > self._ttl:
                del self._seen[k]
        out = []
        for ev in self._reader.drain():
            key = ev.dedup_key()
            if key in self._seen:
                continue  # IdempotenceCache drop
            self._seen[key] = now_ms
            out.append(ev)
        return out
