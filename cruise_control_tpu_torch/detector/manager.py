"""Anomaly detection manager.

Parity with ``AnomalyDetectorManager`` (detector/AnomalyDetectorManager.java:52):
owns all detectors, runs them at per-type intervals, feeds a priority queue
(priority = anomaly type, broker failures first), and drains it through the
notifier — FIX runs ``anomaly.fix(facade)``, CHECK re-queues with a delay,
IGNORE records and drops.  Handling defers while the executor is busy
(:342-430).  ``AnomalyDetectorState`` keeps recent-anomaly ring buffers per
type, self-healing flags, and counters for the /state endpoint
(AnomalyDetectorState.java).

Deterministic by design: ``run_detectors_once(now_ms)`` and
``handle_anomalies_once(now_ms)`` advance the loop one tick — the service
layer drives them from a scheduler thread; tests drive them directly.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.common.timeseries import (HEAL_DURATION_SERIES,
                                                  HEAL_STARTED_SERIES,
                                                  TELEMETRY)
from cruise_control_tpu_torch.common.tracing import TRACE
from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType
from cruise_control_tpu_torch.detector.notifier import (AnomalyNotificationAction,
                                                  AnomalyNotifier, SelfHealingNotifier)


@dataclasses.dataclass
class AnomalyState:
    anomaly: Anomaly
    status: str  # DETECTED / IGNORED / FIX_STARTED / FIX_FAILED_TO_START / CHECK_WITH_DELAY / DENIED (executor busy)
    status_time_ms: int


class AnomalyDetectorState:
    """Ring buffers + counters (detector/AnomalyDetectorState.java)."""

    def __init__(self, history_size: int = 10):
        self._history: Dict[AnomalyType, deque] = {
            t: deque(maxlen=history_size) for t in AnomalyType}
        self.metrics: Dict[str, int] = {f"num_{t.name.lower()}": 0 for t in AnomalyType}
        self.ongoing_self_healing: Optional[str] = None

    def record(self, anomaly: Anomaly, status: str, now_ms: int) -> None:
        self._history[anomaly.anomaly_type].append(AnomalyState(anomaly, status, now_ms))
        if status == "DETECTED":
            self.metrics[f"num_{anomaly.anomaly_type.name.lower()}"] += 1

    def update_status(self, anomaly: Anomaly, status: str, now_ms: int) -> None:
        for st in self._history[anomaly.anomaly_type]:
            if st.anomaly.anomaly_id == anomaly.anomaly_id:
                st.status = status
                st.status_time_ms = now_ms
                return
        self.record(anomaly, status, now_ms)

    def recent(self, anomaly_type: AnomalyType) -> List[AnomalyState]:
        return list(self._history[anomaly_type])

    def to_dict(self, notifier: AnomalyNotifier,
                balancedness_score: Optional[float] = None) -> Dict[str, object]:
        return {
            # Quantifies how well the load distribution satisfies the
            # detection goals (AnomalyDetectorState.java:384); absent until a
            # GoalViolationDetector is registered.
            **({"balancednessScore": balancedness_score}
               if balancedness_score is not None else {}),
            "selfHealingEnabled": {t.name: v for t, v in
                                   notifier.self_healing_enabled().items()},
            "recentAnomalies": {
                t.name: [dict(anomalyId=s.anomaly.anomaly_id, status=s.status,
                              statusTimeMs=s.status_time_ms,
                              reason=s.anomaly.reason())
                         for s in self.recent(t)]
                for t in AnomalyType},
            "metrics": dict(self.metrics),
            "ongoingSelfHealing": self.ongoing_self_healing,
        }


@dataclasses.dataclass(order=True)
class _QueueEntry:
    priority: Tuple[int, int, int]
    anomaly: Anomaly = dataclasses.field(compare=False)
    not_before_ms: int = dataclasses.field(compare=False, default=0)


class AnomalyDetectorManager:
    def __init__(self, notifier: Optional[AnomalyNotifier] = None,
                 facade=None,
                 executor_busy: Optional[Callable[[], bool]] = None,
                 history_size: int = 10):
        self._notifier = notifier or SelfHealingNotifier()
        self._facade = facade
        self._executor_busy = executor_busy or (lambda: False)
        self.state = AnomalyDetectorState(history_size)
        self._queue: List[_QueueEntry] = []  # guarded-by: _lock
        self._lock = threading.RLock()
        # (detector, interval_ms, last_run_ms, is_multi) registered sources.
        self._detectors: List[List] = []  # guarded-by: _lock
        # Heal-pipeline sensors registered eagerly so the /metrics catalog is
        # deterministic (the per-anomaly-class rate counters stay
        # conditional — documented in prose, not table rows).
        self._heal_hist = SENSORS.histogram(
            "AnomalyDetector.heal-duration-seconds",
            help="Wall time of each self-healing fix, detection to "
                 "executor dispatch")
        self._heals_started = SENSORS.counter(
            "AnomalyDetector.heals-started",
            help="Self-healing fixes that started an execution")
        self._heals_failed = SENSORS.counter(
            "AnomalyDetector.heals-failed",
            help="Self-healing fixes that failed to start (including "
                 "exceptions raised by the fix)")

    @property
    def notifier(self) -> AnomalyNotifier:
        return self._notifier

    def balancedness_score(self) -> Optional[float]:
        """The goal-violation detector's rolling balancedness score
        (AnomalyDetectorManager.java:180 registers it as a gauge)."""
        for detector, _, _ in self._detectors:
            score = getattr(detector, "balancedness_score", None)
            if score is not None:
                return float(score)
        return None

    def state_dict(self) -> Dict[str, object]:
        """The /state AnomalyDetectorState payload."""
        return self.state.to_dict(self._notifier, self.balancedness_score())

    def register_detector(self, detector, interval_ms: int) -> None:
        """detector.detect(now_ms) -> Anomaly | list[Anomaly] | None."""
        with self._lock:
            self._detectors.append([detector, int(interval_ms), None])

    def enqueue(self, anomaly: Anomaly, now_ms: int, not_before_ms: int = 0) -> None:
        with self._lock:
            heapq.heappush(self._queue, _QueueEntry(
                priority=(int(anomaly.anomaly_type), not_before_ms, anomaly.anomaly_id),
                anomaly=anomaly, not_before_ms=not_before_ms))
            self.state.record(anomaly, "DETECTED", now_ms)

    # -- one scheduler tick --------------------------------------------------
    def run_detectors_once(self, now_ms: int) -> int:
        """Run every detector whose interval elapsed; queue findings."""
        found = 0
        for entry in self._detectors:
            detector, interval, last = entry
            if last is not None and now_ms - last < interval:
                continue
            entry[2] = now_ms
            kind = type(detector).__name__
            hist = SENSORS.histogram(
                "AnomalyDetector.detection-duration-seconds",
                labels={"detector": kind},
                help="Wall time spent in each detector's detect() call")
            with TRACE.span("detector.detect", detector=kind) as sp, hist.time():
                result = detector.detect(now_ms)
                anomalies = result if isinstance(result, list) else \
                    ([result] if result is not None else [])
                sp.annotate(anomalies=len(anomalies))
            for a in anomalies:
                self.enqueue(a, now_ms)
                found += 1
        # Detector-tick publish boundary: the finding count and the
        # goal-violation detector's rolling balancedness (a cached host
        # float — its sweep already ran inside detect()) become series
        # points stamped with the tick's own clock.
        TELEMETRY.record("detector.anomalies-found", float(found),
                         t_ms=now_ms)
        score = self.balancedness_score()
        if score is not None and score >= 0.0:
            # Negative is the offline-replicas sentinel
            # (BALANCEDNESS_SCORE_WITH_OFFLINE_REPLICAS): the score is
            # *undefined* during a failure window, not low — publishing it
            # would poison the SLA floor, so the series simply has a gap
            # there (the heal series carries the failure evidence).
            TELEMETRY.record("detector.balancedness", score, t_ms=now_ms)
        return found

    def handle_anomalies_once(self, now_ms: int) -> int:
        """Drain ready queue entries through the notifier (AnomalyHandlerTask
        loop, AnomalyDetectorManager.java:344).  Returns #handled."""
        handled = 0
        deferred: List[_QueueEntry] = []
        with self._lock:
            while self._queue:
                entry = heapq.heappop(self._queue)
                if entry.not_before_ms > now_ms:
                    deferred.append(entry)
                    continue
                handled += self._handle(entry.anomaly, now_ms)
            for entry in deferred:
                heapq.heappush(self._queue, entry)
        TELEMETRY.record("detector.anomalies-handled", float(handled),
                         t_ms=now_ms)
        return handled

    def _handle(self, anomaly: Anomaly, now_ms: int) -> int:  # holds-lock: _lock
        SENSORS.counter(
            f"AnomalyDetector.{type(anomaly).__name__}-rate",
            help="Anomalies of this type handled by the notifier").inc()
        result = self._notifier.on_anomaly(anomaly, now_ms)
        if result.action == AnomalyNotificationAction.IGNORE:
            self.state.update_status(anomaly, "IGNORED", now_ms)
            return 1
        if result.action == AnomalyNotificationAction.CHECK:
            self.state.update_status(anomaly, "CHECK_WITH_DELAY", now_ms)
            heapq.heappush(self._queue, _QueueEntry(
                priority=(int(anomaly.anomaly_type),
                          now_ms + result.delay_ms, anomaly.anomaly_id),
                anomaly=anomaly, not_before_ms=now_ms + result.delay_ms))
            return 1
        # FIX — defer while an execution is in flight (:342-430).
        if self._executor_busy():
            self.state.update_status(anomaly, "DENIED", now_ms)
            heapq.heappush(self._queue, _QueueEntry(
                priority=(int(anomaly.anomaly_type), now_ms + 30_000,
                          anomaly.anomaly_id),
                anomaly=anomaly, not_before_ms=now_ms + 30_000))
            return 1
        started = False
        if self._facade is not None:
            heal_t0 = time.monotonic()
            self.state.ongoing_self_healing = anomaly.reason()
            # A raising fix() must behave like a failed one: clear the
            # ongoing flag, record FIX_FAILED_TO_START, and keep draining
            # the queue — the drain loop holds the manager lock, so a
            # propagating exception would wedge every later detection.
            with TRACE.span("detector.heal",
                            anomaly=type(anomaly).__name__) as sp, \
                    self._heal_hist.time():
                try:
                    started = bool(anomaly.fix(self._facade))
                except Exception as exc:  # noqa: BLE001
                    sp.annotate(error=type(exc).__name__)
                finally:
                    self.state.ongoing_self_healing = None
                sp.annotate(started=started)
            (self._heals_started if started else self._heals_failed).inc()
            # Heal publish boundary: latency (detect→dispatch wall, the
            # same value the heal histogram observed) and the outcome flag
            # the SLA rollup's all-heals-completed check reads.
            TELEMETRY.record(HEAL_DURATION_SERIES,
                             time.monotonic() - heal_t0, t_ms=now_ms)
            TELEMETRY.record(HEAL_STARTED_SERIES,
                             1.0 if started else 0.0, t_ms=now_ms)
        self.state.update_status(
            anomaly, "FIX_STARTED" if started else "FIX_FAILED_TO_START", now_ms)
        return 1
