"""Anomaly notification / self-healing policy.

Parity with the ``AnomalyNotifier`` SPI + ``SelfHealingNotifier``
(detector/notifier/AnomalyNotifier.java, SelfHealingNotifier.java:58-80):
maps each anomaly to {FIX, CHECK(delay), IGNORE}; per-type self-healing
enable flags; broker failures get a two-stage policy — alert after
``broker_failure_alert_threshold_ms`` since the failure, self-heal only
after ``broker_failure_self_healing_threshold_ms``.  An Alerta-style hook
(AlertaSelfHealingNotifier.java) is a callback here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

from cruise_control_tpu_torch.detector.anomalies import Anomaly, AnomalyType, BrokerFailures


class AnomalyNotificationAction(enum.Enum):
    FIX = "fix"
    CHECK = "check"
    IGNORE = "ignore"


@dataclasses.dataclass(frozen=True)
class AnomalyNotificationResult:
    action: AnomalyNotificationAction
    delay_ms: int = 0

    @classmethod
    def fix(cls) -> "AnomalyNotificationResult":
        return cls(AnomalyNotificationAction.FIX)

    @classmethod
    def check(cls, delay_ms: int) -> "AnomalyNotificationResult":
        return cls(AnomalyNotificationAction.CHECK, delay_ms)

    @classmethod
    def ignore(cls) -> "AnomalyNotificationResult":
        return cls(AnomalyNotificationAction.IGNORE)


class AnomalyNotifier:
    """SPI: decide what to do about an anomaly."""

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> AnomalyNotificationResult:
        raise NotImplementedError

    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return {t: False for t in AnomalyType}

    def set_self_healing_for(self, anomaly_type: AnomalyType, enabled: bool) -> bool:
        return False


class SelfHealingNotifier(AnomalyNotifier):
    """SelfHealingNotifier.java semantics."""

    def __init__(self,
                 self_healing_enabled: Optional[Dict[AnomalyType, bool]] = None,
                 broker_failure_alert_threshold_ms: int = 15 * 60 * 1000,
                 broker_failure_self_healing_threshold_ms: int = 30 * 60 * 1000,
                 alert_hook: Optional[Callable[[Anomaly, bool], None]] = None):
        enabled = dict.fromkeys(AnomalyType, False)
        enabled.update(self_healing_enabled or {})
        self._enabled = enabled
        self._alert_ms = broker_failure_alert_threshold_ms
        self._heal_ms = broker_failure_self_healing_threshold_ms
        self._alert_hook = alert_hook
        self.alerts: List[Anomaly] = []

    def configure(self, config: Dict[str, object]) -> None:
        """Plugin-style init (anomaly.notifier.class): reads the
        broker-failure alert/self-heal thresholds and the master
        self-healing switch from the merged config."""
        from cruise_control_tpu_torch.config import constants as C
        if C.BROKER_FAILURE_ALERT_THRESHOLD_MS_CONFIG in config:
            self._alert_ms = int(config[C.BROKER_FAILURE_ALERT_THRESHOLD_MS_CONFIG])
        if C.BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS_CONFIG in config:
            self._heal_ms = int(
                config[C.BROKER_FAILURE_SELF_HEALING_THRESHOLD_MS_CONFIG])
        if config.get(C.SELF_HEALING_ENABLED_CONFIG):
            self._enabled = dict.fromkeys(AnomalyType, True)

    def self_healing_enabled(self) -> Dict[AnomalyType, bool]:
        return dict(self._enabled)

    def set_self_healing_for(self, anomaly_type: AnomalyType, enabled: bool) -> bool:
        old = self._enabled[anomaly_type]
        self._enabled[anomaly_type] = enabled
        return old

    def _alert(self, anomaly: Anomaly, auto_fix: bool) -> None:
        self.alerts.append(anomaly)
        if self._alert_hook:
            self._alert_hook(anomaly, auto_fix)

    def on_anomaly(self, anomaly: Anomaly, now_ms: int) -> AnomalyNotificationResult:
        t = anomaly.anomaly_type
        if t == AnomalyType.BROKER_FAILURE:
            return self._on_broker_failure(anomaly, now_ms)
        if not self._enabled[t]:
            self._alert(anomaly, auto_fix=False)
            return AnomalyNotificationResult.ignore()
        self._alert(anomaly, auto_fix=True)
        return AnomalyNotificationResult.fix()

    def _on_broker_failure(self, anomaly: BrokerFailures,
                           now_ms: int) -> AnomalyNotificationResult:
        """Two-stage policy (SelfHealingNotifier.onBrokerFailure): wait out
        the alert threshold (transient restarts), then the self-heal
        threshold, measured from the *earliest* still-failed broker."""
        if not anomaly.failed_brokers:
            return AnomalyNotificationResult.ignore()
        earliest = min(anomaly.failed_brokers.values())
        if now_ms < earliest + self._alert_ms:
            return AnomalyNotificationResult.check(earliest + self._alert_ms - now_ms)
        if not self._enabled[AnomalyType.BROKER_FAILURE]:
            self._alert(anomaly, auto_fix=False)
            return AnomalyNotificationResult.ignore()
        if now_ms < earliest + self._heal_ms:
            self._alert(anomaly, auto_fix=False)
            return AnomalyNotificationResult.check(earliest + self._heal_ms - now_ms)
        self._alert(anomaly, auto_fix=True)
        return AnomalyNotificationResult.fix()


class AlertaSelfHealingNotifier(SelfHealingNotifier):
    """SelfHealingNotifier that additionally posts every alert to an
    Alerta.io endpoint (detector/notifier/AlertaSelfHealingNotifier.java:
    POST {api_url}/alert with an Authorization: Key header; severity maps
    from whether self-healing will fire)."""

    def __init__(self, api_url: str, api_key: str = "",
                 environment: str = "Production", origin: str = "cruise-control",
                 http_post: Optional[Callable[[str, Dict, Dict], None]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self._api_url = api_url.rstrip("/")
        self._api_key = api_key
        self._environment = environment
        self._origin = origin
        self._http_post = http_post or self._default_post
        self.post_failures = 0

    @staticmethod
    def _default_post(url: str, payload: Dict, headers: Dict) -> None:
        import json as _json
        import urllib.request
        req = urllib.request.Request(
            url, data=_json.dumps(payload).encode(),
            headers={"Content-Type": "application/json", **headers},
            method="POST")
        urllib.request.urlopen(req, timeout=10)

    def _alert(self, anomaly: Anomaly, auto_fix: bool) -> None:
        super()._alert(anomaly, auto_fix)
        payload = {
            "resource": anomaly.anomaly_type.name,
            "event": type(anomaly).__name__,
            "environment": self._environment,
            "severity": "warning" if auto_fix else "critical",
            "service": ["cruise-control-tpu"],
            "origin": self._origin,
            "text": anomaly.reason(),
            "attributes": {"selfHealing": auto_fix,
                           "anomalyId": anomaly.anomaly_id},
        }
        headers = {"Authorization": f"Key {self._api_key}"} if self._api_key else {}
        try:
            self._http_post(f"{self._api_url}/alert", payload, headers)
        except Exception:  # noqa: BLE001 — alerting must never break detection
            self.post_failures += 1
