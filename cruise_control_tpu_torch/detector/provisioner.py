"""Provisioner SPI: the cluster-rightsizing hook.

Parity with ``Provisioner`` (detector/Provisioner.java — "the interface for
adding or removing resources to/from the cluster") and its default
``NoopProvisioner``: after a goal-violation detection pass aggregates a
``ProvisionResponse``, the detector hands UNDER/OVER_PROVISIONED
recommendations to the configured provisioner, whose ``rightsize`` returns
what it did with them (GoalViolationDetector.java:160-237 →
Provisioner.rightsize).  Real deployments plug a cloud autoscaler here;
the framework ships Noop (ignore) and InMemory (record, for tests/ops
introspection).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Sequence

from cruise_control_tpu_torch.analyzer.provisioning import (ProvisionRecommendation,
                                                      ProvisionStatus)


class ProvisionerState(enum.Enum):
    """Provisioner.ProvisionerState analogue."""

    COMPLETED = "completed"
    COMPLETED_WITH_ERROR = "completed_with_error"
    IN_PROGRESS = "in_progress"
    IGNORED = "ignored"


@dataclasses.dataclass(frozen=True)
class RightsizeResult:
    state: ProvisionerState
    summary: str = ""


class Provisioner:
    """SPI: act on provisioning recommendations."""

    def rightsize(self, recommendations: Sequence[ProvisionRecommendation]
                  ) -> RightsizeResult:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NoopProvisioner(Provisioner):
    """Default: acknowledge and ignore (detector/NoopProvisioner)."""

    def rightsize(self, recommendations: Sequence[ProvisionRecommendation]
                  ) -> RightsizeResult:
        return RightsizeResult(ProvisionerState.IGNORED,
                               f"ignored {len(recommendations)} recommendation(s)")


class InMemoryProvisioner(Provisioner):
    """Records every rightsize request; tests and /state introspection read
    ``history`` — the in-memory analogue of a cloud autoscaler binding."""

    def __init__(self):
        self._lock = threading.Lock()
        self.history: List[List[ProvisionRecommendation]] = []

    def rightsize(self, recommendations: Sequence[ProvisionRecommendation]
                  ) -> RightsizeResult:
        recs = list(recommendations)
        with self._lock:
            self.history.append(recs)
        under = sum(1 for r in recs
                    if r.status == ProvisionStatus.UNDER_PROVISIONED)
        over = sum(1 for r in recs
                   if r.status == ProvisionStatus.OVER_PROVISIONED)
        return RightsizeResult(
            ProvisionerState.COMPLETED,
            f"recorded {under} under-provisioned / {over} over-provisioned")
