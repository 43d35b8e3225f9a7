"""Provisioning verdicts: is the cluster right-sized?

Counterpart of ``cruise_control_tpu/analyzer/provisioning.py`` (reference:
ProvisionRecommendation.java, ProvisionResponse.aggregate): capacity goals
that cannot be satisfied yield UNDER_PROVISIONED with a recommended broker
count; distribution goals below the low-utilization threshold yield
OVER_PROVISIONED.  Host-side numpy over one fetch of broker aggregates.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional

import numpy as np

from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GoalSpec
from cruise_control_tpu_torch.common.resources import Resource
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel


class ProvisionStatus(enum.Enum):
    RIGHT_SIZED = "right_sized"
    UNDER_PROVISIONED = "under_provisioned"
    OVER_PROVISIONED = "over_provisioned"
    UNDECIDED = "undecided"


@dataclasses.dataclass(frozen=True)
class ProvisionRecommendation:
    status: ProvisionStatus
    num_brokers: int = -1          # brokers to add (UNDER) / removable (OVER)
    resource: Optional[int] = None
    reason: str = ""

    def to_dict(self) -> Dict[str, object]:
        out: Dict[str, object] = {"status": self.status.value, "reason": self.reason}
        if self.num_brokers >= 0:
            out["numBrokers"] = self.num_brokers
        if self.resource is not None:
            out["resource"] = Resource(self.resource).resource_name
        return out


@dataclasses.dataclass
class ProvisionResponse:
    """Aggregated verdict (UNDER > OVER > RIGHT_SIZED > UNDECIDED)."""

    status: ProvisionStatus = ProvisionStatus.UNDECIDED
    recommendations: List[ProvisionRecommendation] = dataclasses.field(default_factory=list)

    _RANK = {ProvisionStatus.UNDER_PROVISIONED: 3, ProvisionStatus.OVER_PROVISIONED: 2,
             ProvisionStatus.RIGHT_SIZED: 1, ProvisionStatus.UNDECIDED: 0}

    def aggregate(self, rec: ProvisionRecommendation) -> None:
        if rec.status != ProvisionStatus.RIGHT_SIZED:
            self.recommendations.append(rec)
        if self._RANK[rec.status] > self._RANK[self.status]:
            self.status = rec.status

    def to_dict(self) -> Dict[str, object]:
        return {"status": self.status.value,
                "recommendations": [r.to_dict() for r in self.recommendations]}


@dataclasses.dataclass
class _HostView:
    alive: np.ndarray
    load: np.ndarray
    cap: np.ndarray
    replica_counts: np.ndarray
    rf_max: int


def host_view(model: TensorClusterModel) -> _HostView:
    """Host copies of the arrays every per-goal verdict reads, fetched once."""
    rf = model.partition_replication_factor().cpu().numpy()
    return _HostView(alive=model.alive_broker_mask().cpu().numpy(),
                     load=model.broker_load().cpu().numpy(),
                     cap=model.broker_capacity.cpu().numpy(),
                     replica_counts=model.broker_replica_counts().cpu().numpy(),
                     rf_max=int(rf.max(initial=0)))


def provision_verdict_for_goal(spec: GoalSpec, model: TensorClusterModel,
                               constraint: BalancingConstraint,
                               satisfied_after: bool,
                               view: Optional[_HostView] = None
                               ) -> ProvisionRecommendation:
    """Per-goal verdict after optimization."""
    if view is None:
        view = host_view(model)
    alive = view.alive
    num_alive = max(int(alive.sum()), 1)
    load = view.load[alive]
    cap = view.cap[alive]

    if spec.kind in ("capacity", "potential_nw_out"):
        res = spec.resource if spec.resource >= 0 else int(Resource.NW_OUT)
        threshold = constraint.capacity_threshold[res]
        total_load = float(load[:, res].sum())
        per_broker_cap = float(cap[:, res].mean()) * threshold
        if not satisfied_after and per_broker_cap > 0:
            needed = math.ceil(total_load / per_broker_cap) - num_alive
            return ProvisionRecommendation(
                ProvisionStatus.UNDER_PROVISIONED, num_brokers=max(needed, 1),
                resource=res,
                reason=f"{spec.name}: total {Resource(res).resource_name} load "
                       f"{total_load:.1f} exceeds capacity at {num_alive} brokers")
        return ProvisionRecommendation(ProvisionStatus.RIGHT_SIZED, resource=res)

    if spec.kind == "resource_distribution":
        res = spec.resource
        low = constraint.low_utilization_threshold[res]
        total_load = float(load[:, res].sum())
        total_cap = max(float(cap[:, res].sum()), 1e-9)
        avg_pct = total_load / total_cap
        if low > 0 and avg_pct <= low:
            per_cap = total_cap / num_alive
            min_needed = max(math.ceil(total_load / max(low * per_cap, 1e-9)),
                             constraint.overprovisioned_min_brokers)
            removable = max(num_alive - min_needed, 0)
            if removable > 0:
                return ProvisionRecommendation(
                    ProvisionStatus.OVER_PROVISIONED, num_brokers=removable,
                    resource=res,
                    reason=f"{spec.name}: avg {Resource(res).resource_name} "
                           f"utilization {avg_pct:.3f} below threshold {low}")
        return ProvisionRecommendation(ProvisionStatus.RIGHT_SIZED, resource=res)

    if spec.kind == "replica_capacity":
        counts = view.replica_counts[alive]
        if not satisfied_after:
            total = int(counts.sum())
            needed = math.ceil(total / constraint.max_replicas_per_broker) - num_alive
            return ProvisionRecommendation(
                ProvisionStatus.UNDER_PROVISIONED, num_brokers=max(needed, 1),
                reason=f"{spec.name}: {total} replicas exceed "
                       f"{constraint.max_replicas_per_broker}/broker at {num_alive} brokers")
        return ProvisionRecommendation(ProvisionStatus.RIGHT_SIZED)

    if spec.kind in ("rack", "rack_distribution") and not satisfied_after:
        rf = view.rf_max
        if rf > model.num_racks:
            return ProvisionRecommendation(
                ProvisionStatus.UNDER_PROVISIONED, num_brokers=-1,
                reason=f"{spec.name}: max replication factor {rf} exceeds "
                       f"{model.num_racks} racks (add racks)")
    return ProvisionRecommendation(ProvisionStatus.UNDECIDED)
