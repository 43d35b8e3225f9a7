"""Post-hoc optimization invariant verification.

Counterpart of ``cruise_control_tpu/analyzer/verifier.py`` (reference:
OptimizationVerifier.java:53): invariant checks instead of golden outputs —
sanity of the final model, replication factors and total load unchanged,
hard goals satisfied, no soft goal regressed, nothing left on dead brokers,
proposals reachable.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.optimizer import OptimizerRun
from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from cruise_control_tpu_torch.model.tensor_model import TensorClusterModel


class VerificationError(AssertionError):
    pass


def verify_run(initial: TensorClusterModel, run: OptimizerRun,
               goal_names: Sequence[str],
               constraint: Optional[BalancingConstraint] = None,
               proposals: Optional[List[ExecutionProposal]] = None) -> None:
    """Raise VerificationError on any violated invariant."""
    constraint = constraint or BalancingConstraint.default()
    final = run.model
    final.sanity_check()

    rf0 = initial.partition_replication_factor().cpu().numpy()
    rf1 = final.partition_replication_factor().cpu().numpy()
    if not (rf0 == rf1).all():
        bad = np.nonzero(rf0 != rf1)[0][:5]
        raise VerificationError(f"replication factor changed for partitions {bad}")

    load0 = initial.broker_load().cpu().numpy().sum(axis=0)
    load1 = final.broker_load().cpu().numpy().sum(axis=0)
    if not np.allclose(load0, load1, rtol=1e-4):
        raise VerificationError(f"total load changed: {load0} -> {load1}")

    arrays = BrokerArrays.from_model(final)
    for spec, res in zip(goals_by_priority(goal_names), run.goal_results):
        sat = bool(kernels.goal_satisfied(spec, final, arrays, constraint))
        if spec.is_hard and not sat:
            raise VerificationError(f"hard goal {spec.name} violated after optimization")
        if res.satisfied_before and not sat:
            raise VerificationError(f"goal {spec.name} regressed (was satisfied before)")

    dead = ~final.alive_broker_mask().cpu().numpy()
    rb = final.replica_broker.cpu().numpy()
    valid = final.replica_valid.cpu().numpy()
    any_hard = any(s.is_hard for s in goals_by_priority(goal_names))
    if any_hard and dead[rb[valid]].any():
        raise VerificationError("replicas remain on dead brokers after hard goals")

    if proposals is not None:
        _verify_proposals(final, proposals)


def _verify_proposals(final: TensorClusterModel,
                      proposals: List[ExecutionProposal]) -> None:
    """Each proposal must be reachable and produce the final placement."""
    for prop in proposals:
        if len(prop.old_replicas) != len(prop.new_replicas):
            raise VerificationError(f"proposal for partition {prop.partition} changes RF")
        old_brokers = sorted(p.broker for p in prop.old_replicas)
        if len(set(old_brokers)) != len(old_brokers):
            raise VerificationError(
                f"proposal for partition {prop.partition} has duplicate old brokers")
        new_brokers = sorted(p.broker for p in prop.new_replicas)
        if len(set(new_brokers)) != len(new_brokers):
            raise VerificationError(
                f"proposal for partition {prop.partition} has duplicate new brokers")
    pr = final.partition_replicas.cpu().numpy()
    rb1 = final.replica_broker.cpu().numpy()
    for prop in proposals:
        part = prop.partition
        slots = pr[part][pr[part] >= 0]
        actual = sorted(int(rb1[r]) for r in slots)
        claimed = sorted(p.broker for p in prop.new_replicas)
        if actual != claimed:
            raise VerificationError(
                f"partition {part}: proposal claims brokers {claimed}, model has {actual}")
