"""Per-goal balancedness scoring.

Parity with ``KafkaCruiseControlUtils.balancednessCostByGoal``
(KafkaCruiseControlUtils.java:694): each goal in the priority-ordered stack
carries a violation *cost*; costs decay geometrically with priority
position (one level higher priority ⇒ ``priority_weight``× the cost) and
hard goals weigh ``strictness_weight``× more than soft goals.  Costs are
normalized so the full stack sums to ``MAX_BALANCEDNESS_SCORE`` (100): a
cluster violating nothing scores 100, violating everything scores 0.

The score surfaces in two places, matching the reference:

- ``OptimizerRun.balancedness_before/_after`` (OptimizerResult.java:117-118
  ``onDemandBalancednessScoreBefore/After``);
- the goal-violation detector's rolling score in the anomaly-detector
  /state payload (GoalViolationDetector.java:106 → AnomalyDetectorState
  ``balancednessScore``), pinned to ``-1.0`` while offline replicas exist
  (GoalViolationDetector.java:69,281 — failure detectors own that state).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

MAX_BALANCEDNESS_SCORE = 100.0
# Sentinel while offline replicas exist (GoalViolationDetector.java:69).
BALANCEDNESS_SCORE_WITH_OFFLINE_REPLICAS = -1.0

DEFAULT_PRIORITY_WEIGHT = 1.1
DEFAULT_STRICTNESS_WEIGHT = 1.5


def balancedness_cost_by_goal(goals: Sequence, priority_weight: float = DEFAULT_PRIORITY_WEIGHT,
                              strictness_weight: float = DEFAULT_STRICTNESS_WEIGHT
                              ) -> Dict[str, float]:
    """Violation cost per goal name; costs sum to MAX_BALANCEDNESS_SCORE.

    ``goals`` is the priority-ordered stack of GoalSpecs (highest priority
    first, as the optimizer runs them).  Mirrors the two-step weight/cost
    computation of KafkaCruiseControlUtils.java:694-719.
    """
    if not goals:
        raise ValueError("at least one goal is required for balancedness costs")
    if priority_weight <= 0 or strictness_weight <= 0:
        raise ValueError(
            f"balancedness weights must be positive "
            f"(priority:{priority_weight}, strictness:{strictness_weight})")
    # Dedupe by name, keeping the highest-priority occurrence (duplicated
    # request goals would otherwise inflate weight_sum while the dict keeps
    # one entry, deflating every normalized cost).
    seen = set()
    unique = [g for g in goals
              if not (g.name in seen or seen.add(g.name))]
    costs: Dict[str, float] = {}
    weight_sum = 0.0
    prev_priority_weight = 1.0 / priority_weight
    for spec in reversed(unique):  # lowest priority first
        current = priority_weight * prev_priority_weight
        cost = current * (strictness_weight if spec.is_hard else 1.0)
        weight_sum += cost
        costs[spec.name] = cost
        prev_priority_weight = current
    return {name: MAX_BALANCEDNESS_SCORE * c / weight_sum
            for name, c in costs.items()}


def balancedness_score(cost_by_goal: Dict[str, float],
                       violated_goals: Iterable[str]) -> float:
    """MAX_BALANCEDNESS_SCORE minus the cost of each violated goal
    (OptimizerResult.java:123-130; unknown names cost nothing)."""
    score = MAX_BALANCEDNESS_SCORE
    for name in set(violated_goals):
        score -= cost_by_goal.get(name, 0.0)
    return score
