"""The goal kinds beyond the default stack on the 12-broker cluster
(tests/test_optimizer.py:219): the port's ``optimize(fused=True)`` on the
grouped and on the sequential per-goal path against the JAX package's, per
goal the same packed slots and the same placement, and ``verify_run``
(tests/torch_port_helpers.py ``goal_kind_case`` gives the cases). Each case
checks its own outcome too: preferred replicas lead, no movable leader is
left on a demoted broker and no replica moves, the kafka-assigner pair
leaves at most one replica of a partition per rack, and the 2-rack cluster
ends within its rack quota."""

import pytest

from tests.torch_port_helpers import SPEC_12, check_goal_kinds, check_goal_kind_outcome

CASES = ["preferred", "demote", "kafka-assigner", "rack-distribution"]


@pytest.mark.parametrize("path", ["grouped", "per-goal"])
@pytest.mark.parametrize("case", CASES)
def test_goal_kinds_12_brokers(case, path):
    tm, trun = check_goal_kinds(SPEC_12, case, path)
    check_goal_kind_outcome(case, tm, trun)
