"""The facade's default goal order (``DEFAULT_GOAL_ORDER``, 16 goals with
MinTopicLeadersPerBrokerGoal second) at 6 brokers on the per-goal path,
with no topic designated for min leaders: the port's
``optimize(fused=True)`` against the JAX package's, per goal the same
packed slots and the same placement, and ``verify_run``. The goal is then
satisfied throughout, but its (topic, broker) leader budgets still shape
the selection of every later goal. (One JAX compile family per file, so the
compiles land on different test workers.)"""

from tests.torch_port_helpers import SPEC_6, check_goal_kinds


def test_default_goal_order_nodesig_6_brokers_pergoal():
    _, trun = check_goal_kinds(SPEC_6, "default", "per-goal")
    assert sum(g.actions_applied for g in trun.goal_results) > 0
