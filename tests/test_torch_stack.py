"""The full default stack on the 12-broker cluster of
tests/test_optimizer.py:219: the PyTorch port is equisatisfying per goal
with the JAX package's ``optimize(..., fused=False, frontier=False)``, and
its final placement passes both packages' ``verify_run``.  (Kept apart from
test_torch_optimizer.py so the two JAX stack compiles land on different
test workers.)"""

from tests.torch_port_helpers import SPEC_12, check_stack


def test_full_stack_12_brokers():
    jrun, trun = check_stack(SPEC_12)
    assert sum(g.actions_applied for g in trun.goal_results) > 0
    assert trun.num_candidates_scored > 0
