"""``optimize(fused=True, fuse_group_size=4)`` on the 6-broker cluster of
tests/test_optimizer.py:61: four groups, each run by the JAX package as its
own ``_stack_fixpoint`` program with the earlier groups' goals as the
acceptance context, and by the port as gated steps chained over the same
working state.  Same integer packed slots per goal and the same placement
as the JAX package, and as the port's unfused path."""

from tests.torch_port_helpers import SPEC_6, check_fused


def test_fused_groups_of_four():
    _, _, _, trun = check_fused(SPEC_6, fuse_group_size=4)
    # A group's packed stats are fetched once, on its lead goal.
    leads = [i for i in range(len(trun.goal_results)) if i % 4 == 0]
    for i, g in enumerate(trun.goal_results):
        assert g.fetches >= 1 + (i in leads)
