"""The facade's default goal order (``DEFAULT_GOAL_ORDER``, 16 goals) on
the combinations of size, path and designated topics that the tier-1
files (tests/test_torch_goal_kinds_{designated,nodesig}_*.py) leave out:
the port's ``optimize(fused=True)`` against the JAX package's, per goal
the same packed slots and the same placement, and ``verify_run``.  Each
case compiles one JAX program family of the 16-goal stack (two to four
minutes of one worker on the CPU), so they are marked ``slow``."""

import pytest

from tests.torch_port_helpers import SPEC_6, SPEC_12, SPEC_ENTRY, check_goal_kinds

SPECS = {"6": SPEC_6, "8": SPEC_ENTRY, "12": SPEC_12}


@pytest.mark.slow
@pytest.mark.parametrize("case,size,path", [
    ("default-designated", "6", "per-goal"), ("default-designated", "8", "grouped"),
    ("default-designated", "8", "per-goal"), ("default-designated", "12", "grouped"),
    ("default", "6", "grouped"), ("default", "8", "grouped"), ("default", "8", "per-goal"),
    ("default", "12", "grouped"), ("default", "12", "per-goal")])
def test_default_goal_order_matches_the_jax_package(case, size, path):
    _, trun = check_goal_kinds(SPECS[size], case, path)
    assert sum(g.actions_applied for g in trun.goal_results) > 0
