"""``optimize(fused=True, fast_mode=True)`` on the 12-broker cluster of
tests/test_optimizer.py:219: the host arithmetic of the fast mode (halved
candidate widths, a quarter of the step budget) feeds the same grouped
stack in both packages — the same integer packed slots per goal and the
same placement as the JAX package, and as the port's unfused fast path."""

from tests.torch_port_helpers import SPEC_12, check_fused


def test_fused_fast_mode():
    _, _, _, trun = check_fused(SPEC_12, fast_mode=True)
    assert all(g.steps <= 64 for g in trun.goal_results)
