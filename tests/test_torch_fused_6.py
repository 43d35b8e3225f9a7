"""``optimize(fused=True)`` on the 6-broker cluster (tests/test_optimizer.py:61): the
port's grouped stack (the whole stack as one group, gated steps run eagerly
on the CPU) against the JAX package's ``_stack_fixpoint`` program — the
same integer packed slots per goal, the whole i32[11, G] packed matrix
equal, identical final placements — and against the port's own unfused
path.  (One JAX stack compile per file, so the compiles land on different
test workers.)"""

from tests.torch_port_helpers import SPEC_6, check_fused, check_packed_matrix


def test_fused_stack_6_brokers():
    jm, tm, _, trun = check_fused(SPEC_6)
    assert sum(g.actions_applied for g in trun.goal_results) > 0
    check_packed_matrix(jm, tm)
