"""``optimize(fused=True)`` on the 8-broker cluster (__graft_entry__.py:22): the
port's grouped stack (the whole stack as one group, gated steps run eagerly
on the CPU) against the JAX package's ``_stack_fixpoint`` program — the
same integer packed slots per goal, the whole i32[11, G] packed matrix
equal, identical final placements — and against the port's own unfused
path.  (One JAX stack compile per file, so the compiles land on different
test workers.)"""

from tests.torch_port_helpers import SPEC_ENTRY, check_fused, check_packed_matrix


def test_fused_stack_8_brokers():
    jm, tm, _, trun = check_fused(SPEC_ENTRY)
    assert sum(g.actions_applied for g in trun.goal_results) > 0
    check_packed_matrix(jm, tm)
