"""``optimize(fused=True, fuse_group_size=1)`` on the 8-broker cluster
(__graft_entry__.py:22): the port's sequential per-goal path (one satisfied-sweep, then
the chunked frontier driver per unsatisfied goal, its gated steps run
eagerly on the CPU) against the JAX package's — per goal the same steps,
actions, satisfied flags before and after, capped flag and repair
counters, the same chunk records, the same goals skipped by the sweep, and
the same final placement.  Below the 64-broker floor every chunk is dense.
(One JAX per-goal stack compile family per file, so the compiles land on
different test workers.)"""

from tests.torch_port_helpers import SPEC_ENTRY, check_per_goal, clear_cruise_env


def test_per_goal_stack_8_brokers(monkeypatch):
    clear_cruise_env(monkeypatch)
    _, trun = check_per_goal(SPEC_ENTRY)
    assert sum(g.actions_applied for g in trun.goal_results) > 0
    for g in trun.goal_results:
        if g.chunks is not None:
            assert all(c["bucket"] is None for c in g.chunks)
            assert g.replays >= g.steps
