"""The port's repair oracle (``CRUISE_REPAIR_ORACLE=1``: the legacy gated
prefix admits and the unbounded broker drop loop) against the JAX
package's, on the CPU, on the grouped stack at 6 brokers and the
sequential per-goal path at 12, with a topic goal in the stack so that the
(topic, broker) pass runs too: placements and per-goal steps, actions and
flags equal.  And ``optimize_goal`` (the case of tests/test_swaps.py:71)
against the JAX package's.  The budget ablation and ``accepts_band_batch``
are in tests/test_torch_band_accepts.py.
"""

import dataclasses

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_GOAL_SPECS
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
from tests.test_swaps import _pair_model
from tests.torch_port_helpers import (PLACEMENT, SPEC_6, SPEC_12, JaxSpec, clear_cruise_env,
                                      goal_rows, jax_generate, to_torch)

# Topic goal in the stack: the oracle's (topic, broker) pass runs too.
ORACLE_STACK = ["RackAwareGoal", "ReplicaDistributionGoal", "TopicReplicaDistributionGoal",
                "LeaderReplicaDistributionGoal"]


def _assert_same(jrun, trun):
    assert goal_rows(trun, 5) == goal_rows(jrun, 5)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)


@pytest.fixture(scope="module")
def oracle_runs():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        clear_cruise_env(mp)
        for name, spec_kw, kw in (("grouped6", SPEC_6, {}),
                                  ("pergoal12", SPEC_12, dict(fuse_group_size=1))):
            jm = jax_generate(JaxSpec(**spec_kw))
            tm = to_torch(jm)
            mp.setenv("CRUISE_REPAIR_ORACLE", "1")
            reads = topt.REPAIR_ORACLE_COUNTERS["host_reads"]
            jrun = jopt.optimize(jm, ORACLE_STACK, raise_on_hard_failure=False, fused=True, **kw)
            trun = topt.optimize(tm, ORACLE_STACK, raise_on_hard_failure=False, fused=True,
                                 device="cpu", **kw)
            reads = topt.REPAIR_ORACLE_COUNTERS["host_reads"] - reads
            mp.delenv("CRUISE_REPAIR_ORACLE")
            bounded = topt.optimize(tm, ORACLE_STACK, raise_on_hard_failure=False, fused=True,
                                    device="cpu", **kw)
            out[name] = (jrun, trun, reads, bounded)
    return out


@pytest.mark.parametrize("case", ["grouped6", "pergoal12"])
def test_repair_oracle_places_as_jax(oracle_runs, case):
    jrun, trun, reads, _ = oracle_runs[case]
    _assert_same(jrun, trun)
    assert reads > 0
    # The legacy repair reports no repair steps, as the JAX package's.
    assert [g.repair_steps for g in trun.goal_results] == \
        [g.repair_steps for g in jrun.goal_results] == [0] * len(ORACLE_STACK)


@pytest.mark.parametrize("case", ["grouped6", "pergoal12"])
def test_repair_oracle_switch_is_read(oracle_runs, case):
    """Without the switch the same solve runs the bounded repair, which
    counts its repair steps (the port ignored the switch before)."""
    _, trun, _, bounded = oracle_runs[case]
    assert sum(g.repair_steps for g in bounded.goal_results) > 0
    assert all(g.repair_steps == 0 for g in trun.goal_results)


@pytest.mark.parametrize("swaps", [True, False], ids=["with-swaps", "without-swaps"])
def test_optimize_goal_matches_jax(swaps):
    """tests/test_swaps.py:71: DiskCapacityGoal on two brokers near their
    cap, with and without the swap batch."""
    jm = _pair_model()
    tm = to_torch(jm)
    jspec = dataclasses.replace(JAX_GOAL_SPECS["DiskCapacityGoal"], uses_swaps=swaps)
    tspec = dataclasses.replace(GOAL_SPECS["DiskCapacityGoal"], uses_swaps=swaps)
    jmodel, jsteps, jacts = jopt.optimize_goal(jm, jspec, (), JaxBC.default(),
                                               JaxOptions.none(jm))
    tmodel, tsteps, tacts = topt.optimize_goal(tm, tspec, (), BalancingConstraint.default(),
                                               OptimizationOptions.none(tm))
    assert (tsteps, tacts) == (jsteps, jacts)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tmodel, f).numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)
    load = np.asarray(jmodel.broker_load())[:, 3]
    assert (load[0] <= 80.0 + 1e-3) == swaps
