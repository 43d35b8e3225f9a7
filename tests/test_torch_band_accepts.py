"""The port's budget ablation (``_DBG_NO_BUDGETS``: the band goals'
``accepts`` in place of the channel budgets, through
``accepts_band_batch``) against the JAX package's, on the CPU;
``accepts_band_batch`` itself against the JAX function and the AND-fold of
the per-spec ``accepts`` (the cases of tests/test_optimizer.py:170-305).
Placements and
per-goal steps and actions are compared exactly; masks are booleans.
``optimize_goal`` is in tests/test_torch_repair_oracle.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cruise_control_tpu.analyzer import candidates as jcand
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.actions import ActionType
from cruise_control_tpu.analyzer.actions import make_candidates as jax_make_candidates
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jkern
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_GOAL_SPECS
from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tkern
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS, goals_by_priority
from cruise_control_tpu_torch.analyzer.state import BrokerArrays, OptimizationOptions
from tests.torch_port_helpers import (PLACEMENT, SPEC_6, SPEC_12, STACK, JaxSpec,
                                      cand_to_torch, clear_cruise_env, goal_rows, jax_generate,
                                      to_jax, to_torch)

# A stack of its own (the JAX package keys its programs without the ablation
# flag): band goals before the later ones.
ABLATION_STACK = ["DiskCapacityGoal", "ReplicaDistributionGoal",
                  "LeaderReplicaDistributionGoal"]
BAND_PREV = ["ReplicaCapacityGoal", "DiskCapacityGoal", "NetworkInboundCapacityGoal",
             "CpuCapacityGoal", "ReplicaDistributionGoal", "PotentialNwOutGoal",
             "DiskUsageDistributionGoal", "LeaderReplicaDistributionGoal",
             "LeaderBytesInDistributionGoal"]


def _assert_same(jrun, trun):
    assert goal_rows(trun, 5) == goal_rows(jrun, 5)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)


@pytest.fixture(scope="module")
def ablation_runs():
    jm = jax_generate(JaxSpec(**SPEC_6))
    tm = to_torch(jm)
    with pytest.MonkeyPatch.context() as mp:
        clear_cruise_env(mp)
        mp.setattr(jopt, "_DBG_NO_BUDGETS", True)
        mp.setattr(topt, "_DBG_NO_BUDGETS", True)
        jrun = jopt.optimize(jm, ABLATION_STACK, raise_on_hard_failure=False, fused=True)
        trun = topt.optimize(tm, ABLATION_STACK, raise_on_hard_failure=False, fused=True,
                             device="cpu")
    budgets = topt.optimize(tm, ABLATION_STACK, raise_on_hard_failure=False, fused=True,
                            device="cpu")
    return jrun, trun, budgets


def test_no_budgets_ablation_places_as_jax(ablation_runs):
    jrun, trun, _ = ablation_runs
    _assert_same(jrun, trun)
    assert sum(g.actions_applied for g in trun.goal_results) > 0


def test_no_budgets_ablation_is_read(ablation_runs):
    """The flag changes the solve: the ablation is a different selection
    (no budgets), not today's."""
    _, trun, budgets = ablation_runs
    assert goal_rows(trun, 2) != goal_rows(budgets, 2) or any(
        not torch.equal(getattr(trun.model, f), getattr(budgets.model, f)) for f in PLACEMENT)


@pytest.fixture(scope="module")
def band_case():
    """tests/test_optimizer.py:170: a 6-broker cluster, nine band goals
    before NetworkOutboundUsageDistributionGoal, its move, leadership and
    swap batches (built by the JAX package, carried over)."""
    from cruise_control_tpu.model.generator import generate_cluster as jgen
    jm = jgen(JaxSpec(num_brokers=6, num_racks=3, num_topics=4,
                      mean_partitions_per_topic=10.0, seed=21))
    jarr = JaxArrays.from_model(jm)
    con = JaxBC.default()
    opts = JaxOptions.none(jm)
    goal = jax_goals(["NetworkOutboundUsageDistributionGoal"])[0]
    batches = {
        "move": jcand.move_candidates(goal, jm, jarr, con, opts, 32, 6),
        "leadership": jcand.leadership_candidates(goal, jm, jarr, con, opts, 16),
        "swap": jcand.swap_candidates(goal, jm, jarr, con, opts, 16, 4),
    }
    return jm, jarr, batches


@pytest.mark.parametrize("batch", ["move", "leadership", "swap"])
def test_accepts_band_batch_matches_jax_and_fold(band_case, batch):
    jm, jarr, batches = band_case
    jc = batches[batch]
    jprev = tuple(jax_goals(BAND_PREV))
    want = np.asarray(jkern.accepts_band_batch(jprev, jm, jarr, jc, JaxBC.default()))
    tm = to_torch(jm)
    tarr = BrokerArrays.from_model(tm)
    tc = cand_to_torch(jc)
    prev = tuple(goals_by_priority(BAND_PREV))
    got = tkern.accepts_band_batch(prev, tm, tarr, tc, BalancingConstraint.default())
    folded = torch.ones((tc.k,), dtype=torch.bool)
    for s in prev:
        folded &= tkern.accepts(s, tm, tarr, tc, BalancingConstraint.default())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), folded.numpy())
    assert 0 < int(got.sum()) or batch == "leadership"


@pytest.mark.parametrize("hard_dist", [False, True], ids=["soft", "hard-dist"])
def test_band_budgets_subsume_band_accepts(hard_dist):
    """tests/test_optimizer.py:201-305 on the port: after the hard prefix,
    every action one ReplicaDistributionGoal step applies passes the band
    accepts of every previous goal (with a hard distribution goal: its
    upper side only), and the port's mask equals the JAX function's."""
    tm = to_torch(jax_generate(JaxSpec(**SPEC_12)))
    con = BalancingConstraint.default()
    options = OptimizationOptions.none(tm)
    prev = tuple(goals_by_priority(STACK[:6]))
    if hard_dist:
        prev = prev + (dataclasses.replace(GOAL_SPECS["NetworkInboundUsageDistributionGoal"],
                                           is_hard=True),)
    m = tm
    for i, g in enumerate(prev):
        m, _, _ = topt.optimize_goal(m, g, prev[:i], con, options)
    g = GOAL_SPECS["ReplicaDistributionGoal"]
    new_m, n, _ = topt._goal_step(m, options, g, prev, con,
                                  topt.cgen.default_num_sources(m),
                                  topt.cgen.default_num_dests(m))
    assert int(n) > 0
    moved = torch.nonzero(m.replica_broker != new_m.replica_broker).flatten()
    assert moved.numel() > 0
    jm = to_jax(m)
    k = int(moved.numel())
    jc = jax_make_candidates(
        jm, jnp.asarray(moved.numpy(), jnp.int32),
        jnp.asarray(new_m.replica_broker[moved].numpy(), jnp.int32),
        jnp.full((k,), ActionType.INTER_BROKER_REPLICA_MOVEMENT, jnp.int32),
        jnp.full((k,), -1, jnp.int32), jnp.ones((k,), bool))
    jprev = tuple(dataclasses.replace(JAX_GOAL_SPECS[s.name], is_hard=s.is_hard) for s in prev)
    want = np.asarray(jkern.accepts_band_batch(jprev, jm, JaxArrays.from_model(jm), jc,
                                               JaxBC.default()))
    got = tkern.accepts_band_batch(prev, m, BrokerArrays.from_model(m), cand_to_torch(jc),
                                   con)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(got.all()), "an applied action violates a prev goal's band accepts"
