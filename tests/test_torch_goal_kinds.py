"""Goal semantics of the PyTorch port against the JAX package for the goal
kinds beyond the default 15-goal stack: ``preferred_leader``,
``min_topic_leaders`` and ``rack_distribution``, and the kafka-assigner
goals (existing kinds with a flag).

One candidate batch per case (moves, matched moves, leadership transfers
and swaps, plus the leadership transfers and moves the new goals' own
rankings pick) is built by the JAX package and carried across.  Per goal:
``limits``, ``goal_satisfied``, ``violated_brokers``, ``self_feasible``,
``accepts``, ``score``, ``source_replica_relevance`` and ``dest_room``; the
K5, K5b and K9 plain twins against the JAX package's eligible line, folded
``accepts`` and ``goal_satisfied``.  Every value is integer-valued or a
fixed constant, so everything is exact (the kafka-assigner disk goal's
load floats within rtol 1e-5 of the largest |value|, as in
tests/test_torch_goals.py).

Cases, all with topics 0 and 1 designated for min leaders:
- ``healthy``: the 12-broker cluster as generated;
- ``dead``: broker 2 dead (healing moves and the offline bonus);
- ``demoted``: broker 3 demoted and the second replica leading every
  other partition (the demote path and broken preferences);
- ``two-racks``: 10 brokers on 2 racks at RF 3 (quota 2 a rack), one
  partition in three put on a single rack."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.tensor_model import BrokerState
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from tests.torch_port_helpers import (DESIGNATED, SPEC_12, assert_float_close,
                                      break_preference, cand_to_torch, one_rack, to_torch)

GOALS = ["PreferredLeaderElectionGoal", "MinTopicLeadersPerBrokerGoal",
         "RackAwareDistributionGoal", "KafkaAssignerEvenRackAwareGoal",
         "KafkaAssignerDiskUsageDistributionGoal"]
STRUCTURAL = ["RackAwareGoal", "RackAwareDistributionGoal", "TopicReplicaDistributionGoal",
              "MinTopicLeadersPerBrokerGoal", "PreferredLeaderElectionGoal"]
SPEC_TWO_RACKS = dict(num_brokers=10, num_racks=2, num_topics=5, mean_partitions_per_topic=12.0,
                      replication_factor=3, distribution="exponential", seed=5)
CASES = ["healthy", "dead", "demoted", "two-racks"]

_CASES = {}


def constraints():
    return (dataclasses.replace(JaxBC.default(), min_leader_topic_ids=DESIGNATED),
            dataclasses.replace(BalancingConstraint.default(), min_leader_topic_ids=DESIGNATED))


def _jax_batch(jm, arrays, opts, con):
    names = ("ReplicaDistributionGoal", "LeaderReplicaDistributionGoal",
             "DiskUsageDistributionGoal", "PreferredLeaderElectionGoal",
             "MinTopicLeadersPerBrokerGoal", "RackAwareDistributionGoal")
    rd, lrd, dud, ple, mtl, rad = (JAX_SPECS[n] for n in names)
    parts = [jc.combined_move_candidates(rd, jm, arrays, con, opts, 24, 8, num_matched=64),
             jc.leadership_candidates(lrd, jm, arrays, con, opts, 24),
             jc.swap_candidates(dud, jm, arrays, con, opts, 16, 8),
             jc.leadership_candidates(ple, jm, arrays, con, opts, 24),
             jc.combined_move_candidates(mtl, jm, arrays, con, opts, 16, 8),
             jc.leadership_candidates(mtl, jm, arrays, con, opts, 16),
             jc.swap_candidates(mtl, jm, arrays, con, opts, 8, 8),
             jc.combined_move_candidates(rad, jm, arrays, con, opts, 16, 8)]
    out = parts[0]
    for p in parts[1:]:
        out = jc.concat_candidates(out, p)
    return out


def case_models(case: str):
    """The JAX model of ``case``."""
    if case == "two-racks":
        return one_rack(jax_generate(JaxSpec(**SPEC_TWO_RACKS)))
    jm = jax_generate(JaxSpec(**SPEC_12))
    if case == "dead":
        jm = jm.set_broker_state(2, BrokerState.DEAD)
    elif case == "demoted":
        jm = break_preference(jm, every=2).set_broker_state(3, BrokerState.DEMOTED)
    return jm


def _case(case: str):
    if case not in _CASES:
        jm = case_models(case)
        jcon, tcon = constraints()
        arrays = JaxBrokerArrays.from_model(jm)
        cand = jax.jit(_jax_batch, static_argnums=3)(jm, arrays, JaxOptions.none(jm), jcon)
        tm = to_torch(jm)
        accepted = np.random.default_rng(4).random(cand.k) < 0.8
        _CASES[case] = (jm, arrays, cand, tm, BrokerArrays.from_model(tm, True, True),
                        cand_to_torch(cand), accepted, jcon, tcon)
    return _CASES[case]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("goal", GOALS)
def test_goal_functions_match(goal, case):
    jm, ja, jcand, tm, ta, tcand, _, jcon, tcon = _case(case)
    jspec, tspec = JAX_SPECS[goal], GOAL_SPECS[goal]
    jlo, jhi = jk.limits(jspec, jm, ja, jcon)
    tlo, thi = tk.limits(tspec, tm, ta, tcon)
    assert_float_close(tlo.numpy(), np.asarray(jlo), "lower")
    assert_float_close(thi.numpy(), np.asarray(jhi), "upper")
    assert bool(tk.goal_satisfied(tspec, tm, ta, tcon)) == \
        bool(jk.goal_satisfied(jspec, jm, ja, jcon))
    np.testing.assert_array_equal(tk.violated_brokers(tspec, tm, ta, tcon).numpy(),
                                  np.asarray(jk.violated_brokers(jspec, jm, ja, jcon)))
    np.testing.assert_array_equal(tk.broker_metric(tspec, tm, ta, tcon).numpy() > 0,
                                  np.asarray(jk.broker_metric(jspec, jm, ja, jcon)) > 0)
    np.testing.assert_array_equal(tk.self_feasible(tspec, tm, ta, tcand, tcon).numpy(),
                                  np.asarray(jk.self_feasible(jspec, jm, ja, jcand, jcon)),
                                  err_msg="self_feasible")
    np.testing.assert_array_equal(tk.accepts(tspec, tm, ta, tcand, tcon).numpy(),
                                  np.asarray(jk.accepts(jspec, jm, ja, jcand, jcon)),
                                  err_msg="accepts")
    assert_float_close(tk.score(tspec, tm, ta, tcand, tcon).numpy(),
                       np.asarray(jk.score(jspec, jm, ja, jcand, jcon)), "score")
    rel_t = tk.source_replica_relevance(tspec, tm, ta, tcon).numpy()
    rel_j = np.asarray(jk.source_replica_relevance(jspec, jm, ja, jcon))
    assert_float_close(rel_t, rel_j, "relevance")
    np.testing.assert_array_equal(rel_t > -1e29, rel_j > -1e29, err_msg="relevant set")
    assert_float_close(tk.dest_room(tspec, tm, ta, tcon).numpy(),
                       np.asarray(jk.dest_room(jspec, jm, ja, jcon)), "dest_room")


def test_cases_exercise_the_new_kinds():
    """The fixtures are not vacuous: wrong leaders, demoted sources, broken
    quotas and short brokers exist where they should, and the batch holds
    eligible lanes of each new kind."""
    for case, goal in (("demoted", "PreferredLeaderElectionGoal"),
                       ("two-racks", "RackAwareDistributionGoal"),
                       ("healthy", "MinTopicLeadersPerBrokerGoal")):
        _, _, _, tm, ta, tcand, _, _, tcon = _case(case)
        spec = GOAL_SPECS[goal]
        assert not bool(tk.goal_satisfied(spec, tm, ta, tcon)), (case, goal)
        _, eligible = tk.goal_masks_plain(spec, tm, ta, tcand, tcon)
        assert eligible.any(), (case, goal)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("goal", GOALS)
def test_k5_plain_twin_matches_the_jax_masks(goal, case):
    jm, ja, jcand, tm, ta, tcand, accepted, jcon, tcon = _case(case)
    jspec = JAX_SPECS[goal]

    @jax.jit
    def jax_masks(m, a, c):
        sc = jk.score(jspec, m, a, c, jcon)
        el = c.valid & jk.self_feasible(jspec, m, a, c, jcon) & jnp.asarray(accepted) & \
            (sc > jopt._MIN_SCORE)
        return sc, el

    jscore, jelig = jax_masks(jm, ja, jcand)
    import torch
    score, eligible = tk.goal_masks_plain(GOAL_SPECS[goal], tm, ta, tcand, tcon,
                                          accepted=torch.from_numpy(accepted))
    np.testing.assert_array_equal(eligible.numpy(), np.asarray(jelig))
    assert_float_close(score.numpy(), np.asarray(jscore), "score")


@pytest.mark.parametrize("case", CASES)
def test_k5b_and_k9_plain_twins_match_the_jax_package(case):
    """K5b's twin is the AND of the JAX package's ``accepts`` over the
    structural goals it takes; K9's twin is its ``goal_satisfied`` over the
    whole set (and the offline flag)."""
    jm, ja, jcand, tm, ta, tcand, _, jcon, tcon = _case(case)
    prevs = [n for n in STRUCTURAL if GOAL_SPECS[n].kind in tk._STRUCTURAL_KINDS]
    want = np.ones(jcand.k, bool)
    for n in prevs:
        want &= np.asarray(jk.accepts(JAX_SPECS[n], jm, ja, jcand, jcon))
    got = tk.structural_accepts(tuple(GOAL_SPECS[n] for n in prevs), tm, ta, tcand, tcon)
    np.testing.assert_array_equal(got.numpy(), want)
    specs = tuple(GOAL_SPECS[n] for n in GOALS + STRUCTURAL)
    sat, off = tk.stack_satisfied(specs, tm, ta, tcon)
    np.testing.assert_array_equal(
        sat.numpy(), [bool(jk.goal_satisfied(JAX_SPECS[n], jm, ja, jcon))
                      for n in GOALS + STRUCTURAL])
    assert bool(off[0]) == bool((np.asarray(jm.replica_offline_now())
                                 & np.asarray(jm.replica_valid)).any())
