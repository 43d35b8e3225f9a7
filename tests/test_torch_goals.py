"""Goal semantics of the PyTorch port against the JAX package, one case per
goal of the default stack and per goal of the other inter-broker kinds
(rack distribution, preferred leader, min topic leaders, the kafka-assigner
pair): ``limits``, ``goal_satisfied``, ``self_feasible``, ``accepts``,
``score`` and ``source_replica_relevance`` on one candidate batch (moves,
matched moves, leadership transfers and swaps) built by the JAX package
and carried across, and for the intra-broker disk goals on the same
cluster (one disk a broker).

Masks and verdicts exact; floats within rtol 1e-5 of the largest |value|
(XLA and PyTorch sum the broker loads in different orders).  The "dead"
variant kills a broker so healing moves and the offline bonus take part."""

import jax
import numpy as np
import pytest

from cruise_control_tpu.analyzer import candidates as jc
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
from tests.torch_port_helpers import (SPEC_12, STACK, assert_float_close, cand_to_torch,
                                      to_torch)

_CASES = {}


def _jax_batch(jm, arrays, opts):
    """Moves (cross + matched), leadership transfers and swaps, built by the
    JAX package."""
    con = JaxBC.default()
    rd, lrd, dud = (JAX_SPECS[n] for n in ("ReplicaDistributionGoal",
                                           "LeaderReplicaDistributionGoal",
                                           "DiskUsageDistributionGoal"))
    moves = jc.combined_move_candidates(rd, jm, arrays, con, opts, 24, 8, num_matched=64)
    lead = jc.leadership_candidates(lrd, jm, arrays, con, opts, 24)
    swaps = jc.swap_candidates(dud, jm, arrays, con, opts, 16, 8)
    return jc.concat_candidates(jc.concat_candidates(moves, lead), swaps)


def _case(dead: bool):
    if dead not in _CASES:
        jm = jax_generate(JaxSpec(**SPEC_12))
        if dead:
            jm = jm.set_broker_state(2, BrokerState.DEAD)
        arrays = JaxBrokerArrays.from_model(jm)
        cand = jax.jit(_jax_batch)(jm, arrays, JaxOptions.none(jm))
        tm = to_torch(jm)
        _CASES[dead] = (jm, arrays, cand, tm, BrokerArrays.from_model(tm, True),
                        cand_to_torch(cand))
    return _CASES[dead]


# The inter-broker goals outside the 15-goal stack.
OTHER_GOALS = ["RackAwareDistributionGoal", "PreferredLeaderElectionGoal",
               "MinTopicLeadersPerBrokerGoal", "KafkaAssignerEvenRackAwareGoal",
               "KafkaAssignerDiskUsageDistributionGoal"]


@pytest.mark.parametrize("dead", [False, True], ids=["healthy", "dead"])
@pytest.mark.parametrize("goal", STACK + OTHER_GOALS)
def test_goal_functions_match(goal, dead):
    _check_functions(goal, dead)


def _check_functions(goal, dead):
    jm, ja, jcand, tm, ta, tcand = _case(dead)
    jspec, tspec = JAX_SPECS[goal], GOAL_SPECS[goal]
    jcon, tcon = JaxBC.default(), BalancingConstraint.default()

    jlo, jhi = jk.limits(jspec, jm, ja, jcon)
    tlo, thi = tk.limits(tspec, tm, ta, tcon)
    assert_float_close(tlo.numpy(), np.asarray(jlo), "lower")
    assert_float_close(thi.numpy(), np.asarray(jhi), "upper")
    assert bool(tk.goal_satisfied(tspec, tm, ta, tcon)) == \
        bool(jk.goal_satisfied(jspec, jm, ja, jcon))
    np.testing.assert_array_equal(
        tk.violated_brokers(tspec, tm, ta, tcon).numpy(),
        np.asarray(jk.violated_brokers(jspec, jm, ja, jcon)))

    feas_t = tk.self_feasible(tspec, tm, ta, tcand, tcon).numpy()
    feas_j = np.asarray(jk.self_feasible(jspec, jm, ja, jcand, jcon))
    np.testing.assert_array_equal(feas_t, feas_j, err_msg="self_feasible")
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


@pytest.mark.parametrize("goal", ["IntraBrokerDiskCapacityGoal",
                                  "IntraBrokerDiskUsageDistributionGoal"])
def test_kinds_outside_the_slice_raise(goal):
    """The intra-broker disk goals on this cluster's one disk a broker:
    every function equals the JAX package's on the inter-broker batch (the
    disk veto judges its moves and swaps).  tests/test_torch_intra_disk.py
    holds them on a JBOD cluster."""
    _check_functions(goal, False)
