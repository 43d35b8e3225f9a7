"""A warm-started solve on the port's pipelined path against the JAX
package's, on the skewed 16-broker model with the dense floor lowered to 8
in both packages: the previous solve converges, a few partitions' loads
change (a seeded draw), ``model_delta`` gives the seed mask, and the warm
pipelined solve equals the JAX package's per goal (with chunk records and
cross-goal counts) and in placement; its first chunk runs compacted on the
seed."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.state import WarmStart as JaxWarm
from cruise_control_tpu.analyzer.state import model_delta as jax_delta
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.state import WarmStart, model_delta
from tests.test_torch_pipeline import compare
from tests.torch_port_helpers import CRUISE_ENV, skewed_models, to_torch

STACK = ["RackAwareGoal", "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
         "CpuUsageDistributionGoal", "LeaderReplicaDistributionGoal"]
KW = dict(fused=True, pipeline=True, raise_on_hard_failure=False)


def _perturb_partitions(model, rng, broker: int, count: int):
    """Scale the loads of ``count`` partitions led from ``broker`` by a
    factor in [2, 3): few brokers change, so the seed mask stays small."""
    rb = np.asarray(model.replica_broker)
    rp = np.asarray(model.replica_partition)
    lead = np.asarray(model.replica_is_leader) & np.asarray(model.replica_valid)
    hot = np.zeros(model.num_partitions, bool)
    hot[rp[lead & (rb == broker)][:count]] = True
    factor = np.ones((model.num_partitions, 1), np.float32)
    factor[hot] = rng.uniform(2.0, 3.0, (int(hot.sum()), 1))
    return model.replace(
        replica_load_leader=jnp.asarray(np.asarray(model.replica_load_leader) * factor[rp]),
        replica_load_follower=jnp.asarray(np.asarray(model.replica_load_follower)
                                          * factor[rp]))


@pytest.fixture(scope="module")
def converged():
    """The JAX package's and the port's pipelined solves of the skewed
    model, with the dense floor lowered to 8 in both packages for the
    module (restored after it) and the switches cleared."""
    saved = {k: os.environ.pop(k) for k in CRUISE_ENV if k in os.environ}
    floors = jopt._FRONTIER_DENSE_MIN, topt._FRONTIER_DENSE_MIN
    jopt._FRONTIER_DENSE_MIN = topt._FRONTIER_DENSE_MIN = 8
    try:
        jm, tm = skewed_models(7)
        jprev = jopt.optimize(jm, STACK, **KW)
        tprev = topt.optimize(tm, STACK, device="cpu", **KW)
        compare(jprev, tprev)
        yield jprev, tprev
    finally:
        jopt._FRONTIER_DENSE_MIN, topt._FRONTIER_DENSE_MIN = floors
        os.environ.update(saved)


@pytest.mark.parametrize("broker", [3, 5])
def test_warm_pipelined_solve_matches_jax(broker, converged):
    jprev, tprev = converged
    jm2 = _perturb_partitions(jprev.model, np.random.default_rng(5), broker, 4)
    tm2 = to_torch(jm2)
    jdelta = jax_delta(jprev.model, jm2)
    tdelta = model_delta(tprev.model, tm2)
    np.testing.assert_array_equal(tdelta.changed_mask, jdelta.changed_mask)
    jrun = jopt.optimize(jm2, STACK, warm_start=JaxWarm(prev_model=jprev.model,
                                                        active_mask=jdelta.changed_mask),
                         **KW)
    trun = topt.optimize(tm2, STACK, device="cpu",
                         warm_start=WarmStart(prev_model=tprev.model,
                                              active_mask=tdelta.changed_mask), **KW)
    compare(jrun, trun)
    assert trun.warm and trun.seed_frontier_size == jrun.seed_frontier_size <= 8
    assert trun.goals_skipped == jrun.goals_skipped
    driven = [g for g in trun.goal_results if g.chunks]
    assert driven and driven[0].chunks[0]["bucket"] == 8  # compacted on the seed
