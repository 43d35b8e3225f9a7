"""Candidate builders of the PyTorch port against the JAX package: given the
same model, every builder of the slice yields identical index sets (the
port's stable top-k and argsort keep the JAX package's tie order), and the
delta fields agree within rtol 1e-5 of the largest |value|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import BrokerArrays, OptimizationOptions
from tests.torch_port_helpers import SPEC_12, assert_float_close, to_torch

EXACT = ("action_type", "replica", "src", "dest", "dest_replica", "partition",
         "partition2", "valid", "d_replica_count", "d_leader_count", "src_disk",
         "dest_disk")
FLOAT = ("delta_src", "delta_dest", "d_potential_nw_out", "d_leader_bytes_in_src",
         "d_leader_bytes_in_dest")

_STATE = {}


def _state():
    if not _STATE:
        jm = jax_generate(JaxSpec(**SPEC_12))
        tm = to_torch(jm)
        _STATE.update(jm=jm, ja=JaxBrokerArrays.from_model(jm), jo=JaxOptions.none(jm),
                      tm=tm, ta=BrokerArrays.from_model(tm, True),
                      to=OptimizationOptions.none(tm))
    return _STATE


def _assert_same(tcand, jcand):
    for f in EXACT:
        np.testing.assert_array_equal(getattr(tcand, f).numpy(), np.asarray(getattr(jcand, f)),
                                      err_msg=f)
    for f in FLOAT:
        assert_float_close(getattr(tcand, f).numpy(), np.asarray(getattr(jcand, f)), f)


BUILDERS = [
    ("move", "RackAwareGoal", lambda m, s, *a: m.move_candidates(s, *a, 32, 8)),
    ("move", "DiskUsageDistributionGoal", lambda m, s, *a: m.move_candidates(s, *a, 32, 8)),
    ("matched", "ReplicaDistributionGoal",
     lambda m, s, *a: m.matched_move_candidates(s, *a, 128)),
    ("matched_topic", "TopicReplicaDistributionGoal",
     lambda m, s, *a: m.matched_topic_candidates(s, *a, 128)),
    ("combined", "ReplicaDistributionGoal",
     lambda m, s, *a: m.combined_move_candidates(s, *a, 24, 8, num_matched=96)),
    ("combined", "TopicReplicaDistributionGoal",
     lambda m, s, *a: m.combined_move_candidates(s, *a, 24, 8, num_matched=96)),
    ("leadership", "LeaderReplicaDistributionGoal",
     lambda m, s, *a: m.leadership_candidates(s, *a, 32)),
    ("leadership", "LeaderBytesInDistributionGoal",
     lambda m, s, *a: m.leadership_candidates(s, *a, 32)),
    ("swap", "DiskUsageDistributionGoal", lambda m, s, *a: m.swap_candidates(s, *a, 16, 8)),
    ("swap", "NetworkOutboundUsageDistributionGoal",
     lambda m, s, *a: m.swap_candidates(s, *a, 16, 8)),
]


@pytest.mark.parametrize("kind,goal,build", BUILDERS, ids=[f"{k}-{g}" for k, g, _ in BUILDERS])
def test_builder_index_sets_match(kind, goal, build):
    st = _state()
    jcand = jax.jit(lambda m, a, o: build(jc, JAX_SPECS[goal], m, a, JaxBC.default(), o))(
        st["jm"], st["ja"], st["jo"])
    tcand = build(tc, GOAL_SPECS[goal], st["tm"], st["ta"], BalancingConstraint.default(),
                  st["to"])
    _assert_same(tcand, jcand)
    assert bool(tcand.valid.any())


def test_concat_and_take_match():
    st = _state()
    args_t = (st["tm"], st["ta"], BalancingConstraint.default(), st["to"])
    lead = "LeaderReplicaDistributionGoal"
    jcand = jax.jit(lambda m, a, o: jc.concat_candidates(
        jc.move_candidates(JAX_SPECS[lead], m, a, JaxBC.default(), o, 16, 4),
        jc.leadership_candidates(JAX_SPECS[lead], m, a, JaxBC.default(), o, 16)))(
        st["jm"], st["ja"], st["jo"])
    tcand = tc.concat_candidates(tc.move_candidates(GOAL_SPECS[lead], *args_t, 16, 4),
                                 tc.leadership_candidates(GOAL_SPECS[lead], *args_t, 16))
    _assert_same(tcand, jcand)
    idx = np.random.default_rng(0).permutation(jcand.k)[:40].astype(np.int32)
    _assert_same(tc.take_candidates(tcand, torch.from_numpy(idx)),
                 jc.take_candidates(jcand, jnp.asarray(idx)))


def test_default_widths_match():
    st = _state()
    for fn in ("default_num_sources", "default_num_dests", "default_num_swap_sources",
               "default_num_swap_partners"):
        assert getattr(tc, fn)(st["tm"]) == getattr(jc, fn)(st["jm"]), fn
    assert tc.default_num_matched(st["tm"], 48) == jc.default_num_matched(st["jm"], 48)


def test_intra_broker_builders_wait_for_a_later_slice():
    """Both intra-broker builders give the JAX package's index sets and
    fields on this cluster's one disk a broker (every pair is invalid: a
    broker has no other disk) and on a JBOD cluster with 4 disks a broker
    (tests/test_torch_intra_disk.py holds them per goal and case)."""
    from tests.torch_port_helpers import SPEC_ENTRY, jbod_model
    st = _state()
    jbod = jbod_model(dict(SPEC_ENTRY, num_topics=5, mean_partitions_per_topic=16.0, seed=3))
    tj = to_torch(jbod)
    states = ((st["jm"], st["ja"], st["jo"], st["tm"], st["ta"], st["to"]),
              (jbod, JaxBrokerArrays.from_model(jbod), JaxOptions.none(jbod), tj,
               BrokerArrays.from_model(tj), OptimizationOptions.none(tj)))
    for i, (jm, ja, jo, tm, ta, to) in enumerate(states):
        for name in ("IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"):
            jspec, tspec = JAX_SPECS[name], GOAL_SPECS[name]
            jcand = jax.jit(lambda m, a, o: jc.concat_candidates(
                jc.intra_disk_candidates(jspec, m, a, JaxBC.default(), o, 24),
                jc.intra_swap_candidates(jspec, m, a, JaxBC.default(), o, 16, 64)))(jm, ja, jo)
            tcand = tc.concat_candidates(
                tc.intra_disk_candidates(tspec, tm, ta, BalancingConstraint.default(), to, 24),
                tc.intra_swap_candidates(tspec, tm, ta, BalancingConstraint.default(), to,
                                         16, 64))
            _assert_same(tcand, jcand)
            assert bool(tcand.valid.any()) == (i == 1)
