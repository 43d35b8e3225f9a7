"""The plain twins of this slice's kernels against the JAX package, on the
CPU (the CUDA kernels are held against these twins on the card by
chip_smoke.py):

- K9, sweep (``kernels.stack_satisfied``): every goal's satisfied flag and
  the offline flag equal the JAX package's ``_stack_satisfied`` on the mid
  cluster (bench.py's mid rung), on a variant with a dead broker, and on a
  solved 12-broker cluster;
- K9, frontier mask (``kernels.frontier_active``): equal to the JAX
  package's ``frontier_active`` for every band goal on the same clusters
  and on the skewed 16-broker model of tests/test_frontier.py:51;
- K5b (``kernels.structural_accepts``): equal to the JAX package's
  ``accepts`` of RackAwareGoal, TopicReplicaDistributionGoal and both, on
  a batch of moves, swaps and leadership transfers of the mid cluster,
  healthy and with a dead broker;
- K11 (``optimizer.chunk_gate``): a table of (capped, converged, skip,
  offline) cases gives the packed row and next counters the JAX package's
  chunk program and budget gate give.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.tensor_model import BrokerState as JaxBrokerState
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import (CTR_WIDTH, PACKED_CAPPED,
                                                     PACKED_WIDTH, BrokerArrays)
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import (SPEC_12, STACK, cand_to_torch, skewed_models,
                                      to_jax, to_torch)

MID = dict(num_brokers=50, num_racks=10, num_topics=40, mean_partitions_per_topic=84.0,
           replication_factor=3, distribution="exponential", seed=2026)
BAND = [g for g in STACK if tk.is_band_kind(GOAL_SPECS[g])]


@pytest.fixture(scope="module")
def clusters():
    """(label, JAX model, port model): mid, mid with broker 3 dead, the
    12-broker cluster after the port's solve, the skewed 16-broker model."""
    jm = jax_generate(JaxSpec(**MID))
    dead = jm.set_broker_state(3, JaxBrokerState.DEAD)
    solved = topt.optimize(generate_cluster(ClusterSpec(**SPEC_12), device="cpu"), STACK,
                           raise_on_hard_failure=False, device="cpu").model
    skew_j, skew_t = skewed_models(7)
    return [("mid", jm, to_torch(jm)), ("mid-dead", dead, to_torch(dead)),
            ("12-solved", to_jax(solved), solved), ("skewed-16", skew_j, skew_t)]


def test_stack_sweep_matches_stack_satisfied(clusters):
    specs = tuple(GOAL_SPECS[g] for g in STACK)
    jspecs = tuple(JAX_SPECS[g] for g in STACK)
    seen = set()
    for label, jm, tm in clusters[:3]:
        jsat, joff = jopt._stack_satisfied(jm, specs=jspecs, constraint=JaxBC.default())
        arrays = BrokerArrays.from_model(tm, with_topic_counts=True)
        sat, off = tk.stack_satisfied(specs, tm, arrays, BalancingConstraint.default())
        np.testing.assert_array_equal(sat.numpy(), np.asarray(jsat), err_msg=label)
        assert off.shape == (1,) and bool(off[0]) == bool(joff), label
        seen |= {(bool(s), bool(off[0])) for s in sat}
    # Satisfied and violated goals, with and without offline replicas.
    assert {(True, False), (False, False), (False, True)} <= seen


def test_frontier_mask_matches_frontier_active(clusters):
    con, jcon = BalancingConstraint.default(), JaxBC.default()
    sizes = []
    for label, jm, tm in clusters:
        jarrays = JaxArrays.from_model(jm)
        arrays = BrokerArrays.from_model(tm)
        for g in BAND:
            want = np.asarray(jk.frontier_active(JAX_SPECS[g], jm, jarrays, jcon))
            inputs = tk.frontier_inputs(GOAL_SPECS[g], tm, arrays, con)
            got, count = tk.frontier_mask(*inputs)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{label} {g}")
            assert int(count[0]) == int(want.sum())
            sizes.append(int(want.sum()) / tm.num_brokers)
    assert min(sizes) < 0.5 and max(sizes) == 1.0  # small and full frontiers


def _jax_batch(jm):
    """Moves (cross legs), swaps and leadership transfers of the mid
    cluster, built by the JAX package's candidate builders."""
    spec = JAX_SPECS["DiskUsageDistributionGoal"]
    lead = JAX_SPECS["LeaderReplicaDistributionGoal"]
    con, options = JaxBC.default(), JaxOptions.none(jm)
    arrays = JaxArrays.from_model(jm)
    moves = jc.combined_move_candidates(spec, jm, arrays, con, options, 256, 32)
    swaps = jc.swap_candidates(spec, jm, arrays, con, options, 256, 16)
    leads = jc.leadership_candidates(lead, jm, arrays, con, options, 128)
    return jc.concat_candidates(jc.concat_candidates(moves, swaps), leads)


@pytest.mark.parametrize("prev", [("RackAwareGoal",), ("TopicReplicaDistributionGoal",),
                                  ("RackAwareGoal", "TopicReplicaDistributionGoal")],
                         ids=["rack", "topic", "both"])
def test_structural_accepts_matches_accepts(clusters, prev):
    jcon, con = JaxBC.default(), BalancingConstraint.default()
    for label, jm, tm in clusters[:2]:
        jcand = _jax_batch(jm)
        jarrays = JaxArrays.from_model(jm)
        want = jnp.ones(jcand.k, bool)
        for g in prev:
            want = want & jk.accepts(JAX_SPECS[g], jm, jarrays, jcand, jcon)
        want = np.asarray(want)
        cand = cand_to_torch(jcand)
        got = tk.structural_accepts(tuple(GOAL_SPECS[g] for g in prev), tm,
                                    BrokerArrays.from_model(tm, with_topic_counts=True),
                                    cand, con).numpy()
        np.testing.assert_array_equal(got, want, err_msg=label)
        kinds = cand.action_type.numpy()
        assert set(kinds) >= {0, 1, 3}
        # Vetoes fire on moves and swaps; leadership transfers pass.
        assert not want[kinds != 1].all() and want[kinds == 1].all()


# (steps, budget, last_n, satisfied at exit, offline at exit, gate)
GATE_CASES = [
    (4, 4, 3, False, False, True),    # capped: the follow-up gets its budget
    (2, 4, 0, False, False, True),    # converged: the follow-up gets 0 steps
    (4, 4, 0, True, False, True),     # converged on the last step, satisfied
    (4, 4, 2, True, False, True),     # capped but satisfied: skipped follow-up
    (4, 4, 2, True, True, True),      # satisfied with offline replicas left
    (0, 8, 0, True, False, False),    # skipped at entry; host-decided next chunk
    (3, 8, 5, False, True, False),    # still stepping when closed; host budget
]


@pytest.mark.parametrize("case", GATE_CASES)
def test_chunk_gate_table(case):
    steps, budget, last_n, sat, off, gate = case
    nxt = 16
    counters = torch.tensor([steps, 9, last_n, 2, 5, 77, budget], dtype=torch.int32)
    assert counters.shape == (CTR_WIDTH,)
    entry_before = torch.tensor([1], dtype=torch.int32)
    packed = torch.full((PACKED_WIDTH,), -7, dtype=torch.int32)
    count = torch.tensor([12], dtype=torch.int32)
    topt.chunk_gate(counters, entry_before, torch.tensor([sat]), torch.tensor([off]),
                    count, packed, True, gate, nxt)
    capped = int(steps >= budget and last_n > 0)
    assert packed.tolist() == [steps, 9, 1, int(sat), capped, 2, 5, 77, 12, int(off), 0]
    want_budget = int(np.asarray(jopt._get_gate_fn()(jnp.asarray(packed.numpy()),
                                                     jnp.int32(nxt)))) if gate else nxt
    assert want_budget == (capped * nxt if gate else nxt)
    assert counters.tolist() == [0, 0, 0 if (sat and not off) else 1, 0, 0, 0, want_budget]
    assert entry_before.tolist() == [int(sat)]
    # Close only: the counters stay; a non-band chunk reports -1 active.
    again = counters.clone()
    topt.chunk_gate(counters, entry_before, torch.tensor([sat]), torch.tensor([off]),
                    None, packed, False, False, 0)
    assert torch.equal(counters, again) and packed[8] == -1
    assert packed[PACKED_CAPPED] == int(again[0] >= again[6] and again[2] > 0)
