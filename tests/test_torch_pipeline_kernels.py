"""The plain twins of the pipeline's kernels against the JAX package, on the
CPU (the CUDA kernels are held against these twins on the card by
chip_smoke.py):

- K9 batch (``kernels.frontier_active_batch``) inside the pipeline's sweep
  (``optimizer._get_frontier_sweep_fn``): every goal's satisfied flag, the
  offline flag and every goal's predicted frontier equal the JAX package's
  ``_get_frontier_sweep_fn(...)(model)`` for the full stack on the skewed
  16-broker model, on the mid cluster and on it with a dead broker;
- K11 cross's gate (``optimizer.cross_gate``): the five cases of the JAX
  package's ``_get_cross_gate_fn`` (tests/test_pipeline.py:88-108);
- K11 cross's touched pass and K11's conflict count: one chunk of the
  port's runner with pipeline accounting against the JAX package's
  ``_goal_fixpoint_budget(..., touched=..., next_mask=...)`` (its 6-argument
  program): the packed row, conflict slot included, ``touched_out`` and the
  placement equal; and the touched pass against the JAX package's formula
  on crafted placement changes (broker only, leadership only, disk only,
  invalid replicas, a replica moved away and back, an out-of-range broker);
- K11 with its gate read from an earlier closed row (``gate_src``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.tensor_model import BrokerState as JaxBrokerState
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import (CTR_WIDTH, PACKED_AFTER,
                                                     PACKED_ANY_OFFLINE, PACKED_CAPPED,
                                                     PACKED_CONFLICT, PACKED_WIDTH,
                                                     BrokerArrays, OptimizationOptions,
                                                     StepState)
from tests.torch_port_helpers import PLACEMENT, STACK, skewed_models, to_torch

MID = dict(num_brokers=50, num_racks=10, num_topics=40, mean_partitions_per_topic=84.0,
           replication_factor=3, distribution="exponential", seed=2026)


@pytest.fixture(scope="module")
def clusters():
    jm = jax_generate(JaxSpec(**MID))
    dead = jm.set_broker_state(3, JaxBrokerState.DEAD)
    skew_j, skew_t = skewed_models(7)
    return [("skewed-16", skew_j, skew_t), ("mid", jm, to_torch(jm)),
            ("mid-dead", dead, to_torch(dead))]


def test_frontier_sweep_matches_jax(clusters):
    jfn = jopt._get_frontier_sweep_fn(tuple(JAX_SPECS[g] for g in STACK), JaxBC.default())
    specs = tuple(GOAL_SPECS[g] for g in STACK)
    tfn = topt._get_frontier_sweep_fn(specs, BalancingConstraint.default())
    band = np.array([tk.is_band_kind(s) for s in specs])
    sizes, offline = set(), set()
    for label, jm, tm in clusters:
        jsat, joff, jfronts = (np.asarray(x) for x in jfn(jm))
        sat, off, fronts = tfn(tm)
        np.testing.assert_array_equal(sat, jsat, err_msg=label)
        assert off == bool(joff), label
        assert fronts.shape == (len(STACK), tm.num_brokers)
        np.testing.assert_array_equal(fronts, jfronts, err_msg=label)
        assert not fronts[~band].any()
        # The kernel's own populations agree with its rows.
        arrays = BrokerArrays.from_model(tm)
        rows, counts = tk.frontier_active_batch(*tk.frontier_inputs_batch(
            specs, tm, arrays, BalancingConstraint.default()))
        np.testing.assert_array_equal(rows.numpy(), fronts)
        np.testing.assert_array_equal(counts.numpy(), fronts.sum(1))
        sizes |= set(fronts[band].sum(1) / tm.num_brokers)
        offline.add(off)
    # Small, partial and full frontiers; with and without offline replicas.
    assert min(sizes) < 0.5 and max(sizes) == 1.0
    assert offline == {False, True}


def _packed(aft, cap, off, conf):
    p = np.zeros(PACKED_WIDTH, np.int32)
    p[PACKED_AFTER], p[PACKED_CAPPED], p[PACKED_ANY_OFFLINE], p[PACKED_CONFLICT] = \
        aft, cap, off, conf
    return p


@pytest.mark.parametrize("case,want", [((1, 0, 0, 0), 7), ((0, 0, 0, 0), 0),
                                       ((1, 1, 0, 0), 0), ((1, 0, 1, 0), 0),
                                       ((1, 0, 0, 3), 0)],
                         ids=["done", "unsatisfied", "capped", "offline", "conflict"])
@pytest.mark.parametrize("entry", [(False, False), (True, False), (True, True)],
                         ids=["violated", "satisfied", "offline"])
def test_cross_gate_matches_jax(case, want, entry):
    packed = _packed(*case)
    assert int(jopt._get_cross_gate_fn()(jnp.asarray(packed), jnp.int32(7))) == want
    counters = torch.tensor([5, 9, 3, 2, 5, 77, 64], dtype=torch.int32)
    assert counters.shape == (CTR_WIDTH,)
    entry_before = torch.tensor([0], dtype=torch.int32)
    sat, off = entry
    topt.cross_gate(counters, entry_before, torch.tensor([sat]), torch.tensor([off]),
                    torch.from_numpy(packed), 7)
    # The opener's entry: the next goal's skip shortcut on its own flags.
    assert counters.tolist() == [0, 0, 0 if (sat and not off) else 1, 0, 0, 0, want]
    assert entry_before.tolist() == [int(sat)]


def test_chunk_gate_reads_an_earlier_closed_row():
    """A follow-up whose predecessor was closed before an opener was
    queued takes its gate from the predecessor's row, not from the
    counters (which hold the opener's by then)."""
    for capped in (0, 1):
        counters = torch.tensor([0, 0, 1, 0, 0, 0, 0], dtype=torch.int32)  # opener, gated off
        entry_before = torch.tensor([0], dtype=torch.int32)
        src = torch.from_numpy(_packed(0, capped, 0, 0))
        topt.chunk_gate(counters, entry_before, torch.tensor([False]), torch.tensor([False]),
                        None, None, True, True, 16, gate_src=src)
        assert counters.tolist() == [0, 0, 1, 0, 0, 0, 16 * capped]
    with pytest.raises(ValueError):
        topt.chunk_gate(counters, entry_before, torch.tensor([False]), torch.tensor([False]),
                        None, None, True, True, 16)


def test_chunk_touched_matches_jax_formula():
    """The touched pass on crafted changes against the JAX package's
    expression (``optimizer.py:1679-1687``)."""
    rng = np.random.default_rng(3)
    R, B = 64, 10
    rb0 = rng.integers(0, B, R).astype(np.int32)
    rl0 = rng.random(R) < 0.4
    rd0 = rb0.copy()
    valid = np.ones(R, bool)
    valid[-6:] = False
    rb, rl, rd = rb0.copy(), rl0.copy(), rd0.copy()
    rb[0] = (rb0[0] + 1) % B                   # broker only (disk kept)
    rl[1] = ~rl0[1]                             # leadership only
    rd[2] = rd0[2] + 100                        # disk only
    rb[-1] = (rb0[-1] + 3) % B                  # invalid: marks nothing
    rb[3] = rb0[3]                              # moved away and back: nothing
    rb0[4], rb[4] = -1, B + 2                   # out of range: clipped
    touched0 = np.zeros(B, bool)
    touched0[9] = True                          # OR-ed into
    moved = valid & ((rb != rb0) | (rl != rl0) | (rd != rd0))
    m_i = jnp.asarray(moved.astype(np.int32))
    hits = (jnp.zeros((B,), jnp.int32).at[jnp.clip(jnp.asarray(rb0), 0, B - 1)].add(m_i)
            .at[jnp.clip(jnp.asarray(rb), 0, B - 1)].add(m_i))
    want = touched0 | np.asarray(hits > 0)
    touched = torch.from_numpy(touched0.copy())
    topt.chunk_touched(*(torch.from_numpy(a) for a in (rb0, rl0, rd0, rb, rl, rd, valid)),
                       touched)
    np.testing.assert_array_equal(touched.numpy(), want)
    assert want[[rb0[0], rb[0], rb[1], rb[2], 0, B - 1, 9]].all()
    assert want.sum() < B


@pytest.mark.parametrize("goal,mask_brokers", [
    ("ReplicaDistributionGoal", [0, 1, 2, 3]),
    ("ReplicaDistributionGoal", [8, 9]),
    ("LeaderReplicaDistributionGoal", list(range(16))),
], ids=["replica-shedder", "replica-far", "leader-all"])
def test_chunk_accounting_matches_jax(goal, mask_brokers):
    """One chunk with pipeline accounting: the port's runner against the
    JAX package's ``_goal_fixpoint_budget`` with ``touched`` and
    ``next_mask`` — packed row (conflict slot included), ``touched_out``
    and placement equal."""
    jm, tm = skewed_models(7)
    B = tm.num_brokers
    ns, nd, budget = 4, 1, 6
    touched0 = np.zeros(B, bool)
    touched0[15] = True
    mask = np.zeros(B, bool)
    mask[mask_brokers] = True
    fn = jopt._get_budget_fixpoint_fn(JAX_SPECS[goal], (), JaxBC.default(), ns, nd)
    jmodel, jpacked, _, jtouched = fn(jm, JaxOptions.none(jm), jnp.int32(budget), None,
                                      jnp.asarray(touched0), jnp.asarray(mask))
    st = StepState.working(tm, OptimizationOptions.none(tm))
    lane = topt._Lane(st)
    lane.touched = torch.from_numpy(touched0.copy())
    runner = topt._ChunkRunner(st, GOAL_SPECS[goal], (), BalancingConstraint.default(),
                               None, lane)
    chunk = runner.dispatch(None, None, ns, nd, budget, False, mask=torch.from_numpy(mask))
    packed = runner.close(chunk)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(lane.touched.numpy(), np.asarray(jtouched))
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(st.model, f).numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)
    assert int(packed[1]) > 0  # the chunk moved something
    if goal == "ReplicaDistributionGoal":
        assert (int(packed[PACKED_CONFLICT]) > 0) == (mask_brokers[0] == 0)
