"""The executor's balancedness scorer in the PyTorch port against the JAX
package's, on the CPU (the plain twins of K10).

Each size shares one JAX solve of two goals (a module fixture): its before
and after models go to both packages as numpy, and landed-partition masks
made from a seed with numpy are scored by both over the full 15-goal stack.
The flags are exact and the scores equal, bit for bit.  ``with_placement``
and ``donation_copy`` leave the caller's tensors unwritten.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as gk
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import (DEFAULT_GOAL_ORDER, DESIGNATED, KAFKA_ASSIGNER_GOALS,
                                      SPEC_6, SPEC_12, SPEC_ENTRY, STACK, JaxSpec,
                                      break_preference, jax_generate, jopt, to_torch)

SOLVE_GOALS = ["ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"]
SIZES = {"6": SPEC_6, "8": SPEC_ENTRY, "12": SPEC_12}


@pytest.fixture(scope="module")
def solved():
    """``size -> (JAX before, JAX after, port before, port after)``, each
    size solved once per module by the JAX package."""
    solves = {}

    def get(size):
        if size not in solves:
            jm = jax_generate(JaxSpec(**SIZES[size]))
            jrun = jopt.optimize(jm, SOLVE_GOALS, raise_on_hard_failure=False)
            solves[size] = (jm, jrun.model, to_torch(jm), to_torch(jrun.model))
        return solves[size]
    return get


def _masks(num_partitions, c, seed):
    """bool[c, P] landed masks from a seed: the first row lands nothing, the
    last (when c > 1) everything, the rest a random half."""
    rng = np.random.default_rng(seed)
    m = rng.random((c, num_partitions)) < 0.5
    m[0] = False
    if c > 1:
        m[-1] = True
    return m


@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("size", list(SIZES))
def test_score_matches_jax(solved, size, c):
    """Port against JAX, same masks: per checkpoint and goal the same flag,
    and the same score."""
    jm, ja, tm, ta = solved(size)
    masks = _masks(tm.num_partitions, c, seed=int(size) * 10 + c)
    jscorer = jopt.PlacementScorer(jm, ja, STACK)
    tscorer = topt.PlacementScorer(tm, ta, STACK)
    want, got = jscorer.score(masks), tscorer.score(masks)
    np.testing.assert_array_equal(got, want)
    assert tscorer.dispatches == jscorer.dispatches == 1
    c_pad = 1 << (c - 1).bit_length()
    padded = np.zeros((c_pad, tm.num_partitions), bool)
    padded[:c] = masks
    jfn = jopt._get_placement_score_fn(tuple(jax_goals(STACK)), JaxBC.default(), c_pad)
    tfn = topt._get_placement_score_fn(tuple(goals_by_priority(STACK)),
                                       BalancingConstraint.default(), c_pad)
    np.testing.assert_array_equal(tfn(tm, ta, torch.from_numpy(padded)).numpy(),
                                  np.asarray(jfn(jm, ja, padded)))


def test_score_with_every_goal_kind_matches_jax(solved):
    """Every inter-broker goal kind in the stack (the default order, the
    preferred-leader, rack-distribution and kafka-assigner goals), topics
    designated for min leaders, a demoted broker and broken preferences in
    the before placement: the port's scores equal the JAX package's, flag
    for flag, and the blends' topic leader counts are their models'."""
    from cruise_control_tpu.model.tensor_model import BrokerState
    jm, ja, _, _ = solved("8")
    jb = break_preference(jm, every=2).set_broker_state(3, BrokerState.DEMOTED)
    tb, ta = to_torch(jb), to_torch(ja)
    goals = DEFAULT_GOAL_ORDER + ["PreferredLeaderElectionGoal",
                                  "RackAwareDistributionGoal"] + KAFKA_ASSIGNER_GOALS
    jcon = dataclasses.replace(JaxBC.default(), min_leader_topic_ids=DESIGNATED)
    tcon = dataclasses.replace(BalancingConstraint.default(), min_leader_topic_ids=DESIGNATED)
    masks = _masks(tb.num_partitions, 8, seed=17)
    jscorer = jopt.PlacementScorer(jb, ja, goals, jcon)
    tscorer = topt.PlacementScorer(tb, ta, goals, tcon)
    np.testing.assert_array_equal(tscorer.score(masks), jscorer.score(masks))
    flags = topt._get_placement_score_fn(tuple(goals_by_priority(goals)), tcon, 8)(
        tb, ta, torch.from_numpy(masks))
    assert not bool(flags.all()) and bool(flags.any())
    aggs = gk.blend_aggregates(tb, ta, torch.from_numpy(masks), False,
                               with_topic_leaders=True)
    assert aggs[5] is None
    for c in (0, 7):
        model = tb if c == 0 else gk.blend_placement(tb, ta, torch.from_numpy(masks[c]))
        assert torch.equal(aggs[6][c], model.topic_leader_counts())


def test_score_landed_sets_and_for_run(solved):
    """``score_landed`` on the ledger's landed sets equals the JAX
    package's, and ``for_run`` takes the run's placement and stack."""
    jm, ja, tm, ta = solved("8")
    rng = np.random.default_rng(5)
    sets = [frozenset(), frozenset(rng.choice(tm.num_partitions, 7, replace=False).tolist()),
            frozenset(range(tm.num_partitions))]
    want = jopt.PlacementScorer(jm, ja, STACK).score_landed(sets)
    np.testing.assert_array_equal(topt.PlacementScorer(tm, ta, STACK).score_landed(sets), want)
    run = topt.optimize(tm, SOLVE_GOALS, raise_on_hard_failure=False, device="cpu")
    scorer = topt.PlacementScorer.for_run(tm, run)
    first, last = scorer.score_landed([frozenset(), frozenset(range(tm.num_partitions))])
    assert first == pytest.approx(run.balancedness_before, abs=1e-6)
    assert last == pytest.approx(run.balancedness_after, abs=1e-6)
    assert scorer.num_partitions == tm.num_partitions


def test_sliced_batch_equals_one_launch(solved, monkeypatch):
    """A batch split into slices (as large topic counts are) gives the same
    flags as one pass."""
    _, _, tm, ta = solved("12")
    masks = torch.from_numpy(_masks(tm.num_partitions, 8, seed=3))
    specs, con = tuple(goals_by_priority(STACK)), BalancingConstraint.default()
    whole = topt._get_placement_score_fn(specs, con, 8)(tm, ta, masks)
    monkeypatch.setattr(topt, "_SCORE_SLICE_BYTES", 1)
    monkeypatch.setattr(topt, "_SCORE_SLICE", 2)
    monkeypatch.setattr(topt, "_placement_score_cache", {})
    sliced = topt._get_placement_score_fn(specs, con, 8)(tm, ta, masks)
    assert torch.equal(sliced, whole)


def test_blend_aggregates_are_the_blends_broker_arrays(solved):
    """The plain twin's aggregates of each blend are BrokerArrays.from_model
    of that blend; an all-false mask gives the before model's, an all-true
    one the after model's."""
    _, _, tm, ta = solved("6")
    masks = torch.from_numpy(_masks(tm.num_partitions, 3, seed=1))
    aggs = gk.blend_aggregates(tm, ta, masks, True)
    for c, model in ((0, tm), (2, ta)):
        ref = BrokerArrays.from_model(model, with_topic_counts=True)
        for got, want in zip(aggs, (ref.load, ref.replica_count, ref.leader_count,
                                    ref.potential_nw_out, ref.leader_bytes_in,
                                    ref.topic_counts)):
            assert torch.equal(got[c], want)
    blend = gk.blend_placement(tm, ta, masks[1])
    rmask = masks[1][tm.replica_partition.long()]
    assert torch.equal(blend.replica_broker,
                       torch.where(rmask, ta.replica_broker, tm.replica_broker))
    assert gk.blend_aggregates(tm, ta, masks, False)[5] is None


def test_wrappers_check_their_inputs(solved):
    _, _, tm, ta = solved("6")
    with pytest.raises(ValueError):
        gk.blend_aggregates(tm, ta, torch.zeros((2, tm.num_partitions + 1), dtype=torch.bool),
                            True)
    with pytest.raises(TypeError):
        gk.blend_aggregates(tm, ta, torch.zeros((2, tm.num_partitions), dtype=torch.uint8),
                            True)
    masks = torch.zeros((2, tm.num_partitions), dtype=torch.bool)
    aggs = gk.blend_aggregates(tm, ta, masks, False)
    with pytest.raises(ValueError, match="topic"):
        gk.stack_sweep_batch(tuple(goals_by_priority(STACK)), tm, ta, masks, aggs,
                             BalancingConstraint.default())
    with pytest.raises(ValueError, match="lie on"):
        topt.PlacementScorer(tm, ta.to("meta"), STACK)


def _snapshot(model):
    return {f.name: getattr(model, f.name).clone() for f in dataclasses.fields(model)
            if isinstance(getattr(model, f.name), torch.Tensor)}


def _unchanged(model, snap):
    return all(torch.equal(getattr(model, f), t) for f, t in snap.items())


def test_with_placement_and_donation_copy_leave_the_callers_tensors():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    snap = _snapshot(tm)
    rb = torch.flip(tm.replica_broker, (0,))
    lead = ~tm.replica_is_leader
    swapped = tm.with_placement(rb, lead)
    assert swapped.replica_broker is rb and swapped.replica_is_leader is lead
    assert swapped.replica_disk is tm.replica_disk
    disk = tm.replica_disk + 1
    assert tm.with_placement(rb, lead, disk).replica_disk is disk
    assert _unchanged(tm, snap)

    copy = topt.donation_copy(tm)
    for f, t in snap.items():
        got = getattr(copy, f)
        assert torch.equal(got, t) and got.data_ptr() != getattr(tm, f).data_ptr(), f
    copy.replica_broker.zero_()
    copy.replica_load_leader.mul_(2.0)
    assert _unchanged(tm, snap)
    run = topt.optimize(topt.donation_copy(tm), SOLVE_GOALS, fused=True, donate_model=True,
                        raise_on_hard_failure=False, device="cpu")
    assert _unchanged(tm, snap)
    assert run.model.num_brokers == tm.num_brokers
