"""Goal semantics of the PyTorch port against the JAX package for the
intra-broker disk goals (``intra_disk_capacity``, ``intra_disk_distribution``)
on a JBOD cluster: 8 brokers, 4 disks a broker, DISK capacities scaled so
that the fullest broker sits at 70 % (tests/torch_port_helpers.jbod_model).

One candidate batch per case (intra-broker moves and swaps from both disk
goals' rankings, inter-broker moves, swaps and leadership transfers) is
built by the JAX package and carried across.  Per goal: ``disk_load``,
``_disk_limits``, ``broker_metric``, ``limits``, ``goal_satisfied``,
``violated_brokers``, ``self_feasible``, ``accepts``, ``score``,
``source_replica_relevance`` and ``dest_room``; both intra builders' index
sets and ``make_swap_candidates(intra=True)``; the K5, K5b, K9 and K10 plain
twins against the JAX package's eligible line, ``accepts``,
``goal_satisfied`` and placement scorer.  Everything is exact, floats bit
for bit: the disk sums add in the JAX package's row order.

Cases: ``healthy``; ``dead`` (the first disk of brokers 2 and 5 dead:
stranded replicas, the offline bonus and dead sources)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import actions as ja_actions
from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu_torch.analyzer import actions as ta_actions
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS, goals_by_priority
from cruise_control_tpu_torch.analyzer.state import BrokerArrays, OptimizationOptions
from tests.torch_port_helpers import (INTRA_GOALS, SPEC_ENTRY, cand_to_torch, jbod_model,
                                      jopt, on_dead_disks, to_jax, to_torch)

SPEC = dict(SPEC_ENTRY, num_topics=5, mean_partitions_per_topic=16.0, seed=3)
CASES = {"healthy": (), "dead": (2, 5)}
FIELDS = ("action_type", "replica", "src", "dest", "dest_replica", "partition",
          "partition2", "valid", "delta_src", "delta_dest", "d_replica_count",
          "d_leader_count", "d_potential_nw_out", "d_leader_bytes_in_src",
          "d_leader_bytes_in_dest", "src_disk", "dest_disk")

_CASES = {}


def _jax_batch(jm, arrays, opts, con):
    names = ("IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal",
             "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
             "LeaderReplicaDistributionGoal")
    cap, dist, rd, dud, lrd = (JAX_SPECS[n] for n in names)
    parts = [jc.intra_disk_candidates(cap, jm, arrays, con, opts, 24),
             jc.intra_disk_candidates(dist, jm, arrays, con, opts, 24),
             jc.intra_swap_candidates(dist, jm, arrays, con, opts, 16, 64),
             jc.intra_swap_candidates(cap, jm, arrays, con, opts, 16, 64),
             jc.combined_move_candidates(rd, jm, arrays, con, opts, 16, 8, num_matched=32),
             jc.swap_candidates(dud, jm, arrays, con, opts, 16, 8),
             jc.leadership_candidates(lrd, jm, arrays, con, opts, 16)]
    out = parts[0]
    for p in parts[1:]:
        out = jc.concat_candidates(out, p)
    return out


def _case(case: str):
    if case not in _CASES:
        jm = jbod_model(SPEC, dead=CASES[case])
        jcon, tcon = JaxBC.default(), BalancingConstraint.default()
        arrays = JaxBrokerArrays.from_model(jm)
        cand = jax.jit(_jax_batch, static_argnums=3)(jm, arrays, JaxOptions.none(jm), jcon)
        tm = to_torch(jm)
        accepted = np.random.default_rng(6).random(cand.k) < 0.8
        _CASES[case] = (jm, arrays, cand, tm, BrokerArrays.for_specs(tm, goals_by_priority(
            INTRA_GOALS)), cand_to_torch(cand), accepted, jcon, tcon)
    return _CASES[case]


def _equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def test_cases_exercise_the_disk_goals():
    """Both goals start violated, the dead case strands replicas, and the
    batch holds eligible intra moves and intra swaps of each goal."""
    for case in CASES:
        jm, _, _, tm, ta, tcand, _, _, tcon = _case(case)
        assert (on_dead_disks(tm) > 0) == (case == "dead")
        for goal in INTRA_GOALS:
            spec = GOAL_SPECS[goal]
            assert not bool(tk.goal_satisfied(spec, tm, ta, tcon)), (case, goal)
            _, eligible = tk.goal_masks_plain(spec, tm, ta, tcand, tcon)
            kinds = set(tcand.action_type[eligible].tolist())
            assert 2 in kinds, (case, goal, kinds)
            assert 4 in kinds, (case, goal, kinds)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("goal", INTRA_GOALS)
def test_goal_functions_match(goal, case):
    jm, ja, jcand, tm, ta, tcand, _, jcon, tcon = _case(case)
    jspec, tspec = JAX_SPECS[goal], GOAL_SPECS[goal]
    _equal(tm.disk_load().numpy(), jm.disk_load(), "disk_load")
    _equal(ta.disk_load.numpy(), jm.disk_load(), "BrokerArrays.disk_load")
    for got, want, what in zip(tk._disk_limits(tspec, tm, tcon, tm.disk_load()),
                               jk._disk_limits(jspec, jm, jcon), ("lower_d", "upper_d")):
        _equal(got.numpy(), want, what)
    # The same bands from the step's shared mean utilization.
    assert ta.disk_mean_util is not None
    for got, want, what in zip(tk._disk_limits(tspec, tm, tcon, ta.disk_load, ta),
                               jk._disk_limits(jspec, jm, jcon),
                               ("lower_d (step means)", "upper_d (step means)")):
        _equal(got.numpy(), want, what)
    _equal(tk.broker_metric(tspec, tm, ta, tcon).numpy(),
           jk.broker_metric(jspec, jm, ja, jcon), "broker_metric")
    for got, want, what in zip(tk.limits(tspec, tm, ta, tcon), jk.limits(jspec, jm, ja, jcon),
                               ("lower", "upper")):
        _equal(got.numpy(), want, what)
    assert bool(tk.goal_satisfied(tspec, tm, ta, tcon)) == \
        bool(jk.goal_satisfied(jspec, jm, ja, jcon))
    _equal(tk.violated_brokers(tspec, tm, ta, tcon).numpy(),
           jk.violated_brokers(jspec, jm, ja, jcon), "violated_brokers")
    _equal(tk.self_feasible(tspec, tm, ta, tcand, tcon).numpy(),
           jk.self_feasible(jspec, jm, ja, jcand, jcon), "self_feasible")
    _equal(tk.accepts(tspec, tm, ta, tcand, tcon).numpy(),
           jk.accepts(jspec, jm, ja, jcand, jcon), "accepts")
    _equal(tk.score(tspec, tm, ta, tcand, tcon).numpy(), jk.score(jspec, jm, ja, jcand, jcon),
           "score")
    _equal(tk.source_replica_relevance(tspec, tm, ta, tcon).numpy(),
           jk.source_replica_relevance(jspec, jm, ja, jcon), "relevance")
    _equal(tk.dest_room(tspec, tm, ta, tcon).numpy(), jk.dest_room(jspec, jm, ja, jcon),
           "dest_room")


BUILDERS = {
    "intra_disk": lambda m, s, *a: m.intra_disk_candidates(s, *a, 24),
    "intra_swap": lambda m, s, *a: m.intra_swap_candidates(s, *a, 16, 64),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("builder", list(BUILDERS))
@pytest.mark.parametrize("goal", INTRA_GOALS)
def test_intra_builders_match(goal, builder, case):
    """Both intra builders give the JAX package's index sets and fields."""
    jm, ja, _, tm, ta, _, _, jcon, tcon = _case(case)
    build = BUILDERS[builder]
    jcand = jax.jit(lambda m, a, o: build(jc, JAX_SPECS[goal], m, a, jcon, o))(
        jm, ja, JaxOptions.none(jm))
    tcand = build(tc, GOAL_SPECS[goal], tm, ta, tcon, OptimizationOptions.none(tm))
    assert bool(tcand.valid.any())
    for f in FIELDS:
        _equal(getattr(tcand, f).numpy(), getattr(jcand, f), f)


@pytest.mark.parametrize("case", list(CASES))
def test_make_swap_candidates_intra_matches(case):
    """Seeded (out, in) pairs, valid or not, as intra-broker swaps."""
    jm, _, _, tm, _, _, _, _, _ = _case(case)
    rng = np.random.default_rng(9)
    r = int(np.asarray(jm.replica_valid).sum())
    out_r = rng.integers(0, r, 64).astype(np.int32)
    in_r = rng.integers(-1, r, 64).astype(np.int32)
    valid = rng.random(64) < 0.7
    jcand = ja_actions.make_swap_candidates(jm, jnp.asarray(out_r), jnp.asarray(in_r),
                                            jnp.asarray(valid), intra=True)
    tcand = ta_actions.make_swap_candidates(tm, torch.from_numpy(out_r),
                                            torch.from_numpy(in_r), torch.from_numpy(valid),
                                            intra=True)
    for f in FIELDS:
        _equal(getattr(tcand, f).numpy(), getattr(jcand, f), f)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("goal", INTRA_GOALS)
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
    score, eligible = tk.goal_masks_plain(GOAL_SPECS[goal], tm, ta, tcand, tcon,
                                          accepted=torch.from_numpy(accepted))
    _equal(eligible.numpy(), jelig, "eligible")
    _equal(score.numpy(), jscore, "score")


@pytest.mark.parametrize("case", list(CASES))
def test_k5b_and_k9_plain_twins_match_the_jax_package(case):
    """K5b's twin with either or both disk goals (and the rack goal) as
    earlier goals is the AND of the JAX package's ``accepts``; K9's twin is
    its ``goal_satisfied`` (and the offline flag)."""
    jm, ja, jcand, tm, ta, tcand, _, jcon, tcon = _case(case)
    for prevs in (INTRA_GOALS[:1], INTRA_GOALS[1:], INTRA_GOALS + ["RackAwareGoal"]):
        want = np.ones(jcand.k, bool)
        for n in prevs:
            want &= np.asarray(jk.accepts(JAX_SPECS[n], jm, ja, jcand, jcon))
        got = tk.structural_accepts(tuple(GOAL_SPECS[n] for n in prevs), tm, ta, tcand, tcon)
        _equal(got.numpy(), want, f"structural_accepts {prevs}")
        assert not want.all()
    goals = INTRA_GOALS + ["DiskCapacityGoal", "DiskUsageDistributionGoal"]
    sat, off = tk.stack_satisfied(tuple(GOAL_SPECS[n] for n in goals), tm, ta, tcon)
    _equal(sat.numpy(), [bool(jk.goal_satisfied(JAX_SPECS[n], jm, ja, jcon)) for n in goals],
           "stack_satisfied")
    assert bool(off[0]) == (case == "dead")


@pytest.mark.parametrize("case", list(CASES))
def test_k10_plain_twins_match_the_jax_scorer(case):
    """The blends of the case's model and the port's solve of it (on the
    CPU, carried to the JAX package): the port's scorer (K10's plain twins,
    the blends' disk loads included) gives the JAX package's flags for the
    two disk goals, and the blends' disk loads are their models'."""
    jm, _, _, tm, _, _, _, jcon, tcon = _case(case)
    after = topt.optimize(tm, INTRA_GOALS, raise_on_hard_failure=False, device="cpu").model
    rng = np.random.default_rng(12)
    masks = rng.random((8, tm.num_partitions)) < 0.5
    masks[0] = False
    masks[-1] = True
    jfn = jopt._get_placement_score_fn(tuple(jax_goals(INTRA_GOALS)), jcon, 8)
    tfn = topt._get_placement_score_fn(tuple(goals_by_priority(INTRA_GOALS)), tcon, 8)
    want = np.asarray(jfn(jm, to_jax(after), masks))
    got = tfn(tm, after, torch.from_numpy(masks)).numpy()
    _equal(got, want, "K10 flags")
    assert not want.all()
    if case == "healthy":
        assert want.any()
    aggs = tk.blend_aggregates(tm, after, torch.from_numpy(masks), False, with_disk_load=True)
    for c in range(8):
        blend = tk.blend_placement(tm, after, torch.from_numpy(masks[c]))
        _equal(aggs[7][c].numpy(), blend.disk_load().numpy(), f"disk loads of blend {c}")
