"""The port's pipelined per-goal driver (``frontier_fixpoint`` with
``next_goal`` and ``prelaunch``) against the JAX package's on the skewed
16-broker model, with the dense floor lowered to 8 in both packages, on the
two cases of tests/test_pipeline.py:212-267:

- conflict discard: the next goal's seed frontier holds brokers 0-3, which
  the replica-count goal moves replicas off, so every opener is discarded
  on the device and no handoff is made;
- clean handoff: the seed holds brokers 8-11, which the goal leaves alone,
  so the opener is adopted and the next goal's driver continues from it
  (``prelaunch``), against the same driver started cold.

In each the chunk records, the info keys, the cross-goal counts and the
placement equal the JAX package's."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu.analyzer.state import PipelineNextGoal as JaxNext
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions, PipelineNextGoal
from tests.torch_port_helpers import PLACEMENT, chunk_keys, clear_cruise_env, skewed_models

KW = dict(num_sources=4, num_dests=1, max_steps=64, chunk_steps=8, min_chunk=1,
          frontier=True)
GOALS = ["ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"]
INFO_KEYS = ("buckets", "steps", "actions", "satisfied_before", "satisfied_after",
             "capped", "repair_steps", "bisect_depth", "lanes_live", "fetches",
             "chunks_speculative", "chunks_wasted", "cross_dispatched", "cross_wasted",
             "adopted_prelaunch", "seed_frontier")


@pytest.fixture
def floor8(monkeypatch):
    clear_cruise_env(monkeypatch)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)


def _same(ti, ji, tmodel, jmodel):
    assert chunk_keys(ti) == chunk_keys(ji)
    for k in INFO_KEYS:
        assert ti.get(k) == ji.get(k), k
    assert (ti.get("handoff") is None) == (ji.get("handoff") is None)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tmodel, f).numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)


def _first_goal(seed_brokers):
    jm, tm = skewed_models(7)
    seed = np.zeros(tm.num_brokers, bool)
    seed[seed_brokers] = True
    jg1, jg2 = jax_goals(GOALS)
    tg1, tg2 = goals_by_priority(GOALS)
    jout = jopt.frontier_fixpoint(
        jm, JaxOptions.none(jm), jg1, (), JaxBC.default(),
        next_goal=JaxNext(spec=jg2, prev_specs=(jg1,), seed_active=seed, chunk_len=8,
                          max_steps=64), **KW)
    before = dict(topt.FETCH_COUNTERS)
    tout = topt.frontier_fixpoint(
        tm, OptimizationOptions.none(tm), tg1, (), BalancingConstraint.default(),
        next_goal=PipelineNextGoal(spec=tg2, prev_specs=(tg1,), seed_active=seed,
                                   chunk_len=8, max_steps=64), **KW)
    counted = {k: topt.FETCH_COUNTERS[k] - before[k] for k in before}
    return jm, tm, jout, tout, counted


def test_conflict_discards_every_opener(floor8):
    jm, tm, (jmodel, ji), (tmodel, ti), counted = _first_goal([0, 1, 2, 3])
    _same(ti, ji, tmodel, jmodel)
    assert ti["actions"] > 0 and ti["cross_dispatched"] >= 1
    assert ti["cross_wasted"] == ti["cross_dispatched"] and ti["handoff"] is None
    assert counted["chunks_cross_goal"] == counted["chunks_cross_wasted"] == \
        ti["cross_dispatched"]
    # Discarded openers change nothing: the driver equals the one without
    # a next goal.
    m0, i0 = topt.frontier_fixpoint(tm, OptimizationOptions.none(tm),
                                    goals_by_priority(GOALS)[0], (),
                                    BalancingConstraint.default(), **KW)
    assert chunk_keys(i0) == chunk_keys(ti)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(m0, f).numpy(), getattr(tmodel, f).numpy())
    # Every opener was discarded, so all their queued steps were gated off.
    assert ti["cross_replays_wasted"] == ti["cross_replays"]


def test_clean_handoff_is_adopted_by_next_driver(floor8):
    jm, tm, (jm1, ji), (tm1, ti), _ = _first_goal([8, 9, 10, 11])
    _same(ti, ji, tm1, jm1)
    assert ti["handoff"] is not None and ti["cross_wasted"] == ti["cross_dispatched"] - 1
    jg1, jg2 = jax_goals(GOALS)
    tg1, tg2 = goals_by_priority(GOALS)
    jmh, jih = jopt.frontier_fixpoint(jm1, JaxOptions.none(jm), jg2, (jg1,), JaxBC.default(),
                                      prelaunch=ji["handoff"], **KW)
    tmh, tih = topt.frontier_fixpoint(tm1, OptimizationOptions.none(tm), tg2, (tg1,),
                                      BalancingConstraint.default(),
                                      prelaunch=ti["handoff"], **KW)
    _same(tih, jih, tmh, jmh)
    assert tih["adopted_prelaunch"] and tih["satisfied_after"]
    assert tih["chunks"][0]["cross"] and tih["chunks"][0]["bucket"] == 8
    assert tih["seed_frontier"] == 4
    # The cold driver on the same model: the JAX package's, and the same
    # placement as the adopting one.
    jmc, jic = jopt.frontier_fixpoint(jm1, JaxOptions.none(jm), jg2, (jg1,),
                                      JaxBC.default(), **KW)
    tmc, tic = topt.frontier_fixpoint(tm1, OptimizationOptions.none(tm), tg2, (tg1,),
                                      BalancingConstraint.default(), **KW)
    _same(tic, jic, tmc, jmc)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tmc, f).numpy(), getattr(tmh, f).numpy())


def test_prelaunch_needs_its_own_goal(floor8):
    _, tm, _, (_, ti), _ = _first_goal([8, 9, 10, 11])
    tg1, tg2 = goals_by_priority(GOALS)
    with pytest.raises(ValueError, match="prelaunch"):
        topt.frontier_fixpoint(tm, OptimizationOptions.none(tm), tg1, (),
                               BalancingConstraint.default(), prelaunch=ti["handoff"], **KW)
