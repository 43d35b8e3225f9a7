"""The port's chunked per-goal driver (``frontier_fixpoint``) against the
JAX package's on the skewed 16-broker model of tests/test_frontier.py:51,
with the dense floor ``_FRONTIER_DENSE_MIN`` lowered to 8 in both packages
so that compaction engages: the keyword sets of tests/test_frontier.py:147
and :219 (``frontier`` True and False, ``speculate`` True and False, narrow
widths, a one-step first chunk).  Equal chunk records (steps, actions,
bucket, widths, speculative), buckets, steps, actions, satisfied flags and
speculation counts, and the same final placement.  Several cases compact
and speculate; one speculative compacted chunk caps, so its follow-up is
fetched on the predecessor's frontier."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
from tests.torch_port_helpers import PLACEMENT, chunk_keys, clear_cruise_env, skewed_models

NARROW = dict(num_sources=4, num_dests=1, max_steps=64, chunk_steps=8, min_chunk=1)
# One source a step and two-step chunks: compacted chunks cap, so their
# speculative follow-ups are fetched.
ONE = dict(num_sources=1, num_dests=1, max_steps=64, chunk_steps=2, min_chunk=1)
CASES = {
    "frontier": (7, "ReplicaDistributionGoal", dict(NARROW, frontier=True)),
    "frontier-nospec": (3, "ReplicaDistributionGoal",
                        dict(NARROW, frontier=True, speculate=False)),
    "dense-spec": (3, "ReplicaDistributionGoal",
                   dict(NARROW, frontier=False, speculate=True)),
    "dense-nospec": (3, "ReplicaDistributionGoal",
                     dict(NARROW, frontier=False, speculate=False)),
    "frontier-seed9": (9, "ReplicaDistributionGoal", dict(NARROW, frontier=True)),
    "frontier-capped": (3, "LeaderReplicaDistributionGoal", dict(ONE, frontier=True)),
    "disk-frontier": (3, "DiskUsageDistributionGoal", dict(ONE, frontier=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_frontier_fixpoint_matches(case, monkeypatch):
    clear_cruise_env(monkeypatch)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
    seed, goal, kw = CASES[case]
    jm, tm = skewed_models(seed)
    jmodel, ji = jopt.frontier_fixpoint(jm, JaxOptions.none(jm), jax_goals([goal])[0], (),
                                        JaxBC.default(), **kw)
    before = dict(topt.FETCH_COUNTERS)
    tmodel, ti = topt.frontier_fixpoint(tm, OptimizationOptions.none(tm),
                                        goals_by_priority([goal])[0], (),
                                        BalancingConstraint.default(), **kw)
    assert chunk_keys(ti) == chunk_keys(ji)
    for k in ("buckets", "steps", "actions", "satisfied_before", "satisfied_after",
              "capped", "repair_steps", "bisect_depth", "lanes_live", "fetches",
              "chunks_speculative", "chunks_wasted"):
        assert ti[k] == ji[k], k
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tmodel, f).numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)
    assert topt.FETCH_COUNTERS["device_fetches"] - before["device_fetches"] == ti["fetches"]
    assert (topt.FETCH_COUNTERS["chunks_speculative"] - before["chunks_speculative"]
            == ti["chunks_speculative"])
    # Every fetched chunk ran at least its steps; a discarded follow-up ran
    # none (its budget gate or skip test closed it).
    assert ti["replays"] >= ti["steps"]
    if kw["frontier"] and case != "frontier-seed9":
        assert ti["buckets"] == [8]
    if case in ("frontier-capped", "disk-frontier"):
        assert any(c["speculative"] and c["bucket"] == 8 for c in ti["chunks"])


def test_a_case_compacts_and_speculates():
    """The cases above include compacted chunks, speculative follow-ups and
    a fetched speculative compacted chunk (pinned on the JAX side, so the
    fixtures keep exercising them)."""
    seed, goal, kw = CASES["frontier-capped"]
    jm, _ = skewed_models(seed)
    old = jopt._FRONTIER_DENSE_MIN
    jopt._FRONTIER_DENSE_MIN = 8
    try:
        _, ji = jopt.frontier_fixpoint(jm, JaxOptions.none(jm), jax_goals([goal])[0], (),
                                       JaxBC.default(), **kw)
    finally:
        jopt._FRONTIER_DENSE_MIN = old
    assert ji["buckets"] == [8]
    assert ji["chunks_speculative"] > 0
    assert any(c["speculative"] and c["bucket"] == 8 for c in ji["chunks"])
