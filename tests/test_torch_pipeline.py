"""The port's pipelined path, ``optimize(fused=True, pipeline=True)``,
against the JAX package's on the skewed 16-broker model with the dense
floor lowered to 8 in both packages and the stack of
tests/test_pipeline.py:42, with auto-fusion off (``CRUISE_PIPELINE_FUSE=0``)
and at its default: per goal the steps, actions, flags, ``pipelined``,
``fused_group``, cross-goal counts and chunk records, per run
``pipelined``, ``goals_overlapped`` and ``goals_fused``, and the placement
are equal.  As the JAX package pins (tests/test_pipeline.py:174-204), the
pipelined run equals the sequential one in placement and per-goal steps
and actions, and overlaps at least one goal boundary."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu_torch.analyzer import optimizer as topt
from tests.torch_port_helpers import PLACEMENT, chunk_keys, clear_cruise_env, skewed_models

STACK3 = ["RackAwareGoal", "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"]


def pipeline_rows(run):
    """Per goal: name, steps, actions, flags, pipelined, fused group, cross
    counts and chunk records."""
    return [(g.name, g.steps, g.actions_applied, g.satisfied_before, g.satisfied_after,
             g.capped, g.pipelined, g.fused_group, g.chunks_cross_goal,
             g.chunks_cross_wasted, chunk_keys({"chunks": g.chunks}) if g.chunks else None)
            for g in run.goal_results]


def run_summary(run):
    return (run.pipelined, run.goals_overlapped, run.goals_fused)


def compare(jrun, trun):
    assert pipeline_rows(trun) == pipeline_rows(jrun)
    assert run_summary(trun) == run_summary(jrun)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)


@pytest.mark.parametrize("fuse", ["0", None], ids=["fusion-off", "fusion-default"])
def test_pipelined_optimize_matches_jax(fuse, monkeypatch):
    clear_cruise_env(monkeypatch)
    if fuse is not None:
        monkeypatch.setenv("CRUISE_PIPELINE_FUSE", fuse)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
    jm, tm = skewed_models(7)
    kw = dict(fused=True, raise_on_hard_failure=False)
    jrun = jopt.optimize(jm, STACK3, pipeline=True, **kw)
    before = dict(topt.FETCH_COUNTERS)
    trun = topt.optimize(tm, STACK3, pipeline=True, device="cpu", **kw)
    compare(jrun, trun)
    assert trun.pipelined and trun.goals_overlapped >= 1
    assert any(g.pipelined for g in trun.goal_results)
    cross = sum(g.chunks_cross_goal for g in trun.goal_results)
    wasted = sum(g.chunks_cross_wasted for g in trun.goal_results)
    assert cross == trun.goals_overlapped + wasted
    assert topt.FETCH_COUNTERS["chunks_cross_goal"] - before["chunks_cross_goal"] == cross
    # Pipelined equals sequential in placement and per-goal steps and
    # actions; the sequential run carries no pipeline accounting.
    seq = topt.optimize(tm, STACK3, pipeline=False, device="cpu", **kw)
    assert not seq.pipelined
    assert [(g.name, g.steps, g.actions_applied) for g in seq.goal_results] == \
        [(g.name, g.steps, g.actions_applied) for g in trun.goal_results]
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(seq.model, f).numpy(),
                                      getattr(trun.model, f).numpy(), err_msg=f)
    assert all(not g.pipelined and g.chunks_cross_goal == 0 for g in seq.goal_results)
