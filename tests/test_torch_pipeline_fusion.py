"""Auto-fusion of the port's pipelined path against the JAX package's, with
the canned sweeps of tests/test_pipeline.py:307-319 patched into both
packages' ``_get_frontier_sweep_fn`` (the tests at :322 and :350): two band
goals with disjoint predicted frontiers run as one grouped stack, two with
overlapping ones run as pipelined singletons — per goal, per run and in
placement equal to the JAX runs, with every goal satisfied."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from tests.test_pipeline import _canned_sweep
from tests.test_torch_pipeline import compare
from tests.torch_port_helpers import clear_cruise_env, skewed_models

GOALS = ["ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"]


@pytest.mark.parametrize("second,fused", [([8, 9], 2), ([2, 8, 9], 0)],
                         ids=["disjoint", "overlapping"])
def test_auto_fusion_matches_jax(second, fused, monkeypatch):
    clear_cruise_env(monkeypatch)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
    jm, tm = skewed_models(7)
    B = tm.num_brokers
    f0 = np.zeros(B, bool)
    f0[[0, 1, 2]] = True
    f1 = np.zeros(B, bool)
    f1[second] = True
    monkeypatch.setattr(jopt, "_get_frontier_sweep_fn", _canned_sweep([f0, f1]))
    monkeypatch.setattr(topt, "_get_frontier_sweep_fn", _canned_sweep([f0, f1]))
    kw = dict(fused=True, pipeline=True, raise_on_hard_failure=False)
    jrun = jopt.optimize(jm, GOALS, **kw)
    trun = topt.optimize(tm, GOALS, device="cpu", **kw)
    compare(jrun, trun)
    assert trun.pipelined and trun.goals_fused == fused
    assert [g.fused_group for g in trun.goal_results] == [max(fused, 1)] * 2
    arrays = BrokerArrays.from_model(trun.model)
    for s in goals_by_priority(GOALS):
        assert bool(tk.goal_satisfied(s, trun.model, arrays, BalancingConstraint.default()))
