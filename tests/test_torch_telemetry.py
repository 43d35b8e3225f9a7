"""The optimizer's telemetry in the PyTorch port, on the CPU: the
``analyzer.optimize`` span with one ``analyzer.goal`` child per goal, and
the dispatch, warm-start and pipeline sensors, as the JAX package reports
them (``optimizer.py:2559-2690``, ``:2859-2905``)."""

import pytest

from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.state import WarmStart
from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.common.tracing import TRACE
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import SPEC_6, clear_cruise_env

GOALS = ["RackAwareGoal", "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal"]


def _counter(name, goal=None):
    key = name if goal is None else f'{name}{{goal="{goal}"}}'
    return SENSORS.snapshot().get(key, 0)


def _solve(**kw):
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    return topt.optimize(tm, GOALS, raise_on_hard_failure=False, device="cpu", **kw)


@pytest.mark.parametrize("kw", [{}, {"fused": True}, {"fused": True, "fuse_group_size": 1},
                                {"fused": True, "pipeline": True}],
                         ids=["unfused", "grouped", "per-goal", "pipelined"])
def test_optimize_span_has_one_child_per_goal(kw, monkeypatch):
    clear_cruise_env(monkeypatch)
    run = _solve(**kw)
    root = TRACE.recent(1)[0]
    assert root["name"] == "analyzer.optimize"
    assert root["attrs"]["goals"] == len(GOALS)
    assert root["attrs"]["fused"] == kw.get("fused", False)
    assert root["attrs"]["steps"] == sum(g.steps for g in run.goal_results)
    assert root["attrs"]["pipelined"] == run.pipelined
    children = root["children"]
    assert [c["name"] for c in children] == ["analyzer.goal"] * len(GOALS)
    assert [c["attrs"]["goal"] for c in children] == GOALS
    assert [c["attrs"]["actions"] for c in children] == \
        [g.actions_applied for g in run.goal_results]
    assert all(("pipelined" in c["attrs"]) == run.pipelined for c in children)


def test_dispatch_sensors_count_the_drivers_fetches(monkeypatch):
    clear_cruise_env(monkeypatch)
    before = {g: _counter("GoalOptimizer.device-fetches", g) for g in GOALS}
    run = _solve(fused=True, fuse_group_size=1)
    for g in run.goal_results:
        if g.chunks is None:  # skipped by the satisfied-sweep: no driver
            continue
        fetched = _counter("GoalOptimizer.device-fetches", g.name) - before[g.name]
        assert fetched == len(g.chunks)
        assert _counter("GoalOptimizer.boundary-fetch-bytes", g.name) > 0
    lead = GOALS[0]
    n = _counter("GoalOptimizer.device-fetches", lead)
    _solve(fused=True)  # the grouped stack: one fetch, counted on its lead goal
    assert _counter("GoalOptimizer.device-fetches", lead) == n + 1


def test_warm_and_pipeline_sensors(monkeypatch):
    clear_cruise_env(monkeypatch)
    warm0 = _counter("GoalOptimizer.warm-start-solves")
    fused0 = _counter("GoalOptimizer.goals-fused")
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    run = topt.optimize(tm, GOALS, raise_on_hard_failure=False, device="cpu", fused=True,
                        pipeline=True, warm_start=WarmStart(prev_model=tm))
    assert run.warm and run.pipelined
    assert _counter("GoalOptimizer.warm-start-solves") == warm0 + 1
    assert _counter("GoalOptimizer.goals-fused") == fused0 + run.goals_fused
    snap = SENSORS.snapshot()
    assert "GoalOptimizer.pipeline-fill-ratio" in snap
    assert "GoalOptimizer.warm-start-seed-frontier-size" in snap
