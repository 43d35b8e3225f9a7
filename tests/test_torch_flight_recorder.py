"""The port's solve flight recorder (``CRUISE_FLIGHT_RECORDER=1``) against
the JAX package's, on the CPU.

The same clusters go through both packages with the recorder on: every
goal's timeline (one row per executed step: actions, frontier population,
repair flag, bisection depth, live lanes, the best eligible score and the
kind that kept the most) equals the JAX package's row for row — integer
slots exactly and the score's f32 bits exactly (the decoded score is
compared with ``==``, no tolerance) — on the grouped stack at 6 brokers
and the per-goal driver with speculation at 12 brokers (the pipelined and
sequential per-goal paths at 12 brokers are in
tests/test_torch_flight_recorder_12.py).  Recorder-off runs place as
recorder-on runs and carry no timeline, and the repair and flight sensors
carry the JAX package's names and values.  The solves are shared in module
fixtures.
"""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu_torch.analyzer import graphs
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N, CTR_STEPS,
                                                     CTR_WIDTH, FLIGHT_WIDTH,
                                                     OptimizationOptions, StepState)
from tests.torch_port_helpers import (FLIGHT_DRIVER_KW, FLIGHT_STACK, SPEC_6, SPEC_12,
                                      ClusterSpec, JaxSpec, assert_same_flight,
                                      assert_same_placement, clear_cruise_env, flight_solves,
                                      generate_cluster, jax_generate, port_flight_run,
                                      to_torch)

@pytest.fixture(scope="module")
def grouped6():
    jm = jax_generate(JaxSpec(**SPEC_6))
    tm = to_torch(jm)
    jrun, trun, jsens, tsens = flight_solves(jm, tm, FLIGHT_STACK)
    off = port_flight_run(tm, FLIGHT_STACK, recorder=False)
    return jrun, trun, jsens, tsens, off


@pytest.fixture(scope="module")
def driver12():
    """The per-goal driver alone, speculating, recorder on and off."""
    jm = jax_generate(JaxSpec(**SPEC_12))
    tm = to_torch(jm)
    jg = jax_goals(["ReplicaDistributionGoal"])[0]
    tg = goals_by_priority(["ReplicaDistributionGoal"])[0]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        clear_cruise_env(mp)
        mp.setenv("CRUISE_FLIGHT_RECORDER", "1")
        out["jax"] = jopt.frontier_fixpoint(jm, JaxOptions.none(jm), jg, (), JaxBC.default(),
                                            speculate=True, **FLIGHT_DRIVER_KW)
        out["on"] = topt.frontier_fixpoint(tm, OptimizationOptions.none(tm), tg, (),
                                           BalancingConstraint.default(), speculate=True,
                                           **FLIGHT_DRIVER_KW)
        mp.delenv("CRUISE_FLIGHT_RECORDER")
        out["off"] = topt.frontier_fixpoint(tm, OptimizationOptions.none(tm), tg, (),
                                            BalancingConstraint.default(), speculate=True,
                                            **FLIGHT_DRIVER_KW)
    return out


@pytest.mark.parametrize("goal", FLIGHT_STACK)
def test_grouped_rows_equal_jax(grouped6, goal):
    jrun, trun, _, _, _ = grouped6
    j = next(g for g in jrun.goal_results if g.name == goal)
    t = next(g for g in trun.goal_results if g.name == goal)
    assert (t.steps, t.actions_applied) == (j.steps, j.actions_applied)
    assert t.steps > 0, "the fixture's goal took no step"
    assert_same_flight(t.flight, j.flight, goal)
    assert len(t.flight["steps"]) == t.steps
    assert sum(s["actions"] for s in t.flight["steps"]) == t.actions_applied


def test_grouped_recorder_off_places_as_on(grouped6):
    jrun, trun, _, _, off = grouped6
    assert_same_placement(trun.model, jrun.model)
    assert_same_placement(off.model, trun.model)
    assert [(g.steps, g.actions_applied) for g in off.goal_results] == \
        [(g.steps, g.actions_applied) for g in trun.goal_results]
    assert all(g.flight is None for g in off.goal_results)


def test_grouped_sensors_match_jax(grouped6):
    _, _, jsens, tsens, _ = grouped6
    assert any(k.startswith("GoalOptimizer.actions-per-step") for k in tsens)
    assert tsens == jsens


def test_driver_rows_equal_jax(driver12):
    (_, jinfo), (_, tinfo) = driver12["jax"], driver12["on"]
    assert tinfo["chunks_speculative"] > 0
    assert (tinfo["steps"], tinfo["actions"], tinfo["fetches"]) == \
        (jinfo["steps"], jinfo["actions"], jinfo["fetches"])
    assert_same_flight(tinfo["flight"], jinfo["flight"], "driver")


def test_driver_recorder_on_is_identical_to_off(driver12):
    (m_on, on), (m_off, off) = driver12["on"], driver12["off"]
    assert_same_placement(m_on, m_off)
    for key in ("steps", "actions", "chunks_speculative", "chunks_wasted", "fetches",
                "replays"):
        assert on[key] == off[key], key
    assert "flight" in on and "flight" not in off


def test_driver_timeline_covers_every_step(driver12):
    _, info = driver12["on"]
    fl = info["flight"]
    steps = fl["steps"]
    assert len(steps) == info["steps"]
    assert [s["step"] for s in steps] == list(range(len(steps)))
    assert len(fl["chunks"]) == len(info["chunks"]) == info["fetches"]
    for ci, chunk in enumerate(info["chunks"]):
        rows = [s for s in steps if s["chunk"] == ci]
        assert len(rows) == chunk["steps"] == fl["chunks"][ci]["len"]
        assert sum(s["actions"] for s in rows) == chunk["actions"]
    active = [s for s in steps if s["actions"] > 0]
    assert active
    for s in active:
        assert s["kind"] in fl["kinds"] and s["best_score"] is not None


def test_flight_row_writes_one_row_and_nothing_when_gated_off():
    """K8's flight row on the CPU: the row of a step at its chunk-local
    index (clipped to the last row), the first batch with the most kept as
    the kind, -inf bits when no lane is eligible, and no write when the
    counters gate the step off."""
    rng = np.random.default_rng(3)
    k = 50
    keep = torch.from_numpy(rng.random(k) < 0.3)
    keep[:10] = False
    keep[10:14] = True  # batch 1 keeps 4 + whatever random
    score = torch.from_numpy(rng.normal(size=k).astype(np.float32))
    eligible = torch.from_numpy(rng.random(k) < 0.5)
    fmask = torch.tensor([True, False, True, True])
    buf = torch.full((4, FLIGHT_WIDTH), 99, dtype=torch.int32)
    counters = torch.zeros((CTR_WIDTH,), dtype=torch.int32)
    counters[CTR_LAST_N], counters[CTR_BUDGET] = 1, 8
    offsets, kinds = (0, 10, 30, 50), (0, 1, 3)
    rep, lanes = torch.tensor(1, dtype=torch.int32), torch.tensor(17, dtype=torch.int32)
    for steps in (0, 6):
        counters[CTR_STEPS] = steps
        topt.flight_row(counters, keep, offsets, kinds, score, eligible, fmask, rep, lanes,
                        9, buf)
    counts = [int(keep[a:b].sum()) for a, b in zip(offsets[:-1], offsets[1:])]
    best = np.float32(np.where(eligible.numpy(), score.numpy(), -np.inf).max())
    want = [int(keep.sum()), 3, 1, 9, 17, int(best.view(np.int32)),
            kinds[int(np.argmax(counts))]]
    assert buf[0].tolist() == want and buf[3].tolist() == want
    assert buf[1].tolist() == [99] * FLIGHT_WIDTH
    counters[CTR_STEPS], counters[CTR_LAST_N] = 1, 0  # converged: gated off
    topt.flight_row(counters, keep, offsets, kinds, score, torch.zeros_like(eligible), None,
                    rep, lanes, 9, buf)
    assert buf[1].tolist() == [99] * FLIGHT_WIDTH
    counters[CTR_LAST_N] = 1
    topt.flight_row(counters, torch.zeros_like(keep), offsets, kinds, score,
                    torch.zeros_like(eligible), None, rep, lanes, 9, buf)
    assert buf[1].tolist() == [0, -1, 1, 9, 17, int(np.float32(-np.inf).view(np.int32)), -1]


def test_goal_key_separates_recorder_oracle_and_ablation():
    m = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    st = StepState.working(m, OptimizationOptions.none(m))
    spec = goals_by_priority(["ReplicaDistributionGoal"])[0]
    keys = {graphs.goal_key(spec, (), None, 1, 1, st),
            graphs.goal_key(spec, (), None, 1, 1, st, flight_cap=8),
            graphs.goal_key(spec, (), None, 1, 1, st, oracle=True),
            graphs.goal_key(spec, (), None, 1, 1, st, no_budgets=True)}
    assert len(keys) == 4
    assert graphs.goal_key(spec, (), None, 1, 1, st) == \
        graphs.goal_key(spec, (), None, 1, 1, st, None, 0, False, False)
