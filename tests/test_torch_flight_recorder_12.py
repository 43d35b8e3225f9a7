"""The port's flight recorder against the JAX package's on the pipelined
path (``optimize(fused=True, pipeline=True)``: per-goal drivers queuing the
next goal's opener) and the sequential per-goal path (``fuse_group_size=1``)
at 12 brokers, the dense floor lowered to 8 in both packages: every goal's
timeline equals the JAX package's row for row (integer slots and score bits
exactly), recorder-off runs place as recorder-on runs, and the repair and
flight sensors match.  See tests/test_torch_flight_recorder.py."""

import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu_torch.analyzer import optimizer as topt
from tests.torch_port_helpers import (FLIGHT_STACK, SPEC_12, JaxSpec, assert_same_flight,
                                      assert_same_placement, flight_solves, jax_generate,
                                      port_flight_run, to_torch)


@pytest.fixture(scope="module")
def lowered_floor():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
        mp.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
        yield


@pytest.fixture(scope="module")
def pipelined12(lowered_floor):
    jm = jax_generate(JaxSpec(**SPEC_12))
    tm = to_torch(jm)
    jrun, trun, jsens, tsens = flight_solves(jm, tm, FLIGHT_STACK, pipeline=True)
    off = port_flight_run(tm, FLIGHT_STACK, recorder=False, pipeline=True)
    return jrun, trun, jsens, tsens, off


@pytest.fixture(scope="module")
def sequential12(lowered_floor):
    jm = jax_generate(JaxSpec(**SPEC_12))
    tm = to_torch(jm)
    jrun, trun, _, _ = flight_solves(jm, tm, FLIGHT_STACK, fuse_group_size=1, pipeline=False)
    return jrun, trun


def test_pipelined_rows_equal_jax(pipelined12):
    jrun, trun, _, _, _ = pipelined12
    assert trun.pipelined and trun.goals_fused == 0
    assert [g.pipelined for g in trun.goal_results] == [g.pipelined for g in jrun.goal_results]
    ran = 0
    for j, t in zip(jrun.goal_results, trun.goal_results):
        assert (t.steps, t.actions_applied) == (j.steps, j.actions_applied), t.name
        if j.flight is None:
            assert t.flight is None and t.chunks is None, t.name  # skipped by the sweep
            continue
        ran += 1
        assert_same_flight(t.flight, j.flight, t.name)
    assert ran >= 2
    assert_same_placement(trun.model, jrun.model)


def test_pipelined_recorder_off_places_as_on(pipelined12):
    _, trun, _, _, off = pipelined12
    assert_same_placement(off.model, trun.model)
    assert [(g.steps, g.actions_applied) for g in off.goal_results] == \
        [(g.steps, g.actions_applied) for g in trun.goal_results]
    assert all(g.flight is None for g in off.goal_results)


def test_pipelined_sensors_match_jax(pipelined12):
    _, _, jsens, tsens, _ = pipelined12
    assert tsens == jsens


def test_sequential_rows_equal_jax(sequential12):
    jrun, trun = sequential12
    assert not trun.pipelined
    for j, t in zip(jrun.goal_results, trun.goal_results):
        assert (t.steps, t.actions_applied) == (j.steps, j.actions_applied), t.name
        if j.flight is not None:
            assert_same_flight(t.flight, j.flight, t.name)
        else:
            assert t.flight is None
    assert_same_placement(trun.model, jrun.model)
