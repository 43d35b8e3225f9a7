"""Warm starts of the port against the JAX package's, on the recipe of
tests/test_warm_start.py (8 brokers, its 8-goal stack, the sequential
per-goal path ``fuse_group_size=1`` of its ``_solve``): ``model_delta`` of
the previous converged model against a per-partition load perturbation
equals the JAX package's; the warm solve equals the JAX package's warm
solve per goal (packed slots, goals skipped) and in placement, and is as
satisfied as the cold one; a warm start whose replica axis does not match
is ignored and equals the cold solve; ``None`` is the cold solve."""

import numpy as np
import pytest

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.state import WarmStart as JaxWarm
from cruise_control_tpu.analyzer.state import model_delta as jax_delta
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.analyzer.state import WarmStart, model_delta
from cruise_control_tpu_torch.analyzer.verifier import verify_run
from tests.test_warm_start import STACK, _gen_model, _perturb
from tests.torch_port_helpers import PLACEMENT, clear_cruise_env, goal_rows, to_torch


def _jax_solve(model, warm_start=None):
    return jopt.optimize(jopt.donation_copy(model), STACK, raise_on_hard_failure=False,
                         fused=True, fuse_group_size=1, donate_model=True,
                         warm_start=warm_start)


def _solve(model, warm_start=None):
    return topt.optimize(model, STACK, raise_on_hard_failure=False, fused=True,
                         fuse_group_size=1, donate_model=True, warm_start=warm_start,
                         device="cpu")


def _same(trun, jrun):
    assert goal_rows(trun) == goal_rows(jrun)
    assert (trun.warm, trun.seed_frontier_size, trun.goals_skipped) == \
        (jrun.warm, jrun.seed_frontier_size, jrun.goals_skipped)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)


@pytest.fixture(scope="module")
def perturbed():
    base = _gen_model()
    jprev = _jax_solve(base)
    tprev = _solve(to_torch(base))
    model = _perturb(base, np.random.default_rng(5))
    return base, jprev, tprev, model


def test_model_delta_matches_jax(perturbed, monkeypatch):
    clear_cruise_env(monkeypatch)
    base, jprev, tprev, model = perturbed
    _same(tprev, jprev)
    want = jax_delta(jprev.model, model)
    got = model_delta(tprev.model, to_torch(model))
    assert got is not None and not got.is_zero
    np.testing.assert_array_equal(got.changed_mask, want.changed_mask)
    assert got.num_changed == want.num_changed
    assert got.magnitude == pytest.approx(want.magnitude, rel=1e-5)
    # Shape or membership drift: no delta, in both packages.
    alien = _gen_model(seed=4, brokers=6)
    assert jax_delta(jprev.model, alien) is None
    assert model_delta(tprev.model, to_torch(alien)) is None


def test_warm_solve_matches_jax(perturbed, monkeypatch):
    clear_cruise_env(monkeypatch)
    base, jprev, tprev, model = perturbed
    tm = to_torch(model)
    jdelta = jax_delta(jprev.model, model)
    tdelta = model_delta(tprev.model, tm)
    jwarm = _jax_solve(model, JaxWarm(prev_model=jprev.model,
                                      active_mask=jdelta.changed_mask))
    twarm = _solve(tm, WarmStart(prev_model=tprev.model, active_mask=tdelta.changed_mask))
    _same(twarm, jwarm)
    assert twarm.warm and twarm.seed_frontier_size == tdelta.num_changed
    cold = _solve(tm)
    assert not cold.warm
    verify_run(tm, twarm, STACK, proposals=tprops.diff(tm, twarm.model))
    cold_sat = {g.name: g.satisfied_after for g in cold.goal_results}
    assert all(g.satisfied_after for g in twarm.goal_results if cold_sat[g.name])
    assert twarm.goals_skipped >= cold.goals_skipped


def test_incompatible_warm_start_is_the_cold_solve(monkeypatch):
    clear_cruise_env(monkeypatch)
    jm = _gen_model(seed=3)
    tm = to_torch(jm)
    jalien = _gen_model(seed=4, brokers=6)
    jrun = _jax_solve(jm, JaxWarm(prev_model=jalien))
    cold = _solve(tm)
    run = _solve(tm, WarmStart(prev_model=to_torch(jalien)))
    none = _solve(tm, None)
    assert not run.warm and not jrun.warm
    _same(run, jrun)
    for other in (cold, none):
        assert goal_rows(run) == goal_rows(other)
        for f in PLACEMENT:
            np.testing.assert_array_equal(getattr(run.model, f).numpy(),
                                          getattr(other.model, f).numpy(), err_msg=f)
