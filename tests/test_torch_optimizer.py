"""The PyTorch port's dense goal-stack solve against the JAX package.

- ``__graft_entry__.entry()``'s step (ReplicaDistributionGoal after
  RackAwareGoal and DiskCapacityGoal on the 8-broker cluster): the keep mask
  is identical to the JAX package's, lane for lane, and so is the placement
  its jitted step produces.
- The full default stack on the 6-broker cluster of tests/test_optimizer.py
  is equisatisfying per goal with ``optimize(..., fused=False,
  frontier=False)``; the port's ``verify_run`` passes, and the port's final
  placement, carried back into a JAX model, passes the JAX package's
  ``verify_run`` with the JAX package's own proposal diff, which equals the
  port's.  (The 12-broker cluster is in test_torch_stack.py.)
- Options of later slices raise instead of being ignored (``fused=True``
  only where it would pipeline the goals).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__
from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import (SPEC_6, check_like_jax, check_stack, clear_cruise_env,
                                      to_torch)

ENTRY_GOAL = "ReplicaDistributionGoal"
ENTRY_PREV = ("RackAwareGoal", "DiskCapacityGoal")


@jax.jit
def _jax_entry_keep(model, options):
    """The keep mask of the JAX package's ``_goal_step`` for the entry step,
    composed from the same JAX functions in the same order and jitted like
    the step itself (which returns only the new model and the count)."""
    spec = JAX_SPECS[ENTRY_GOAL]
    prev = tuple(JAX_SPECS[g] for g in ENTRY_PREV)
    con = JaxBC.default()
    arrays = JaxBrokerArrays.from_model(model)
    ns = jopt._goal_num_sources(spec, model, 32, 8)
    inv = jopt.compute_step_invariants(spec, prev, model, arrays, con)
    bands = (inv.spec_lower, inv.spec_upper)
    rel = jk.source_replica_relevance(spec, model, arrays, con, bands=bands)
    cand = jc.combined_move_candidates(
        spec, model, arrays, con, options, min(ns, max(64, ns // 4)), 8,
        num_matched=jc.default_num_matched(model, ns), relevance=rel, bands=bands)
    accepted = jnp.ones(cand.k, bool)
    for p in prev:
        if not jk.is_band_kind(p):
            accepted = accepted & jk.accepts(p, model, arrays, cand, con)
    score = jk.score(spec, model, arrays, cand, con, bands=bands)
    eligible = (cand.valid & jk.self_feasible(spec, model, arrays, cand, con, bands=bands)
                & accepted & (score > 1e-9))
    all_specs = (spec,) + prev
    room, slack = jopt._channel_budgets(all_specs, model, arrays, con,
                                        sides=(inv.upper_min, inv.lower_max))
    keep, _ = jopt.select_batched(
        score, cand, eligible, model, room, slack,
        jopt._topic_budgets(all_specs, model, arrays, con, inv=inv), False, rounds=1,
        subrounds=128, has_swaps=False,
        compact_k=jopt._lane_bucket(cand.k, model.num_brokers, 128))
    return keep


def test_entry_step_keep_mask_is_identical():
    fn, (jmodel, joptions) = __graft_entry__.entry()
    jnew, jn, _ = jax.jit(fn)(jmodel, joptions)
    want = np.asarray(_jax_entry_keep(jmodel, joptions))
    tmodel = to_torch(jmodel)
    args = (tmodel, OptimizationOptions.none(tmodel), GOAL_SPECS[ENTRY_GOAL],
            tuple(GOAL_SPECS[g] for g in ENTRY_PREV), BalancingConstraint.default(), 32, 8)
    _, keep, _ = topt._step_select(*args)
    tnew, n_kept, _ = topt._goal_step(*args)
    got = keep.numpy()
    assert got.shape == want.shape
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (f"keep masks differ first at lane {bad[0]} "
                           f"(port {got[bad[0]]}, JAX {want[bad[0]]}); {bad.size} lanes")
    assert int(keep.sum()) == int(n_kept) == int(jn) > 0
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        np.testing.assert_array_equal(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                      err_msg=f)


def test_full_stack_6_brokers():
    check_stack(SPEC_6)


@pytest.mark.parametrize("kwargs", [{"fused": True, "fuse_group_size": 1, "pipeline": True},
                                    {"mesh": object()}, {"frontier": True},
                                    {"pipeline": True}, {"warm_start": "compatible"},
                                    {"segment_steps": 4}],
                         ids=["fused", "mesh", "frontier", "pipeline", "warm_start",
                              "segment_steps"])
def test_later_slice_options_raise(kwargs, monkeypatch):
    """Options of later slices do what the JAX package does on the same
    call: the forced pipeline runs, ``pipeline=True`` on the unfused path
    raises ValueError, a warm start re-bases the unfused solve, and
    ``frontier=True`` and ``segment_steps``, which the unfused path does
    not read, are ignored; a mesh that is no ``SearchMesh`` is refused
    with ``TypeError``."""
    clear_cruise_env(monkeypatch)
    goals = ["ReplicaDistributionGoal"]
    if "mesh" in kwargs:
        tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
        with pytest.raises(TypeError, match="SearchMesh"):
            topt.optimize(tm, goals, device="cpu", **kwargs)
        return
    kwargs = dict(kwargs)
    warm = kwargs.pop("warm_start", None) is not None
    runs = check_like_jax(SPEC_6, goals, warm=warm, **kwargs)
    if kwargs.get("pipeline") and not kwargs.get("fused"):
        assert runs is None  # ValueError in both packages
    else:
        assert runs is not None and runs[1].warm == warm


def test_multi_round_selection_raises():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    con = dataclasses.replace(BalancingConstraint.default(), moves_per_broker_step=256)
    with pytest.raises(NotImplementedError, match="multi-round"):
        topt.optimize(tm, ["ReplicaDistributionGoal"], constraint=con, device="cpu")


def test_hard_goal_failure_raises():
    """A hard goal left unsatisfied raises unless asked not to: at a CPU cap
    of 1e-6 of capacity no placement fits."""
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    con = dataclasses.replace(BalancingConstraint.default(),
                              capacity_threshold=(1e-6, 0.8, 0.8, 0.8))
    run = topt.optimize(tm, ["CpuCapacityGoal"], constraint=con,
                        raise_on_hard_failure=False, device="cpu")
    assert not run.goal_results[0].satisfied_after
    assert run.provision_response.status.value == "under_provisioned"
    with pytest.raises(topt.OptimizationFailureException, match="CpuCapacityGoal"):
        topt.optimize(tm, ["CpuCapacityGoal"], constraint=con, device="cpu")
