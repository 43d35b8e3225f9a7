"""The fused path's gated step and driver in the PyTorch port, on the CPU
(no JAX program; the JAX parity runs are tests/test_torch_fused_*.py).

- The gated step is the JAX fixpoint loop's body: while active it equals
  ``_goal_step`` (placement, action count, selection stats); once the goal
  has converged or spent its budget, further gated steps leave the model
  and the counters bit-unchanged.
- ``optimize(fused=True)`` never writes the caller's model, reports its
  host reads and gated steps, runs an explicit ``fuse_group_size`` above
  the 64-broker floor like the unfused path, does what the JAX package
  does where it pipelines the goals (above 64 brokers by default, and on
  request) and where it ignores ``frontier=True`` (off the per-goal path),
  and refuses a mesh.
"""

import dataclasses

import pytest
import torch

from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N, CTR_STEPS,
                                                     PACKED_NUM_ACTIVE, PACKED_WIDTH,
                                                     BrokerArrays, OptimizationOptions,
                                                     StepState)
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import (PLACEMENT, SPEC_6, SPEC_12, SPEC_ENTRY, STACK,
                                      check_like_jax, clear_cruise_env, goal_rows)

PREV = ("RackAwareGoal",)
GOAL = "ReplicaDistributionGoal"


def _setup(spec_kw=SPEC_12):
    tm = generate_cluster(ClusterSpec(**spec_kw), device="cpu")
    con = BalancingConstraint.default()
    spec, prev = GOAL_SPECS[GOAL], tuple(GOAL_SPECS[g] for g in PREV)
    ns, nd = tc.default_num_sources(tm), tc.default_num_dests(tm)
    st = StepState.working(tm, OptimizationOptions.none(tm))
    inv = topt.compute_step_invariants(spec, prev, st.model, BrokerArrays.from_model(st.model),
                                       con)
    return tm, st, inv, (spec, prev, con, ns, nd)


def _snapshot(st):
    return [getattr(st.model, f).clone() for f in PLACEMENT] + [st.counters.clone()]


def test_active_gated_step_equals_goal_step():
    tm, st, inv, (spec, prev, con, ns, nd) = _setup()
    st.counters[CTR_LAST_N] = 1
    st.counters[CTR_BUDGET] = 10
    new, n, (rep, lanes, depth) = topt._goal_step(tm, OptimizationOptions.none(tm), spec,
                                                  prev, con, ns, nd, invariants=inv)
    topt._gated_step(st, inv, spec, prev, con, ns, nd)
    for f in PLACEMENT:
        assert torch.equal(getattr(st.model, f), getattr(new, f)), f
    assert int(n) > 0
    assert st.counters.tolist() == [1, int(n), int(n), int(rep), depth, int(lanes), 10]


@pytest.mark.parametrize("how", ["converged", "budget"])
def test_gated_steps_after_the_fixpoint_change_nothing(how):
    tm, st, inv, (spec, prev, con, ns, nd) = _setup()
    if how == "converged":
        topt._goal_fixpoint_budget(st, spec, prev, con, ns, nd, 256, None)
        assert st.counters[CTR_LAST_N] == 0
    else:
        st.counters[CTR_LAST_N] = 1
        st.counters[CTR_BUDGET] = 2
        for _ in range(2):
            topt._gated_step(st, inv, spec, prev, con, ns, nd)
        assert st.counters[CTR_STEPS] == 2 and st.counters[CTR_LAST_N] > 0
    before = _snapshot(st)
    for _ in range(3):
        topt._gated_step(st, inv, spec, prev, con, ns, nd)
    for a, b in zip(before, _snapshot(st)):
        assert torch.equal(a, b)


def test_packed_vector_layout():
    tm, st, _, (spec, prev, con, ns, nd) = _setup()
    packed, run = topt._goal_fixpoint_budget(st, spec, prev, con, ns, nd, 256, None)
    assert packed.dtype == torch.int32 and packed.shape == (PACKED_WIDTH,)
    steps, actions, before, after, capped = packed[:5].tolist()
    assert steps > 0 and actions > 0 and (before, after, capped) == (0, 1, 0)
    assert packed[PACKED_NUM_ACTIVE] >= 0  # a band kind
    assert run.gated_steps >= steps and run.fetches >= 1 and not run.captured
    rack, _ = topt._goal_fixpoint_budget(st, GOAL_SPECS["RackAwareGoal"], (), con, ns, nd,
                                         256, None)
    assert rack[PACKED_NUM_ACTIVE] == -1  # not a band kind


def test_fused_run_leaves_the_callers_model_and_reports_its_reads():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    before = [getattr(tm, f).clone() for f in PLACEMENT]
    run = topt.optimize(tm, STACK, raise_on_hard_failure=False, fused=True,
                        donate_model=True, device="cpu")
    for f, b in zip(PLACEMENT, before):
        assert torch.equal(getattr(tm, f), b), f
    assert not torch.equal(run.model.replica_broker, tm.replica_broker)
    for i, g in enumerate(run.goal_results):
        assert g.replays >= max(g.steps, 1)
        assert g.fetches >= 1 + (i == 0)
        assert not g.fresh_compile  # no graph is captured on the CPU


def test_max_candidates_per_step_matches_the_unfused_path():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    kw = dict(raise_on_hard_failure=False, max_candidates_per_step=96, device="cpu")
    fused = topt.optimize(tm, STACK, fused=True, **kw)
    plain = topt.optimize(tm, STACK, **kw)
    assert goal_rows(fused, 5) == goal_rows(plain, 5)
    for f in PLACEMENT:
        assert torch.equal(getattr(fused.model, f), getattr(plain.model, f)), f


WIDE = dict(num_brokers=72, num_racks=6, num_topics=3, mean_partitions_per_topic=24.0,
            replication_factor=2, distribution="exponential", seed=5)
SHORT = ["RackAwareGoal", "ReplicaDistributionGoal"]


def test_explicit_groups_run_above_the_dense_floor():
    tm = generate_cluster(ClusterSpec(**WIDE), device="cpu")
    fused = topt.optimize(tm, SHORT, fused=True, fuse_group_size=2, device="cpu")
    plain = topt.optimize(tm, SHORT, device="cpu")
    assert goal_rows(fused, 5) == goal_rows(plain, 5)
    for f in PLACEMENT:
        assert torch.equal(getattr(fused.model, f), getattr(plain.model, f)), f


@pytest.mark.parametrize("spec_kw,kwargs", [
    (WIDE, {}),
    (SPEC_6, {"fuse_group_size": 1, "pipeline": True}),
    (SPEC_ENTRY, {"frontier": True}),
    (SPEC_6, {"pipeline": True}),
    (SPEC_6, {"warm_start": "compatible"}),
    (SPEC_6, {"mesh": object()}),
    (WIDE, {"segment_steps": 32}),
], ids=["above-floor", "per-goal", "frontier", "pipeline", "warm_start", "mesh",
        "segment_steps"])
def test_fused_paths_of_later_slices_raise(spec_kw, kwargs, monkeypatch):
    """The fused calls later slices ported — above the floor (pipelined by
    default), the pipeline forced, a warm start, segments above the floor,
    ``frontier=True`` off the per-goal paths (which the JAX package
    ignores) — do what the JAX package does; a mesh that is no
    ``SearchMesh`` is refused with ``TypeError``."""
    clear_cruise_env(monkeypatch)
    if "mesh" in kwargs:
        tm = generate_cluster(ClusterSpec(**spec_kw), device="cpu")
        with pytest.raises(TypeError, match="SearchMesh"):
            topt.optimize(tm, SHORT, fused=True, device="cpu", **kwargs)
        return
    kwargs = dict(kwargs)
    warm = kwargs.pop("warm_start", None) is not None
    runs = check_like_jax(spec_kw, SHORT, warm=warm, fused=True, **kwargs)
    assert runs is not None and runs[1].warm == warm
    assert runs[1].pipelined == ("pipeline" in kwargs or spec_kw is WIDE)


def test_fused_hard_goal_failure_raises():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    con = dataclasses.replace(BalancingConstraint.default(),
                              capacity_threshold=(1e-6, 0.8, 0.8, 0.8))
    run = topt.optimize(tm, ["CpuCapacityGoal"], constraint=con, fused=True,
                        raise_on_hard_failure=False, device="cpu")
    assert not run.goal_results[0].satisfied_after
    with pytest.raises(topt.OptimizationFailureException, match="CpuCapacityGoal"):
        topt.optimize(tm, ["CpuCapacityGoal"], constraint=con, fused=True, device="cpu")


def test_graph_cache_keeps_the_most_recent_shapes():
    """The cache holds the static state of at most ``MAX_SHAPES`` shapes;
    a new shape evicts the least recently solved one with its graphs, and
    a held shape is reloaded from each new snapshot.  (Capturing a graph
    needs the card; the graph entries here stand in for captured ones.)"""
    from cruise_control_tpu_torch.analyzer import graphs

    cache = graphs.GraphCache()
    n = graphs.MAX_SHAPES + 1
    models = [generate_cluster(ClusterSpec(**dict(SPEC_6, num_topics=t)), device="cpu")
              for t in range(2, 2 + n)]
    opts = [OptimizationOptions.none(m) for m in models]
    spec = GOAL_SPECS[GOAL]
    states = []
    for m, o in zip(models[:-1], opts):
        st = cache.state(m, o)
        assert torch.equal(st.model.replica_broker, m.replica_broker)
        cache._graphs[graphs.goal_key(spec, (), None, 1, 1, st)] = object()
        states.append(st)
    # Solving the first shape again makes the second the oldest.
    assert cache.state(models[0], opts[0]) is states[0]
    last = cache.state(models[-1], opts[-1])
    assert len(cache._states) == graphs.MAX_SHAPES and len(cache) == graphs.MAX_SHAPES - 1
    assert cache.state(models[0], opts[0]) is states[0]
    assert cache.state(models[-1], opts[-1]) is last
    assert cache.state(models[1], opts[1]) is not states[1]  # evicted, allocated anew
    moved = models[1].replace(replica_broker=torch.roll(models[1].replica_broker, 1))
    assert torch.equal(cache.state(moved, opts[1]).model.replica_broker,
                       moved.replica_broker)
