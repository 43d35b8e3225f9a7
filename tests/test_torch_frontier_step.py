"""The per-goal path's host helpers, one compacted step, and the policy of
``optimize(fused=True)``, in the PyTorch port against the JAX package:

- ``_frontier_bucket`` and ``_frontier_widths`` equal the JAX package's over
  a sweep of (active brokers, brokers), at the 64-broker floor and at a
  lowered one, and ``_build_frontier`` gives the same index maps;
- one step on a fixed frontier of the skewed 16-broker model of
  tests/test_frontier.py:51 (floor lowered to 8 in both packages): the
  same candidate index sets, eligibility and keep mask as the JAX step
  composed from its functions, and the same placement and count as its
  jitted ``_goal_step``, for a move goal and a move-and-swap goal;
- which settings run the per-goal path, and which raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import candidates as jc
from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu.analyzer.state import BrokerArrays as JaxArrays
from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import (PLACEMENT, SPEC_6, SPEC_ENTRY, STACK, check_like_jax,
                                      clear_cruise_env, skewed_models)

PREV = ("RackAwareGoal",)


@pytest.mark.parametrize("floor", [64, 8])
def test_bucket_and_widths_match(floor, monkeypatch):
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", floor)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", floor)
    for b in (3, 8, 9, 16, 50, 64, 65, 100, 200, 333, 1000, 1024):
        for na in range(0, b + 1):
            assert topt._frontier_bucket(na, b) == jopt._frontier_bucket(na, b), (na, b)
    for bucket in (8, 16, 64, 128, 256, 512):
        for ns, nd in ((2048, 875), (64, 16), (4, 1), (200, 25), (1, 1)):
            assert topt._frontier_widths(bucket, ns, nd) == \
                jopt._frontier_widths(bucket, ns, nd)


def test_build_frontier_maps_match():
    rng = np.random.default_rng(5)
    for b, bucket in ((16, 8), (200, 64), (200, 128), (1000, 512)):
        for _ in range(3):
            active = np.zeros(b, bool)
            active[rng.choice(b, rng.integers(1, bucket + 1), replace=False)] = True
            want = jopt._build_frontier(active, bucket)
            got = topt._build_frontier(active, bucket)
            assert got.bucket == bucket
            for f in ("active", "compact_of_full", "full_of_compact"):
                np.testing.assert_array_equal(getattr(got, f).numpy(),
                                              np.asarray(getattr(want, f)), err_msg=f)


def _frontier_of(jm):
    """The skewed model's ReplicaDistributionGoal frontier, bucketed at the
    lowered floor, in both packages (the fixed frontier every step test
    runs on)."""
    arrays = JaxArrays.from_model(jm)
    active = np.asarray(jk.frontier_active(JAX_SPECS["ReplicaDistributionGoal"], jm,
                                           arrays, JaxBC.default()))
    bucket = jopt._frontier_bucket(int(active.sum()), jm.num_brokers)
    assert bucket == 8
    return jopt._build_frontier(active, bucket), topt._build_frontier(active, bucket)


def _jax_step_parts(model, options, fr, ns, nd):
    """(cand.replica, cand.dest, eligible, keep) of the JAX package's
    frontier step for ReplicaDistributionGoal after RackAwareGoal, composed
    from its functions in ``_goal_step``'s order (the step returns only the
    new model and the count)."""
    spec, prev = JAX_SPECS["ReplicaDistributionGoal"], (JAX_SPECS["RackAwareGoal"],)
    con = JaxBC.default()
    arrays = JaxArrays.from_model(model)
    ns = jopt._goal_num_sources(spec, model, ns, nd)
    inv = jopt.compute_step_invariants(spec, prev, model, arrays, con)
    bands = (inv.spec_lower, inv.spec_upper)
    active = fr.active
    rel = jk.source_replica_relevance(spec, model, arrays, con, bands=bands)
    rel = jnp.where(active[model.replica_broker], rel, -jnp.inf)
    cand = jc.combined_move_candidates(
        spec, model, arrays, con, options, min(ns, max(64, ns // 4)), nd,
        num_matched=jc.default_num_matched(model, ns), relevance=rel, bands=bands,
        active=active)
    accepted = jk.accepts(prev[0], model, arrays, cand, con)
    score = jk.score(spec, model, arrays, cand, con, bands=bands)
    eligible = (cand.valid & jk.self_feasible(spec, model, arrays, cand, con, bands=bands)
                & accepted & (score > 1e-9) & active[cand.src] & active[cand.dest])
    all_specs = (spec,) + prev
    room, slack = jopt._channel_budgets(all_specs, model, arrays, con,
                                        sides=(inv.upper_min, inv.lower_max))
    keep, _ = jopt.select_batched(
        score, cand, eligible, model, room, slack,
        jopt._topic_budgets(all_specs, model, arrays, con, inv=inv), False, rounds=1,
        subrounds=128, has_swaps=False, frontier=fr,
        compact_k=jopt._lane_bucket(cand.k, fr.full_of_compact.shape[0], 128))
    return cand.replica, cand.dest, eligible, keep


@pytest.mark.parametrize("goal", ["ReplicaDistributionGoal", "DiskUsageDistributionGoal"])
def test_step_on_a_fixed_frontier_matches(goal, monkeypatch):
    clear_cruise_env(monkeypatch)
    monkeypatch.setattr(jopt, "_FRONTIER_DENSE_MIN", 8)
    monkeypatch.setattr(topt, "_FRONTIER_DENSE_MIN", 8)
    jm, tm = skewed_models(7)
    jfr, tfr = _frontier_of(jm)
    ns, nd = topt._frontier_widths(8, tc.default_num_sources(tm), tc.default_num_dests(tm))
    con = BalancingConstraint.default()
    spec, prev = GOAL_SPECS[goal], tuple(GOAL_SPECS[g] for g in PREV)
    options = OptimizationOptions.none(tm)
    jnew, jn, jstats = jax.jit(
        lambda m, o, f: jopt._goal_step(m, o, JAX_SPECS[goal], (JAX_SPECS[PREV[0]],),
                                        JaxBC.default(), ns, nd, frontier=f))(
        jm, JaxOptions.none(jm), jfr)
    tnew, tn, tstats = topt._goal_step(tm, options, spec, prev, con, ns, nd, frontier=tfr)
    assert int(tn) == int(jn) > 0
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(tnew, f).numpy(), np.asarray(getattr(jnew, f)),
                                      err_msg=f)
    # Only active brokers gave or took replicas.
    moved = (tnew.replica_broker != tm.replica_broker).numpy()
    active = tfr.active.numpy()
    assert active[tm.replica_broker.numpy()[moved]].all()
    assert active[tnew.replica_broker.numpy()[moved]].all()
    if goal != "ReplicaDistributionGoal":
        return
    want = [np.asarray(x) for x in jax.jit(_jax_step_parts, static_argnums=(3, 4))(
        jm, JaxOptions.none(jm), jfr, ns, nd)]
    cand, keep, _ = topt._step_select(tm, options, spec, prev, con, ns, nd, frontier=tfr)
    np.testing.assert_array_equal(cand.replica.numpy(), want[0])
    np.testing.assert_array_equal(cand.dest.numpy(), want[1])
    np.testing.assert_array_equal(keep.numpy(), want[3])
    assert want[2].sum() >= keep.sum() > 0


SHORT = ["RackAwareGoal", "ReplicaDistributionGoal"]


def test_settings_that_run_the_per_goal_path():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    kw = dict(fused=True, raise_on_hard_failure=False, device="cpu")
    per_goal = topt.optimize(tm, SHORT, fuse_group_size=1, **kw)
    segmented = topt.optimize(tm, SHORT, segment_steps=1, **kw)
    forced = topt.optimize(tm, SHORT, fuse_group_size=1, frontier=True, **kw)
    grouped = topt.optimize(tm, SHORT, **kw)
    for run in (per_goal, segmented, forced):
        assert any(g.chunks for g in run.goal_results)
    # Below the floor a forced frontier stays dense: the same run.
    for f in PLACEMENT:
        assert torch.equal(getattr(forced.model, f), getattr(per_goal.model, f)), f
    assert all(g.chunks is None for g in grouped.goal_results)
    # One-step segments split a longer fixpoint into several chunks, the
    # later ones speculative follow-ups.
    assert max(len(g.chunks or []) for g in segmented.goal_results) > 1
    assert sum(g.chunks_speculative for g in segmented.goal_results) > 0
    with pytest.raises(ValueError, match="segment_steps"):
        topt.optimize(tm, SHORT, fuse_group_size=2, segment_steps=4, **kw)


HUNDRED = dict(num_brokers=100, num_racks=10, num_topics=4, mean_partitions_per_topic=20.0,
               replication_factor=3, distribution="exponential", seed=3)


@pytest.mark.parametrize("spec_kw,kwargs", [
    (SPEC_6, {"fuse_group_size": 1, "pipeline": True}),
    (HUNDRED, {}),
    (HUNDRED, {"pipeline": None, "frontier": True}),
    (SPEC_6, {"fuse_group_size": 1, "warm_start": "compatible"}),
    (SPEC_6, {"fuse_group_size": 1, "mesh": object()}),
    (SPEC_ENTRY, {"fused": False, "segment_steps": 4}),
    (SPEC_ENTRY, {"fuse_group_size": 2, "frontier": True}),
], ids=["pipeline", "auto-pipelined-100", "auto-pipelined-frontier", "warm_start",
        "mesh", "unfused-segment_steps", "grouped-frontier"])
def test_per_goal_refusals(spec_kw, kwargs, monkeypatch):
    """What the later slices ported runs as the JAX package runs it — the
    pipeline forced, the pipeline by default at 100 brokers (one goal pins
    the policy), a warm start, and ``segment_steps`` on the unfused path
    and ``frontier=True`` on the grouped one, which the JAX package ignores
    — and a mesh that is no ``SearchMesh`` is refused with ``TypeError``."""
    clear_cruise_env(monkeypatch)
    if "mesh" in kwargs:
        tm = generate_cluster(ClusterSpec(**spec_kw), device="cpu")
        with pytest.raises(TypeError, match="SearchMesh"):
            topt.optimize(tm, STACK, fused=True, device="cpu", **kwargs)
        return
    kwargs = dict(kwargs)
    kwargs.setdefault("fused", True)
    warm = kwargs.pop("warm_start", None) is not None
    goals = STACK[:2] if spec_kw is not HUNDRED else ["ReplicaDistributionGoal"]
    runs = check_like_jax(spec_kw, goals, warm=warm, **kwargs)
    assert runs is not None
    assert runs[1].pipelined == ("pipeline" in kwargs or spec_kw is HUNDRED)
    assert runs[1].warm == warm


def test_graph_cache_keeps_frontier_buffers_per_shape_and_bucket():
    """Each (shape, bucket) holds one set of static frontier buffers, written
    only when a chunk dispatches another frontier, keyed into the graph key
    by bucket, and evicted with its shape.  (The buffers live on the
    model's device; a capture needs the card, so no graph is made here.)"""
    from cruise_control_tpu_torch.analyzer import graphs

    cache = graphs.GraphCache()
    models = [generate_cluster(ClusterSpec(**dict(SPEC_6, num_topics=t)), device="cpu")
              for t in range(2, 3 + graphs.MAX_SHAPES)]
    st = cache.state(models[0], OptimizationOptions.none(models[0]))
    active = np.zeros(models[0].num_brokers, bool)
    active[[1, 4]] = True
    fr = topt._build_frontier(active, 2)
    bufs = cache.frontier(st, fr)
    assert cache.frontier(st, fr) is bufs and cache.num_frontiers() == 1
    for f in ("active", "compact_of_full", "full_of_compact"):
        assert torch.equal(getattr(bufs, f), getattr(fr, f)), f
    active[1] = False
    fr2 = topt._build_frontier(active, 2)
    assert cache.frontier(st, fr2) is bufs  # same bucket: the buffers, rewritten
    assert bufs.full_of_compact.tolist() == [4, -1]
    cache.frontier(st, topt._build_frontier(active, 4))
    assert cache.num_frontiers() == 2
    spec = GOAL_SPECS["ReplicaDistributionGoal"]
    assert graphs.goal_key(spec, (), None, 1, 1, st, 2) != graphs.goal_key(spec, (), None,
                                                                             1, 1, st)
    for m in models[1:]:  # MAX_SHAPES newer shapes evict the first with its buffers
        cache.state(m, OptimizationOptions.none(m))
    assert cache.num_frontiers() == 0
