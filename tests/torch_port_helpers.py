"""Shared helpers of the ``test_torch_*`` parity tests: carry models and
candidate batches between the JAX package and the PyTorch port as numpy."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer import proposals as jprops
from cruise_control_tpu.analyzer.verifier import verify_run as jax_verify_run
from cruise_control_tpu.common.sensors import SENSORS as JSENSORS
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.model.tensor_model import TensorClusterModel as JaxModel
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer import proposals as tprops
from cruise_control_tpu_torch.analyzer.verifier import verify_run
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from cruise_control_tpu_torch.analyzer.actions import Candidates as TorchCandidates
from cruise_control_tpu_torch.analyzer.goals.specs import (DEFAULT_GOAL_ORDER,
                                                           INTRA_BROKER_GOAL_ORDER,
                                                           KAFKA_ASSIGNER_GOALS)
from cruise_control_tpu_torch.common.sensors import SENSORS as TSENSORS
from cruise_control_tpu_torch.convert import model_from_numpy, model_to_numpy
from cruise_control_tpu_torch.model.tensor_model import STATIC_FIELDS, TENSOR_FIELDS

STACK = [
    "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
    "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
    "ReplicaDistributionGoal", "PotentialNwOutGoal", "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal", "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
]

# The 6- and 12-broker specs of tests/test_optimizer.py:61,219, the 8-broker
# spec of __graft_entry__.py:22 and bench.py's "small" rung.
SPEC_6 = dict(num_brokers=6, num_racks=3, num_topics=4, mean_partitions_per_topic=10.0,
              replication_factor=2, distribution="exponential", seed=7)
SPEC_12 = dict(num_brokers=12, num_racks=4, num_topics=6, mean_partitions_per_topic=20.0,
               replication_factor=2, distribution="exponential", seed=11)
SPEC_ENTRY = dict(num_brokers=8, num_racks=4, num_topics=3, mean_partitions_per_topic=6.0,
                  replication_factor=2, distribution="exponential", seed=0)
SPEC_SMALL = dict(num_brokers=3, num_racks=3, num_topics=5, mean_partitions_per_topic=20.0,
                  replication_factor=3, distribution="exponential", seed=2026)


def to_torch(model: JaxModel):
    """JAX model -> port model on the CPU."""
    fields = {f: np.asarray(getattr(model, f)) for f in TENSOR_FIELDS}
    static = {s: getattr(model, s) for s in STATIC_FIELDS}
    return model_from_numpy(fields, static, device="cpu")


def to_jax(model) -> JaxModel:
    """Port model -> JAX model."""
    fields, static = model_to_numpy(model)
    return JaxModel(**{f: jnp.asarray(a) for f, a in fields.items()}, **static)


def cand_to_torch(cand) -> TorchCandidates:
    """JAX Candidates -> port Candidates (same field names)."""
    return TorchCandidates(**{f.name: torch.from_numpy(np.array(getattr(cand, f.name)))
                              for f in dataclasses.fields(TorchCandidates)})


def assert_float_close(got, want, what: str, rtol: float = 1e-5) -> None:
    """Floats within ``rtol`` of the largest finite |value| of the reference
    (summation order differs between XLA and PyTorch; infinities must match
    exactly)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    if fin.any():
        scale = max(np.abs(want[fin]).max(), 1e-30)
        err = np.abs(got[fin] - want[fin]).max() / scale
        assert err <= rtol, f"{what}: {err:.3g} of max |value| > {rtol}"


PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def goal_rows(run, width=8):
    """Per goal, the integer packed slots a run reports: steps, actions,
    satisfied before/after, capped, repair steps, bisect depth, lanes live
    (the first ``width`` of them)."""
    return [(g.steps, g.actions_applied, int(g.satisfied_before), int(g.satisfied_after),
             int(g.capped), g.repair_steps, g.bisect_depth, g.lanes_live)[:width]
            for g in run.goal_results]


def check_fused(spec_kw, **kw):
    """The port's ``optimize(fused=True)`` against the JAX package's on the
    same cluster: per goal the same integer packed slots 0-7, and the same
    final placement.  The port's unfused run gives the same placement and
    slots 0-4, and the fused run passes the port's ``verify_run``."""
    jm = jax_generate(JaxSpec(**spec_kw))
    tm = generate_cluster(ClusterSpec(**spec_kw), device="cpu")
    jrun = jopt.optimize(jm, STACK, raise_on_hard_failure=False, fused=True, **kw)
    trun = topt.optimize(tm, STACK, raise_on_hard_failure=False, fused=True, device="cpu",
                         **kw)
    urun = topt.optimize(tm, STACK, raise_on_hard_failure=False, device="cpu",
                         **{k: v for k, v in kw.items() if k != "fuse_group_size"})
    assert [g.name for g in trun.goal_results] == STACK
    assert goal_rows(trun) == goal_rows(jrun)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)
        assert torch.equal(getattr(trun.model, f), getattr(urun.model, f)), f
    assert goal_rows(trun, 5) == goal_rows(urun, 5)
    assert trun.balancedness_after == pytest.approx(jrun.balancedness_after)
    verify_run(tm, trun, STACK, proposals=tprops.diff(tm, trun.model))
    return jm, tm, jrun, trun


def check_packed_matrix(jm, tm):
    """The whole-stack packed i32[PACKED_WIDTH, G] matrix of the port's
    ``_stack_fixpoint`` equals the JAX package's, slot for slot (the JAX
    program is the one ``optimize(fused=True)`` compiled, from its cache)."""
    from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
    from cruise_control_tpu.analyzer.goals.specs import goals_by_priority as jax_goals
    from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions, StepState
    from cruise_control_tpu_torch.analyzer import candidates as tc
    ns, nd = tc.default_num_sources(tm), tc.default_num_dests(tm)
    jfn = jopt._get_stack_fn(tuple(jax_goals(STACK)), JaxBC.default(), ns, nd, 256)
    jmodel, jpacked = jfn(jm, JaxOptions.none(jm))
    st = StepState.working(tm, OptimizationOptions.none(tm))
    tpacked, _ = topt._stack_fixpoint(st, tuple(goals_by_priority(STACK)),
                                      BalancingConstraint.default(), ns, nd, 256)
    np.testing.assert_array_equal(tpacked, np.asarray(jpacked))
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(st.model, f).numpy(),
                                      np.asarray(getattr(jmodel, f)), err_msg=f)


def _run_both(spec_kw):
    jm = jax_generate(JaxSpec(**spec_kw))
    tm = generate_cluster(ClusterSpec(**spec_kw), device="cpu")
    jrun = jopt.optimize(jm, STACK, raise_on_hard_failure=False, fused=False, frontier=False)
    trun = topt.optimize(tm, STACK, raise_on_hard_failure=False, device="cpu")
    return jm, tm, jrun, trun


def check_stack(spec_kw):
    """Equisatisfying per goal, the port's verify_run, and the JAX package's
    verify_run on the port's final placement carried back."""
    jm, tm, jrun, trun = _run_both(spec_kw)
    assert [g.name for g in trun.goal_results] == STACK
    for j, t in zip(jrun.goal_results, trun.goal_results):
        assert (t.satisfied_before, t.satisfied_after) == \
            (j.satisfied_before, j.satisfied_after), t.name
        assert t.is_hard == j.is_hard
    assert trun.balancedness_after == pytest.approx(jrun.balancedness_after)
    proposals = tprops.diff(tm, trun.model)
    verify_run(tm, trun, STACK, proposals=proposals)
    assert proposals

    final = to_jax(trun.model)
    jax_results = [jopt.GoalResult(name=g.name, is_hard=g.is_hard,
                                   satisfied_before=g.satisfied_before,
                                   satisfied_after=g.satisfied_after, steps=g.steps,
                                   actions_applied=g.actions_applied, duration_s=0.0)
                   for g in trun.goal_results]
    carried = jopt.OptimizerRun(model=final, goal_results=jax_results, stats_before=None,
                                stats_after=None, num_candidates_scored=0)
    jax_proposals = jprops.diff(jm, final)
    jax_verify_run(jm, carried, STACK, proposals=jax_proposals)
    assert proposals == [tprops.ExecutionProposal(
        p.partition, p.topic, p.partition_size,
        tprops.ReplicaPlacement(*p.old_leader),
        tuple(tprops.ReplicaPlacement(*x) for x in p.old_replicas),
        tuple(tprops.ReplicaPlacement(*x) for x in p.new_replicas)) for p in jax_proposals]
    return jrun, trun


def check_like_jax(spec_kw, goals, warm: bool = False, constraint=None, **kw):
    """The port's ``optimize(**kw)`` does what the JAX package's does on the
    same call and cluster: it raises the same exception type, or it gives
    the same per-goal packed slots 0-7 and ``pipelined`` flags, the same
    run accounting and the same placement.  With ``warm`` both take a warm
    start from the cluster itself (compatible, no seed mask); ``constraint``
    (a dict) replaces those fields of each package's default
    ``BalancingConstraint``.  Returns the two runs, or None when both
    raised."""
    from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
    from cruise_control_tpu.analyzer.state import WarmStart as JaxWarm
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.state import WarmStart
    jm = jax_generate(JaxSpec(**spec_kw))
    tm = to_torch(jm)
    jkw, tkw = dict(kw), dict(kw)
    if warm:
        jkw["warm_start"], tkw["warm_start"] = JaxWarm(prev_model=jm), WarmStart(prev_model=tm)
    if constraint is not None:
        jkw["constraint"] = dataclasses.replace(JaxBC.default(), **constraint)
        tkw["constraint"] = dataclasses.replace(BalancingConstraint.default(), **constraint)
    try:
        jrun = jopt.optimize(jm, goals, raise_on_hard_failure=False, **jkw)
    except Exception as exc:  # the port must raise the same type
        with pytest.raises(type(exc)):
            topt.optimize(tm, goals, raise_on_hard_failure=False, device="cpu", **tkw)
        return None
    trun = topt.optimize(tm, goals, raise_on_hard_failure=False, device="cpu", **tkw)
    assert goal_rows(trun) == goal_rows(jrun)
    assert [g.pipelined for g in trun.goal_results] == [g.pipelined for g in jrun.goal_results]
    summary = ("pipelined", "warm", "goals_skipped", "goals_overlapped", "goals_fused")
    assert [getattr(trun, k) for k in summary] == [getattr(jrun, k) for k in summary]
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)
    return jrun, trun


# Multi-round selection (``moves_per_broker_step`` above 128) on each fused
# path: a goal with swaps, then one with (topic, broker) budgets.
MULTI_ROUND_GOALS = ["DiskUsageDistributionGoal", "TopicReplicaDistributionGoal"]
MULTI_ROUND_PATHS = {"grouped": {}, "per-goal": {"fuse_group_size": 1},
                     "pipelined": {"pipeline": True}}


def check_multi_round(moves: int, path: str):
    """``optimize(fused=True)`` on the 6-broker cluster with
    ``moves_per_broker_step=moves`` on ``path``: ``check_like_jax`` (per goal
    the same packed slots, so the same satisfied flags, and the same
    placement), and the port's run passes its ``verify_run``."""
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    con = {"moves_per_broker_step": moves}
    jrun, trun = check_like_jax(SPEC_6, MULTI_ROUND_GOALS, constraint=con, fused=True,
                                **MULTI_ROUND_PATHS[path])
    tm = to_torch(jax_generate(JaxSpec(**SPEC_6)))
    verify_run(tm, trun, MULTI_ROUND_GOALS,
               constraint=dataclasses.replace(BalancingConstraint.default(), **con),
               proposals=tprops.diff(tm, trun.model))
    assert sum(g.actions_applied for g in trun.goal_results) > 0
    return jrun, trun


# The JAX package's environment switches.  The port reads CRUISE_PIPELINE,
# CRUISE_PIPELINE_FUSE (the pipeline and its auto-fusion),
# CRUISE_FLIGHT_RECORDER and CRUISE_REPAIR_ORACLE; CRUISE_AOT_PRELOWER and
# CRUISE_TPU_COMPILE_CEILING work around the TPU's remote compiler and are
# not read.  The parity tests clear all six and set the ones they mean.
CRUISE_ENV = ("CRUISE_PIPELINE", "CRUISE_PIPELINE_FUSE", "CRUISE_FLIGHT_RECORDER",
              "CRUISE_AOT_PRELOWER", "CRUISE_REPAIR_ORACLE", "CRUISE_TPU_COMPILE_CEILING")


def clear_cruise_env(monkeypatch) -> None:
    for name in CRUISE_ENV:
        monkeypatch.delenv(name, raising=False)


def skewed_models(seed: int = 7, brokers: int = 16):
    """The skewed model of tests/test_frontier.py:51 (one over-band broker,
    every other broker in band: a small frontier) in both packages."""
    from tests.test_frontier import _skewed_model
    jm = _skewed_model(seed=seed, brokers=brokers)
    return jm, to_torch(jm)


def chunk_keys(info):
    """A frontier driver's chunk records as (steps, actions, bucket, ns,
    nd, speculative)."""
    return [(c["steps"], c["actions"], c["bucket"], c["ns"], c["nd"], c["speculative"])
            for c in info["chunks"]]


def check_per_goal(spec_kw, **kw):
    """The port's sequential per-goal path (``optimize(fused=True,
    fuse_group_size=1)``) against the JAX package's on the same cluster: per
    goal the same integer packed slots 0-7, the same goals skipped by the
    satisfied-sweep, and the same final placement; the run passes the
    port's ``verify_run``."""
    jm = jax_generate(JaxSpec(**spec_kw))
    tm = generate_cluster(ClusterSpec(**spec_kw), device="cpu")
    return compare_per_goal(jm, tm, STACK, fuse_group_size=1, **kw)


def compare_per_goal(jm, tm, stack, verify=True, **kw):
    jskip = jopt.SWEEP_COUNTERS["skipped_goals"]
    jrun = jopt.optimize(jm, stack, raise_on_hard_failure=False, fused=True, **kw)
    jskip = jopt.SWEEP_COUNTERS["skipped_goals"] - jskip
    tskip = topt.SWEEP_COUNTERS["skipped_goals"]
    trun = topt.optimize(tm, stack, raise_on_hard_failure=False, fused=True, device="cpu",
                         **kw)
    tskip = topt.SWEEP_COUNTERS["skipped_goals"] - tskip
    assert [g.name for g in trun.goal_results] == list(stack)
    assert goal_rows(trun) == goal_rows(jrun)
    assert tskip == jskip
    skipped = [g.name for g in trun.goal_results if g.chunks is None]
    assert skipped == [g.name for g in jrun.goal_results if g.chunks is None]
    for t, j in zip(trun.goal_results, jrun.goal_results):
        if j.chunks is not None:
            assert chunk_keys({"chunks": t.chunks}) == chunk_keys({"chunks": j.chunks}), t.name
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)
    if verify:
        verify_run(tm, trun, list(stack), proposals=tprops.diff(tm, trun.model))
    return jrun, trun


# ---------------------------------------------------------------------------
# Goal kinds beyond the default 15-goal stack
# ---------------------------------------------------------------------------

# Topics designated for MinTopicLeadersPerBrokerGoal in the parity tests.
DESIGNATED = (0, 1)


def break_preference(jm, every: int = 1):
    """The second replica leads every ``every``-th partition of RF >= 2
    (tests/test_goals_extended.py:30-41's recipe when ``every`` is 1)."""
    pr = np.asarray(jm.partition_replicas)
    lead = np.asarray(jm.replica_is_leader).copy()
    rows = np.nonzero(pr[:, 1] >= 0)[0][::every]
    lead[pr[rows, 0]] = False
    lead[pr[rows, 1]] = True
    return jm.replace(replica_is_leader=jnp.asarray(lead))


def one_rack(jm, every: int = 3):
    """Every ``every``-th partition moved onto brokers of rack 0 (over the
    ceil(rf / racks) quota of a 2-rack cluster at RF 3)."""
    rb = np.asarray(jm.replica_broker).copy()
    rack = np.asarray(jm.broker_rack)
    pr = np.asarray(jm.partition_replicas)
    on_rack0 = np.nonzero(rack == 0)[0]
    for p in range(0, pr.shape[0], every):
        reps = pr[p][pr[p] >= 0]
        if len(reps) <= len(on_rack0):
            rb[reps] = on_rack0[(p + np.arange(len(reps))) % len(on_rack0)]
    return jm.replace(replica_broker=jnp.asarray(rb), replica_disk=jnp.asarray(rb))


def demoted_brokers(num_brokers: int):
    """Brokers 1, 4, 7, ...: a third of the cluster demoted."""
    return list(range(1, num_brokers, 3))


def goal_kind_case(spec_kw, case: str):
    """``(goals, JAX model, JAX constraint, port constraint, JAX options,
    port options)`` of a parity case on the cluster of ``spec_kw``:
    ``default`` / ``default-designated`` (DEFAULT_GOAL_ORDER, without and
    with designated topics), ``preferred`` (the broken-preference recipe),
    ``demote`` (a third of the brokers DEMOTED with their leadership
    excluded, as the facade's demote_brokers does), ``kafka-assigner`` (the
    two kafka-assigner goals) and ``rack-distribution`` (the cluster on 2
    racks at RF 3, a third of its partitions on one rack)."""
    from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
    from cruise_control_tpu.analyzer.state import OptimizationOptions as JaxOptions
    from cruise_control_tpu.model.tensor_model import BrokerState
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
    jcon, tcon = JaxBC.default(), BalancingConstraint.default()
    goals = {"default": DEFAULT_GOAL_ORDER, "default-designated": DEFAULT_GOAL_ORDER,
             "preferred": ["PreferredLeaderElectionGoal"],
             "demote": ["PreferredLeaderElectionGoal"], "kafka-assigner": KAFKA_ASSIGNER_GOALS,
             "rack-distribution": ["RackAwareDistributionGoal"]}[case]
    if case == "rack-distribution":
        spec_kw = dict(spec_kw, num_racks=2, replication_factor=3)
    jm = jax_generate(JaxSpec(**spec_kw))
    jopts = None
    if case == "default-designated":
        jcon = dataclasses.replace(jcon, min_leader_topic_ids=DESIGNATED)
        tcon = dataclasses.replace(tcon, min_leader_topic_ids=DESIGNATED)
    elif case == "preferred":
        jm = break_preference(jm)
    elif case == "demote":
        mask = np.zeros(jm.num_brokers, bool)
        for b in demoted_brokers(jm.num_brokers):
            jm = jm.set_broker_state(b, BrokerState.DEMOTED)
            mask[b] = True
        jopts = dataclasses.replace(JaxOptions.none(jm),
                                    broker_excluded_leadership=jnp.asarray(mask))
    elif case == "rack-distribution":
        jm = one_rack(jm)
    topts = None
    if jopts is not None:
        tm = to_torch(jm)
        topts = dataclasses.replace(
            OptimizationOptions.none(tm),
            broker_excluded_leadership=torch.from_numpy(
                np.array(jopts.broker_excluded_leadership)))
    return goals, jm, jcon, tcon, jopts, topts


def check_goal_kinds(spec_kw, case: str, path: str):
    """The port's ``optimize(fused=True)`` on the grouped (``path`` =
    "grouped") or the sequential per-goal path ("per-goal",
    ``fuse_group_size=1``) against the JAX package's on the cluster of
    ``goal_kind_case``: per goal the same integer packed slots 0-7 and the
    same placement, and the run passes the port's ``verify_run`` over its
    goals but the hard goals both packages left unsatisfied (the 8-broker
    cluster's topics have fewer partitions than it has brokers, so no
    placement gives every broker a leader of a designated topic there)."""
    goals, jm, jcon, tcon, jopts, topts = goal_kind_case(spec_kw, case)
    tm = to_torch(jm)
    kw = dict(fused=True)
    if path == "per-goal":
        kw["fuse_group_size"] = 1
    jrun = jopt.optimize(jm, goals, constraint=jcon, options=jopts,
                         raise_on_hard_failure=False, **kw)
    trun = topt.optimize(tm, goals, constraint=tcon, options=topts,
                         raise_on_hard_failure=False, device="cpu", **kw)
    assert [g.name for g in trun.goal_results] == list(goals)
    assert goal_rows(trun) == goal_rows(jrun)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)
    held = [(name, g) for name, g in zip(goals, trun.goal_results)
            if not (g.is_hard and not g.satisfied_after)]
    verify_run(tm, dataclasses.replace(trun, goal_results=[g for _, g in held]),
               [name for name, _ in held], constraint=tcon,
               proposals=tprops.diff(tm, trun.model))
    return tm, trun


def movable_leaders_on(model, brokers) -> int:
    """Leaders on ``brokers`` that have a valid, online sibling on an alive,
    non-demoted broker (the facade's ``_movable_leaders_on``)."""
    from cruise_control_tpu_torch.model.tensor_model import BrokerState
    rb = model.replica_broker.cpu().numpy()
    lead = model.replica_is_leader.cpu().numpy()
    valid = model.replica_valid.cpu().numpy()
    part = model.replica_partition.cpu().numpy()
    pr = model.partition_replicas.cpu().numpy()
    state = model.broker_state.cpu().numpy()
    offline = model.replica_offline_now().cpu().numpy()
    count = 0
    for r in np.nonzero(lead & valid & np.isin(rb, list(brokers)))[0]:
        for s in pr[part[r]]:
            if s < 0 or s == r or not valid[s] or offline[s]:
                continue
            if state[rb[s]] not in (BrokerState.DEAD, BrokerState.DEMOTED):
                count += 1
                break
    return count


def check_goal_kind_outcome(case: str, tm, trun) -> None:
    """What each case must achieve, beyond parity with the JAX package."""
    final = trun.model
    moved = not torch.equal(final.replica_broker, tm.replica_broker)
    if case in ("preferred", "demote"):
        assert not moved, "leadership goals move no replica"
    if case == "preferred":
        pr = final.partition_replicas[:, 0]
        assert bool(final.replica_is_leader[pr[pr >= 0].long()].all())
    elif case == "demote":
        assert movable_leaders_on(tm, demoted_brokers(tm.num_brokers)) > 0
        assert movable_leaders_on(final, demoted_brokers(tm.num_brokers)) == 0
    elif case == "kafka-assigner":
        assert int(final.partition_rack_counts().max()) <= 1
    elif case == "rack-distribution":
        assert trun.goal_results[0].satisfied_after
        assert not trun.goal_results[0].satisfied_before


# ---------------------------------------------------------------------------
# The intra-broker disk goals (JBOD)
# ---------------------------------------------------------------------------

# The facade's stack for rebalance_disk=true.
INTRA_GOALS = INTRA_BROKER_GOAL_ORDER
# A goals= request with rebalance_disk=true mixing the intra-broker capacity
# goal with the inter-broker disk goals.
MIXED_DISK_GOALS = ["IntraBrokerDiskCapacityGoal", "DiskCapacityGoal",
                    "DiskUsageDistributionGoal"]


def jbod_model(spec_kw, disks_per_broker: int = 4, dead=(), fullest: float = 0.7):
    """The JAX model of ``spec_kw`` with ``disks_per_broker`` disks a broker
    (the generator puts about half of a broker's replicas on its first
    disk), every disk's and broker's DISK capacity scaled by one factor so
    that the fullest broker's disks sit at ``fullest`` together, and the
    first disk of each broker in ``dead`` dead (capacity -1)."""
    from cruise_control_tpu.common.resources import Resource
    jm = jax_generate(JaxSpec(**dict(spec_kw, disks_per_broker=disks_per_broker)))
    seg = np.asarray(jm.disk_broker)
    load = np.bincount(seg, np.asarray(jm.disk_load(), np.float64), jm.num_brokers)
    cap = np.bincount(seg, np.asarray(jm.disk_capacity, np.float64), jm.num_brokers)
    f = (load / np.maximum(cap, 1e-30)).max() / fullest
    disk_cap = (np.asarray(jm.disk_capacity, np.float64) * f).astype(np.float32)
    broker_cap = np.asarray(jm.broker_capacity).copy()
    broker_cap[:, Resource.DISK] = (broker_cap[:, Resource.DISK].astype(np.float64)
                                    * f).astype(np.float32)
    first = np.asarray(jm.broker_disks)[:, 0]
    for b in dead:
        disk_cap[first[b]] = -1.0
    return jm.replace(disk_capacity=jnp.asarray(disk_cap), broker_capacity=jnp.asarray(broker_cap))


def on_dead_disks(model) -> int:
    """Valid replicas on a dead disk (a port or a JAX model)."""
    rd = np.asarray(model.replica_disk)
    cap = np.asarray(model.disk_capacity)
    valid = np.asarray(model.replica_valid) & (rd >= 0)
    return int((cap[np.maximum(rd, 0)] < 0)[valid].sum())


def check_intra(jm, path: str, goals=INTRA_GOALS, verify: bool = True):
    """The port's ``optimize(fused=True)`` on the grouped (``path`` =
    "grouped") or the sequential per-goal path ("per-goal",
    ``fuse_group_size=1``) against the JAX package's on ``jm``: per goal the
    same integer packed slots 0-7 and the same placement, replicas and
    disks; with ``verify`` the run passes the port's ``verify_run`` (every
    hard goal must hold at the end)."""
    tm = to_torch(jm)
    kw = dict(fused=True)
    if path == "per-goal":
        kw["fuse_group_size"] = 1
    jrun = jopt.optimize(jm, goals, raise_on_hard_failure=False, **kw)
    trun = topt.optimize(tm, goals, raise_on_hard_failure=False, device="cpu", **kw)
    assert [g.name for g in trun.goal_results] == list(goals)
    assert goal_rows(trun) == goal_rows(jrun)
    for f in PLACEMENT:
        np.testing.assert_array_equal(getattr(trun.model, f).numpy(),
                                      np.asarray(getattr(jrun.model, f)), err_msg=f)
    if verify:
        verify_run(tm, trun, list(goals), proposals=tprops.diff(tm, trun.model))
    return tm, trun


# ---------------------------------------------------------------------------
# Monitor and detector twins (tests/test_torch_{monitor,detector}.py).  The
# JAX side uses tests/test_detector.py's own helpers; these build the same
# metadata, monitors and broker histories from the port's classes.
# ---------------------------------------------------------------------------

# The histories of tests/test_device_detector.py:33-45, read by both sides.
from tests.test_device_detector import BORDERLINE, CLEAN, SINGLE_SLOW  # noqa: E402,F401

WINDOW_MS = 300_000


def port_md(num_brokers=4, rf=2, alive=None):
    """Twin of tests/test_detector.py ``make_md`` on the port's metadata."""
    from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, ClusterMetadata,
                                                           PartitionInfo)
    alive = alive if alive is not None else set(range(num_brokers))
    brokers = tuple(BrokerInfo(i, rack=f"r{i % 2}", host=f"h{i}", is_alive=(i in alive))
                    for i in range(num_brokers))
    parts = []
    for t in range(2):
        for p in range(6):
            reps = tuple((t + p + k) % num_brokers for k in range(rf))
            parts.append(PartitionInfo(f"t{t}", p, leader=reps[0], replicas=reps))
    return ClusterMetadata(brokers=brokers, partitions=tuple(parts))


def port_sampled_lm(md, windows=3):
    """Twin of tests/test_detector.py ``sampled_lm``: a port ``LoadMonitor``
    on the CPU fed ``windows + 1`` windows of the synthetic sampler."""
    from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import MetadataClient
    from cruise_control_tpu_torch.monitor.sampling import SyntheticWorkloadSampler
    lm = LoadMonitor(MetadataClient(md), StaticCapacityResolver(),
                     num_partition_windows=windows, partition_window_ms=WINDOW_MS,
                     device="cpu")
    lm.start_up()
    s = SyntheticWorkloadSampler()
    for w in range(windows + 1):
        lm.fetch_once(s, w * WINDOW_MS, w * WINDOW_MS + 1)
    return lm


def port_broker_agg_with_history(values_by_broker, windows=6):
    """Twin of tests/test_detector.py ``broker_agg_with_history``."""
    from cruise_control_tpu_torch.monitor.aggregator import MetricSampleAggregator
    agg = MetricSampleAggregator(windows, WINDOW_MS)
    for w in range(windows):
        for b, series in values_by_broker.items():
            agg.add_sample(b, w * WINDOW_MS + 1, {
                "BROKER_LOG_FLUSH_TIME_MS_999TH": series[w],
                "LEADER_BYTES_IN": 100.0})
    for b in values_by_broker:
        agg.add_sample(b, windows * WINDOW_MS, {"BROKER_LOG_FLUSH_TIME_MS_999TH": 0.0,
                                                "LEADER_BYTES_IN": 100.0})
    return agg


def assert_models_equal(tmodel, jmodel) -> None:
    """Leaf for leaf: every tensor field and static int of a port model
    equal to the JAX package's (integers, masks and loads exactly)."""
    fields, static = model_to_numpy(tmodel)
    for f in TENSOR_FIELDS:
        want = np.asarray(getattr(jmodel, f))
        assert fields[f].dtype == want.dtype, f
        np.testing.assert_array_equal(fields[f], want, err_msg=f)
    assert static == {s: int(getattr(jmodel, s)) for s in STATIC_FIELDS}


def assert_aggregations_equal(tres, jres) -> None:
    """Every field of two ``AggregationResult``s equal (arrays exactly)."""
    from cruise_control_tpu_torch.convert import AGGREGATION_FIELDS, aggregation_to_numpy
    got, want = aggregation_to_numpy(tres), aggregation_to_numpy(jres)
    for f in AGGREGATION_FIELDS:
        if isinstance(want[f], np.ndarray):
            assert got[f].dtype == want[f].dtype, f
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            assert got[f] == want[f], f



# ---------------------------------------------------------------------------
# The JAX package's native library in this worker
# ---------------------------------------------------------------------------

def restore_jax_native(mp: pytest.MonkeyPatch, cache_dir) -> None:
    """Make the JAX package's native path load in this process.  Its loader
    compiles ``cc_native-<digest>.so`` into a shared cache through one fixed
    ``<so>.tmp`` name, so test workers that start on a fresh cache race on
    that file, and the loser pins ``_LIB = None`` for the rest of its
    process (``cruise_control_tpu/native/__init__.py:40-77``); the reference
    then takes its per-sample fallbacks, whose results differ from its
    native ones.  When the library is not available, point
    ``CC_TPU_NATIVE_CACHE`` at ``cache_dir`` (private to this worker),
    reset the loader's state through ``mp`` and load again; then assert
    that it is available (never a skip)."""
    from cruise_control_tpu import native as jnative
    if not jnative.available():
        mp.setenv("CC_TPU_NATIVE_CACHE", str(cache_dir))
        mp.setattr(jnative, "_TRIED", False)
        mp.setattr(jnative, "_LIB", None)
        jnative._load()
    assert jnative.available(), "the JAX package's native library does not load"


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native path, certain for a module's reference runs
    (``restore_jax_native``); the loader's state is put back afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        restore_jax_native(mp, tmp_path_factory.mktemp("cc_native"))
        yield


# ---------------------------------------------------------------------------
# The flight recorder's parity tests
# ---------------------------------------------------------------------------

FLIGHT_STACK = ["RackAwareGoal", "ReplicaDistributionGoal", "DiskUsageDistributionGoal",
                "LeaderReplicaDistributionGoal"]
# The dense, speculating driver shape of tests/test_flight_recorder.py:40.
FLIGHT_DRIVER_KW = dict(num_sources=4, num_dests=1, max_steps=64, chunk_steps=8,
                        min_chunk=1, frontier=False)
FLIGHT_SENSOR_PREFIXES = ("GoalOptimizer.repair-", "GoalOptimizer.actions-per-step",
                          "GoalOptimizer.steps-to-90pct-actions")


def flight_sensor_view(before, after, goals):
    """The repair and flight series a run of ``goals`` pushed: counters and
    histogram counts as deltas, gauges as their new values (series of other
    goals, which earlier tests in the process may have pushed, left out)."""
    out = {}
    labels = tuple(f'goal="{g}"' for g in goals)
    for key, val in after.items():
        if not key.startswith(FLIGHT_SENSOR_PREFIXES) or not any(lb in key for lb in labels):
            continue
        old = before.get(key)
        if isinstance(val, dict):
            base = old or {"count": 0, "buckets": {}}
            out[key] = (val["count"] - base["count"],
                        {b: c - base["buckets"].get(b, 0) for b, c in val["buckets"].items()})
        elif "repair-bisect-depth" in key or "steps-to-90pct" in key:
            out[key] = val
        else:
            out[key] = val - (old or 0)
    return out


def flight_solves(jm, tm, goals, recorder=True, **kw):
    """One optimize in each package under the same switches, with the
    sensors each pushed."""
    with pytest.MonkeyPatch.context() as mp:
        clear_cruise_env(mp)
        if recorder:
            mp.setenv("CRUISE_FLIGHT_RECORDER", "1")
        j0 = JSENSORS.snapshot()
        jrun = jopt.optimize(jm, goals, raise_on_hard_failure=False, fused=True, **kw)
        jsens = flight_sensor_view(j0, JSENSORS.snapshot(), goals)
        t0 = TSENSORS.snapshot()
        trun = topt.optimize(tm, goals, raise_on_hard_failure=False, fused=True,
                             device="cpu", **kw)
        tsens = flight_sensor_view(t0, TSENSORS.snapshot(), goals)
    return jrun, trun, jsens, tsens


def port_flight_run(tm, goals, recorder, **kw):
    with pytest.MonkeyPatch.context() as mp:
        clear_cruise_env(mp)
        if recorder:
            mp.setenv("CRUISE_FLIGHT_RECORDER", "1")
        return topt.optimize(tm, goals, raise_on_hard_failure=False, fused=True,
                             device="cpu", **kw)


def assert_same_placement(a, b):
    for f in PLACEMENT:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


def assert_same_flight(tflight, jflight, what):
    assert jflight is not None and tflight is not None, what
    assert tflight["kinds"] == jflight["kinds"]
    assert tflight["steps"] == jflight["steps"], what
    assert [(c["len"], c["bucket"], c["speculative"]) for c in tflight["chunks"]] == \
        [(c["len"], c["bucket"], c["speculative"]) for c in jflight["chunks"]], what


# ---------------------------------------------------------------------------
# The service front's parity tests
# ---------------------------------------------------------------------------

# tests/test_api.py ``build_stack``'s goals and hard goals.
API_GOALS = ["RackAwareGoal", "DiskCapacityGoal", "ReplicaDistributionGoal",
             "LeaderReplicaDistributionGoal"]
API_HARD = ["RackAwareGoal", "DiskCapacityGoal"]
WAIT = {"max_wait_s": "300"}


def port_build_stack(num_brokers=5, two_step=False, security=None, broker_ids=None):
    """tests/test_api.py ``build_stack`` on the port, on the CPU."""
    from tests.test_api import W
    from cruise_control_tpu_torch.api import server as tserver
    from cruise_control_tpu_torch.api.facade import CruiseControl
    from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
    from cruise_control_tpu_torch.executor.admin import InMemoryClusterAdmin
    from cruise_control_tpu_torch.executor.executor import Executor
    from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, ClusterMetadata,
                                                           MetadataClient, PartitionInfo)
    from cruise_control_tpu_torch.monitor.sampling import SyntheticWorkloadSampler
    rng = np.random.default_rng(19)
    ids = list(broker_ids) if broker_ids else list(range(num_brokers))
    num_brokers = len(ids)
    brokers = tuple(BrokerInfo(b, rack=f"r{i % 3}", host=f"h{i}") for i, b in enumerate(ids))
    w = np.linspace(1, 4, num_brokers)
    w /= w.sum()
    parts = []
    for t in range(3):
        for p in range(8):
            reps = tuple(ids[int(x)] for x in rng.choice(num_brokers, 2, replace=False, p=w))
            parts.append(PartitionInfo(f"t{t}", p, leader=reps[0], replicas=reps))
    mc = MetadataClient(ClusterMetadata(brokers=brokers, partitions=tuple(parts)))
    lm = LoadMonitor(mc, StaticCapacityResolver(), num_partition_windows=3,
                     partition_window_ms=W, device="cpu")
    lm.start_up()
    sampler = SyntheticWorkloadSampler()
    for wdx in range(4):
        lm.fetch_once(sampler, wdx * W, wdx * W + 1)
    admin = InMemoryClusterAdmin(mc, latency_polls=1)
    ex = Executor(admin, mc)
    cc = CruiseControl(lm, ex, admin, goals=API_GOALS, hard_goals=API_HARD, device="cpu")
    mgr = AnomalyDetectorManager(SelfHealingNotifier(), cc,
                                 executor_busy=lambda: ex.has_ongoing_execution)
    api = tserver.CruiseControlApi(cc, detector_manager=mgr, sampler=sampler,
                                   two_step_verification=two_step, security=security)
    return api, cc, mc


def both(**kw):
    """(JAX stack, port stack), each (api, facade, metadata client)."""
    from tests.test_api import build_stack as jax_build_stack
    return jax_build_stack(**kw), port_build_stack(**kw)


def placement(mc):
    return {p.tp: (p.leader, p.replicas) for p in mc.cluster().partitions}


def same_call(stacks, method, endpoint, params, headers=None):
    """The request on both stacks: the same status; returns both bodies."""
    (japi, _, _), (tapi, _, _) = stacks
    args = (method, endpoint, dict(params)) + ((headers,) if headers is not None else ())
    js, jbody, _ = japi.handle(*args)
    ts, tbody, _ = tapi.handle(*args)
    assert ts == js, (endpoint, ts, js, tbody)
    return jbody, tbody


def same_operation(jbody, tbody):
    """Two operation results: the same outcome, proposals and goal verdicts."""
    for key in ("ok", "dryrun", "numProposals", "proposals", "violatedGoalsBefore",
                "violatedGoalsAfter", "provisionStatus", "cappedGoals",
                "onDemandBalancednessScoreBefore", "onDemandBalancednessScoreAfter"):
        assert tbody.get(key) == jbody.get(key), key


# ---------------------------------------------------------------------------
# The running sums of the card's blocked scan, walked in numpy
# ---------------------------------------------------------------------------

def scan_blocks(x):
    """f32[ceil(m / 16), 16, C]: each block of 16 rows of ``x`` (zero-padded)
    scanned in order, as the card's shuffle scans take them (K3 and K9's
    frontier mask)."""
    m, c = x.shape
    blocks = np.zeros((-(-m // 16), 16, c), np.float32)
    blocks.reshape(-1, c)[:m] = x
    for j in range(1, 16):
        blocks[:, j] = blocks[:, j] + blocks[:, j - 1]
    return blocks


def scan_levels(t):
    """The ordered cumsum of the level-1 totals ``t`` (f32[m, C]) by the
    card's steps (ordered.cuh): scan the blocks of 16, take each block's
    total at its last row, scan the totals the same way, add the total of
    the block before."""
    m = t.shape[0]
    blocks = scan_blocks(t)
    out = blocks.reshape(-1, t.shape[1])[:m].copy()
    if m <= 16:
        return out
    last = np.minimum(np.arange(blocks.shape[0]) * 16 + 15, m - 1)
    up = scan_levels(out[last])
    out[16:] = out[16:] + up[np.arange(16, m) // 16 - 1]
    return out
