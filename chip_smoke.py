#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cruise_control_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``); it fails at once without them.

Phases, in order (any failure raises and the process exits non-zero):

1. print the device name and ``nvidia-smi``'s name and power limit;
2. build every kernel from ``cruise_control_tpu_torch/csrc`` (one ``nvcc``
   per source, all started together);
3. mid rung (50 brokers, 10 racks, 40 topics, ~10.2k replicas, seed 2026),
   full 15-goal stack, unfused warm-up run; each kernel's inputs at its
   first launch are captured;
4. each hand-written kernel against its plain PyTorch version on the card,
   on seeded fixtures and on the captured inputs, with timings (CUDA
   events, median of 20), the least time the card could take for the same
   bytes and, where one PyTorch call computes the same function, its time;
5. mid rung as the service runs it, ``optimize(fused=True,
   donate_model=True)``: a warm-up run captures the step graphs, then a
   timed run with the launch counters set to 0 just before: every hard goal
   satisfied, ``verify_run`` passes, every kernel launched (graph replays
   counted), graph captures, replays, gated-off replays and host fetches;
   a second fused run gives identical proposals; the unfused timed run
   gives the same placement; K8 (one replayed step against the same step
   run eagerly) and K12 (the fused driver with its step graphs against the
   same driver with its gated steps run eagerly) are timed and checked;
6. a second snapshot of exactly the mid shape, in which every field but
   the padding masks holds other data (from seed 2027: relabelled brokers,
   partitions, topics and disks, new leaders, loads, capacities, racks and
   hosts, a dead broker) and whose request options exclude a topic and two
   brokers, goes through the cached graphs, with no new capture, and
   equals the eager fused driver on it, placement for placement;
7. profiles of the fused and of the unfused mid run under
   ``torch.profiler``: device ops per step and the device's busy share;
8. large rung (200 brokers, ~100k replicas), the first 7 goals as one
   fused group, the same checks;
9. a 12-broker cluster and the mid rung solved on the card and on the CPU
   plain path: per goal the same satisfied flags;
10. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
    line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --rehearse-cpu`` runs the same phases on the CPU
with the plain PyTorch versions at small sizes, without building, timing on
the card, graphs or launch-count checks (the plain path launches no
kernel), to find faults in this script without a GPU.  It prints no result
line and exits with 3.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

STACK = [
    "RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
    "NetworkInboundCapacityGoal", "NetworkOutboundCapacityGoal", "CpuCapacityGoal",
    "ReplicaDistributionGoal", "PotentialNwOutGoal", "DiskUsageDistributionGoal",
    "NetworkInboundUsageDistributionGoal", "NetworkOutboundUsageDistributionGoal",
    "CpuUsageDistributionGoal", "TopicReplicaDistributionGoal",
    "LeaderReplicaDistributionGoal", "LeaderBytesInDistributionGoal",
]
# (brokers, racks, topics, mean partitions per topic, replication factor):
# the mid and large rungs of bench.py.
MID = (50, 10, 40, 84.0, 3)
LARGE = (200, 20, 100, 333.0, 3)
LARGE_GOALS = STACK[:7]  # the six hard goals and ReplicaDistributionGoal
SEED = 2026
SECOND_SEED = 2027  # the second snapshot of the mid shape (stale-buffer check)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
TIMED_RUNS = 20
K13_RTOL = 1e-6  # of each column's largest |value|: the sums run in another order
SEGSUM_RTOL = 1e-5

# Device kernel names of each wrapper, as the profiler reports them.
PROFILE_NAMES = {
    "broker_aggregates": ("broker_aggregates_kernel",),
    "segment_sum": ("segment_sum_kernel",),
    "best_per_segment": ("segment_max_key", "segment_winner"),
    "prefix_cut": ("prefix_cut_kernel",),
    "goal_masks": ("goal_masks_kernel",),
    "transport_rank": ("transport_rank_kernel",),
    "transport_lookup": ("transport_lookup_kernel",),
    "apply_actions": ("apply_actions_kernel",),
    "cluster_stats": ("cluster_stats_kernel",),
}

KERNELS = {
    # name: (source, JAX function it replaces)
    "broker_aggregates": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                          "cruise_control_tpu/ops/segment.py:22"),
    "segment_sum": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                    "cruise_control_tpu/analyzer/optimizer.py:663"),
    "best_per_segment": ("cruise_control_tpu_torch/csrc/best_per_segment.cu",
                         "cruise_control_tpu/analyzer/optimizer.py:210"),
    "prefix_cut": ("cruise_control_tpu_torch/csrc/prefix_cut.cu",
                   "cruise_control_tpu/analyzer/goals/kernels.py:1031"),
    "goal_masks": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                   "cruise_control_tpu/analyzer/goals/kernels.py:550"),
    "transport_rank": ("cruise_control_tpu_torch/csrc/transport_match.cu",
                       "cruise_control_tpu/analyzer/candidates.py:136"),
    "transport_lookup": ("cruise_control_tpu_torch/csrc/transport_match.cu",
                         "cruise_control_tpu/analyzer/candidates.py:254"),
    "apply_actions": ("cruise_control_tpu_torch/csrc/apply_actions.cu",
                      "cruise_control_tpu/analyzer/actions.py:233"),
    "cluster_stats": ("cruise_control_tpu_torch/csrc/cluster_stats.cu",
                      "cruise_control_tpu/model/stats.py:79"),
}
GRAPH_KERNELS = {
    "step_graph": ("cruise_control_tpu_torch/analyzer/graphs.py",
                   "cruise_control_tpu/analyzer/optimizer.py:1572"),
    "goal_chain": ("cruise_control_tpu_torch/analyzer/graphs.py",
                   "cruise_control_tpu/analyzer/optimizer.py:2491"),
}
PLACEMENT = ("replica_broker", "replica_is_leader", "replica_disk")


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv) -> int:
    import torch
    rehearse = "--rehearse-cpu" in argv
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from cruise_control_tpu_torch.analyzer import graphs
    from cruise_control_tpu_torch.analyzer import optimizer as opt
    from cruise_control_tpu_torch.analyzer import proposals as props
    from cruise_control_tpu_torch.analyzer.verifier import verify_run
    from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
    from cruise_control_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {n: cuda.COUNTED[n] for n in KERNELS}
    dev = torch.device("cpu" if rehearse else "cuda")
    mid_rung, large_rung, timer = MID, LARGE, time_ms
    if rehearse:
        mid_rung, large_rung, timer = (12, 4, 6, 20.0, 2), (16, 4, 8, 20.0, 3), host_time_ms
        torch.cuda.synchronize = lambda: None

    # 1. device
    if rehearse:
        kind, smi = "cpu rehearsal", "cpu rehearsal, no GPU"
    else:
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {smi}")

    # 2. build
    build_s = 0.0 if rehearse else cuda.build_all()
    log(f"build: {build_s:.1f} s for {len(cuda.SOURCES)} sources")
    for name, out in cuda.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def spec_of(rung, seed=SEED):
        b, r, t, ppt, rf = rung
        return ClusterSpec(num_brokers=b, num_racks=r, num_topics=t,
                           mean_partitions_per_topic=ppt, replication_factor=rf,
                           distribution="exponential", seed=seed)

    def read_counts():
        return {n: w.launches for n, w in wrappers.items()}

    def check_launched(label, counts):
        if not rehearse and min(counts.values()) == 0:
            raise RuntimeError(f"a kernel was not launched on the {label} path: {counts}")

    def check_run(label, initial, run, goals):
        for g in run.goal_results:
            log(f"  {label} {g.name:38s} steps={g.steps:3d} actions={g.actions_applied:5d} "
                f"satisfied {g.satisfied_before}->{g.satisfied_after} "
                f"{g.duration_s:.3f}s replays={g.replays} fetches={g.fetches} "
                f"captured={g.fresh_compile}")
        bad = [g.name for g in run.goal_results if g.is_hard and not g.satisfied_after]
        if bad:
            raise RuntimeError(f"{label}: hard goals unsatisfied: {bad}")
        proposals = props.diff(initial, run.model)
        verify_run(initial, run, goals, proposals=proposals)
        return proposals

    def same_placement(a, b):
        return all(torch.equal(getattr(a.model, f).cpu(), getattr(b.model, f).cpu())
                   for f in PLACEMENT)

    def timed(fn):
        cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return out, time.monotonic() - t0, read_counts()

    def fused_run(model, goals=STACK, **kw):
        return opt.optimize(model, goals, fused=True, donate_model=True,
                            raise_on_hard_failure=False, device=dev, **kw)

    def solve_fused(model, cache, options=None):
        return drive_fused(opt, model, STACK, options, cache)

    # 3. mid rung warm-up (unfused), capturing each kernel's first inputs
    mid = generate_cluster(spec_of(mid_rung), device=dev)
    log(f"mid rung: {int(mid.replica_valid.sum())} replicas, {mid.num_brokers} brokers, "
        f"{mid.num_partitions} partitions")
    cuda.CAPTURE = {}
    t0 = time.monotonic()
    run_warm = opt.optimize(mid, STACK, raise_on_hard_failure=False, device=dev)
    torch.cuda.synchronize()
    log(f"mid unfused warm-up run: {time.monotonic() - t0:.2f} s")
    captured, cuda.CAPTURE = cuda.CAPTURE, None
    missing = [n for n in wrappers if n not in captured]
    if missing:
        raise RuntimeError(f"kernels never launched in the warm-up run: {missing}")
    warm_props = check_run("mid-warm", mid, run_warm, STACK)

    # 4. kernels against their plain versions
    results = check_kernels(torch, np, dev, captured, wrappers, log, timer)

    # 5. mid rung as the service runs it: fused, step graphs
    graphs.GRAPHS.clear()
    t0 = time.monotonic()
    run_capture = fused_run(mid)
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    captures = sum(g.fresh_compile for g in run_capture.goal_results)
    log(f"mid fused warm-up run (captures {captures} step graphs): {capture_s:.2f} s")
    run_fused, fused_wall, fused_counts = timed(lambda: fused_run(mid))
    fused_props = check_run("mid-fused", mid, run_fused, STACK)
    fused_steps = sum(g.steps for g in run_fused.goal_results)
    replays = sum(g.replays for g in run_fused.goal_results)
    wasted = replays - fused_steps
    fetches = sum(g.fetches for g in run_fused.goal_results)
    log(f"mid fused timed run: {fused_wall:.3f} s wall, {fused_steps} steps, "
        f"{len(fused_props)} proposals; graphs cached {len(graphs.GRAPHS)}, captured in "
        f"this run {sum(g.fresh_compile for g in run_fused.goal_results)}, replays "
        f"{replays}, gated-off replays {wasted}, host fetches {fetches}")
    log(f"mid fused launches: {fused_counts}")
    check_launched("fused mid", fused_counts)
    run_again = fused_run(mid)
    again_same = props.diff(mid, run_again.model) == fused_props and \
        same_placement(run_again, run_fused)
    log(f"mid fused repeat: identical proposals {again_same}")
    if not again_same:
        raise RuntimeError("two fused mid runs gave different proposals")

    run_mid, mid_wall, mid_counts = timed(
        lambda: opt.optimize(mid, STACK, raise_on_hard_failure=False, device=dev))
    mid_props = check_run("mid", mid, run_mid, STACK)
    mid_steps = sum(g.steps for g in run_mid.goal_results)
    log(f"mid unfused timed run: {mid_wall:.3f} s wall, {mid_steps} steps, "
        f"{len(mid_props)} proposals, identical to warm-up: {mid_props == warm_props}")
    log(f"mid unfused launches: {mid_counts}")
    check_launched("unfused mid", mid_counts)
    if not same_placement(run_mid, run_fused):
        raise RuntimeError("fused and unfused mid runs placed replicas differently")
    log("mid fused vs unfused: identical placement True")

    # K12: the fused driver with its step graphs against the same driver
    # with the gated steps run eagerly (no graph), timed alike.
    cache = None if rehearse else graphs.GRAPHS
    chain, chain_wall, _ = timed(lambda: solve_fused(mid, cache))
    chain_eager, eager_wall, _ = timed(lambda: solve_fused(mid, None))
    if not (same_placement(chain, run_fused) and same_placement(chain_eager, run_fused)):
        raise RuntimeError("the fused mid run with eager gated steps placed replicas "
                           "differently from the graph replays")
    graph_results = check_graphs(torch, opt, graphs, dev, mid, run_fused, chain_wall,
                                 eager_wall, replays, timer, log, rehearse)

    # 6. a second snapshot of the same shape through the cached graphs
    second, second_opts = second_snapshot(torch, np, mid, SECOND_SEED)
    n_graphs = len(graphs.GRAPHS)
    run_second = fused_run(second, options=second_opts)
    run_second_eager = solve_fused(second, None, second_opts)
    fresh = sum(g.fresh_compile for g in run_second.goal_results)
    second_same = same_placement(run_second, run_second_eager)
    log(f"second snapshot (seed {SECOND_SEED}): {sum(g.steps for g in run_second.goal_results)} "
        f"steps, new captures {fresh} (cache {n_graphs} -> {len(graphs.GRAPHS)}); cached "
        f"graphs equal the eager run: {second_same}; differs from the first run: "
        f"{not same_placement(run_second, run_fused)}")
    if not rehearse and (fresh or len(graphs.GRAPHS) != n_graphs):
        raise RuntimeError("the second snapshot did not go through the cached graphs")
    if not second_same:
        raise RuntimeError("cached step graphs replayed a stale snapshot")
    check_run("second", second, run_second, STACK)
    moved_off = int((run_second.model.replica_offline_now()
                     & run_second.model.replica_valid).sum())
    if moved_off:
        raise RuntimeError(f"second snapshot: {moved_off} replicas left on the dead broker")

    # 7. profiles
    if not rehearse:
        prof_fused = profile_mid(torch, lambda: fused_run(mid), fused_wall, fused_steps,
                                 "fused", log)
        prof_unfused = profile_mid(
            torch, lambda: opt.optimize(mid, STACK, raise_on_hard_failure=False,
                                        device=dev), mid_wall, mid_steps, "unfused", log)
        device_ms = {n: (prof_fused["per_launch"][n]
                         if prof_fused["per_launch"][n] is not None
                         else prof_unfused["per_launch"][n]) for n in wrappers}
    else:
        prof_fused = prof_unfused = {"ops": None, "ops_per_step": None, "busy": None}
        device_ms = {n: None for n in wrappers}

    # 8. large rung, first 7 goals as one fused group
    large = generate_cluster(spec_of(large_rung), device=dev)
    log(f"large rung: {int(large.replica_valid.sum())} replicas, {large.num_brokers} brokers")
    fused_run(large, LARGE_GOALS, fuse_group_size=len(LARGE_GOALS))  # captures
    run_large, large_wall, large_counts = timed(
        lambda: fused_run(large, LARGE_GOALS, fuse_group_size=len(LARGE_GOALS)))
    large_props = check_run("large", large, run_large, LARGE_GOALS)
    log(f"large fused run: {large_wall:.3f} s wall, "
        f"{sum(g.steps for g in run_large.goal_results)} steps, "
        f"{sum(g.replays for g in run_large.goal_results)} replays, "
        f"{len(large_props)} proposals")
    log(f"large launches: {large_counts}")
    check_launched("large", large_counts)

    # 9. the card against the CPU plain path: a 12-broker cluster and the mid rung
    small_spec = ClusterSpec(num_brokers=12, num_racks=4, num_topics=6,
                             mean_partitions_per_topic=20.0, replication_factor=2,
                             distribution="exponential", seed=11)
    for label, spec, run_card in (("12-broker", small_spec, None),
                                  ("mid", spec_of(mid_rung), run_mid)):
        if run_card is None:
            run_card = opt.optimize(generate_cluster(spec, device=dev), STACK,
                                    raise_on_hard_failure=False, device=dev)
        run_cpu = opt.optimize(generate_cluster(spec, device="cpu"), STACK,
                               raise_on_hard_failure=False, device="cpu")
        flags_card = [(g.satisfied_before, g.satisfied_after) for g in run_card.goal_results]
        flags_cpu = [(g.satisfied_before, g.satisfied_after) for g in run_cpu.goal_results]
        log(f"{label} card vs CPU plain path: equisatisfying {flags_card == flags_cpu}, "
            f"identical placement {same_placement(run_card, run_cpu)}")
        if flags_card != flags_cpu:
            raise RuntimeError(f"{label}: card and CPU disagree per goal: "
                               f"{flags_card} vs {flags_cpu}")

    # 10. results
    log(f"summary: mid fused wall {fused_wall:.3f} s ({fused_steps} steps, "
        f"{fused_wall / max(fused_steps, 1) * 1e3:.1f} ms/step, {replays} replays, "
        f"{fetches} fetches, ops/step {prof_fused['ops_per_step']}, ops/replay "
        f"{prof_fused['ops'] / replays if prof_fused['ops'] else None}, busy "
        f"{prof_fused['busy']}); mid unfused wall {mid_wall:.3f} s ({mid_steps} steps, "
        f"ops/step {prof_unfused['ops_per_step']}, busy {prof_unfused['busy']}); "
        f"large fused wall {large_wall:.3f} s; card {smi}")
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": fused_counts[name],
                     "launches_unfused": mid_counts[name],
                     "launches_large": large_counts[name],
                     "launches_per_mid_step": fused_counts[name] / max(fused_steps, 1),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": device_ms[name],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": r["library_ms"]})
    # K12's device time is the whole fused solve's (its eager per-goal
    # set-up included), from the fused profile.
    graph_results["goal_chain"]["device_ms_per_launch"] = prof_fused.get("device_ms")
    for name, (source, replaces) in GRAPH_KERNELS.items():
        line.append({"name": name, "route": "cuda_graph", "source": source,
                     "replaces": replaces, **graph_results[name],
                     "bound_by": "bytes", "library_ms": None})
    if rehearse:
        log(json.dumps({"kernels": line}))
        log("rehearsal complete on the CPU: no result line")
        return 3
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def profile_mid(torch, run, wall, steps, label, log):
    """One more run of ``run`` under ``torch.profiler``: device ops per step,
    the device's busy share of the unprofiled ``wall``, the device ops that
    take the most time, and each port kernel's device time per launch."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        prof_wall = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops_per_step = len(kernels) / max(steps, 1)
    busy = device_ms / 1e3 / wall
    log(f"profile {label}: {len(kernels)} device ops ({ops_per_step:.0f} per step), "
        f"{device_ms:.1f} ms device time; busy share {busy:.3f} of the unprofiled "
        f"{wall:.3f} s wall ({prof_wall:.3f} s under the profiler)")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {t:8.2f} ms {n:6d}x  {name[:90]}")
    # Device time per launch of each port kernel (K2 is two device kernels).
    per_launch = {}
    for wrapper, names in PROFILE_NAMES.items():
        hits = [(n, t) for name, (n, t) in by_name.items()
                if any(k in name for k in names)]
        launches = max((n for n, _ in hits), default=0)
        per_launch[wrapper] = (sum(t for _, t in hits) / launches if launches else None)
        log(f"  {label} {wrapper}: device ms per launch {per_launch[wrapper]}")
    return {"per_launch": per_launch, "ops": len(kernels),
            "ops_per_step": round(ops_per_step, 1),
            "busy": round(busy, 4), "device_ms": device_ms}


def drive_fused(opt, model, goals, options, cache):
    """``optimize(fused=True)``'s grouped-stack driver at the defaults the
    timed runs use (whole stack one group, default widths and step budget),
    without the before/after statistics: with ``cache`` the goals' step
    graphs replay, with None the same gated steps run eagerly (no graph)."""
    import contextlib
    import inspect
    import types
    from cruise_control_tpu_torch.analyzer import candidates as cgen
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
    specs = goals_by_priority(goals)
    options = options if options is not None else OptimizationOptions.none(model)
    max_steps = inspect.signature(opt.optimize).parameters["max_steps_per_goal"].default
    with cache.lock if cache is not None else contextlib.nullcontext():
        final, results, _ = opt._optimize_fused(
            model, options, specs, BalancingConstraint.default(),
            cgen.default_num_sources(model), cgen.default_num_dests(model), max_steps,
            len(specs), False, lambda spec: 0, cache)
    return types.SimpleNamespace(model=final, goal_results=results)


# Fields a same-shape snapshot cannot change: the padding masks.
SAME_SHAPE_FIXED = ("replica_valid", "broker_valid", "disk_valid", "partition_valid")
# Options the second snapshot leaves unset: either would leave the hard
# goals no way to heal the dead broker.
OPTIONS_UNSET = ("requested_dest_only", "only_move_immigrants")


def second_snapshot(torch, np, model, seed):
    """A snapshot of exactly ``model``'s shape in which every field but the
    padding masks holds other data, and request options that exclude
    something; returns ``(model, options)``.  From seeded draws: brokers,
    partitions, topics and disks relabelled by permutations; each
    partition's leader chosen anew and its loads scaled by a factor in
    [0.5, 1.5); racks regrouped (consecutive brokers share a rack), hosts
    permuted; each broker's capacities scaled by a factor in [0.75, 1.5);
    one broker dead (its replicas offline); one topic excluded from
    movement, one broker from receiving replicas and another from receiving
    leadership.  Replicas must be partition-major with one replication
    factor, as the generator lays them out."""
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
    from cruise_control_tpu_torch.model.tensor_model import (TENSOR_FIELDS, BrokerState,
                                                             build_model)
    rng = np.random.default_rng(seed)
    h = {f: getattr(model, f).cpu().numpy() for f in TENSOR_FIELDS}
    R = int(h["replica_valid"].sum())
    B, P, T, rf = model.num_brokers, model.num_partitions, model.num_topics, model.max_rf
    part = h["replica_partition"][:R]
    if R != P * rf or not (part == np.repeat(np.arange(P), rf)).all():
        raise RuntimeError("second_snapshot needs partition-major replicas")
    bperm, pperm = rng.permutation(B), rng.permutation(P)
    tperm, dperm = rng.permutation(T), rng.permutation(B)
    leader_slot = rng.integers(0, rf, P)
    scale = rng.uniform(0.5, 1.5, P).astype(np.float32)[part][:, None]
    cap = h["broker_capacity"] * rng.uniform(0.75, 1.5, (B, 1)).astype(np.float32)
    rb = bperm[h["replica_broker"][:R]].astype(np.int32)
    rack_of = (np.arange(B) * model.num_racks // B).astype(np.int32)
    # The excluded topic's replicas stay where they are (but those on the
    # dead broker), so its partitions are placed on distinct racks: a rack
    # conflict there would leave RackAwareGoal unsatisfiable.
    excluded = rng.integers(0, T)
    for p in np.flatnonzero(tperm[h["partition_topic"]] == excluded):
        on = rng.choice(model.num_racks, rf, replace=False)
        rb[p * rf:(p + 1) * rf] = [rng.choice(np.flatnonzero(rack_of == k)) for k in on]
    first_disk = np.argsort(dperm).astype(np.int32)  # disk d belongs to broker dperm[d]
    partition_topic = np.empty(P, np.int32)
    partition_topic[pperm] = tperm[h["partition_topic"]]
    new = build_model(
        replica_broker=rb, replica_partition=pperm[part].astype(np.int32),
        replica_topic=tperm[h["replica_topic"][:R]].astype(np.int32),
        replica_is_leader=(np.arange(R) % rf) == leader_slot[part],
        replica_load_leader=h["replica_load_leader"][:R] * scale,
        replica_load_follower=h["replica_load_follower"][:R] * scale,
        broker_capacity=cap, broker_rack=rack_of,
        broker_host=rng.permutation(h["broker_host"]).astype(np.int32),
        partition_topic=partition_topic, replica_disk=first_disk[rb],
        disk_broker=dperm.astype(np.int32), disk_capacity=cap[dperm, 3].copy(),
        pad_replicas_to=model.num_replicas_padded, device=model.device)
    dead, no_move, no_lead = rng.choice(B, 3, replace=False)
    new = new.set_broker_state(int(dead), BrokerState.DEAD)
    options = OptimizationOptions.none(new)
    options.topic_excluded[int(excluded)] = True
    options.broker_excluded_replica_move[int(no_move)] = True
    options.broker_excluded_leadership[int(no_lead)] = True
    base = OptimizationOptions.none(model)
    same = {f for f in TENSOR_FIELDS if torch.equal(getattr(new, f), getattr(model, f))}
    same |= {f"options.{f.name}" for f in dataclasses.fields(options)
             if torch.equal(getattr(options, f.name), getattr(base, f.name))}
    if same != set(SAME_SHAPE_FIXED) | {f"options.{f}" for f in OPTIONS_UNSET}:
        raise RuntimeError(f"second snapshot: fields left as in the first: {sorted(same)}")
    return new, options


def check_graphs(torch, opt, graphs, dev, mid, run_fused, chain_wall, eager_wall,
                 replays, time_ms, log, rehearse):
    """K8: one replay of a cached step graph against the same gated step run
    eagerly on a copy of the same state (placement and counters equal), and
    both timed with the step gated off (the same kernels run, nothing
    changes); the replay's device time from a profile of replays alone.
    K12: the fused mid driver with its step graphs (``chain_wall``) against
    the same driver with eager gated steps (``eager_wall``).  Bounds: the
    bytes a step must move (read the model's replica and broker rows once,
    write the new placement) over the memory rate; the chain's bound is
    that times its executed steps."""
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N,
                                                         BrokerArrays, OptimizationOptions,
                                                         StepState)
    from cruise_control_tpu_torch.analyzer import candidates as cgen
    specs = goals_by_priority(STACK)
    i = STACK.index("TopicReplicaDistributionGoal")
    spec, prev = specs[i], tuple(specs[:i])
    con = BalancingConstraint.default()
    ns, nd = cgen.default_num_sources(mid), cgen.default_num_dests(mid)
    options = OptimizationOptions.none(mid)
    inv = opt.compute_step_invariants(spec, prev, mid, BrokerArrays.from_model(mid), con)
    eager = StepState.working(mid, options)
    step = lambda st: opt._gated_step(st, inv, spec, prev, con, ns, nd)  # noqa: E731
    cache = graphs.GRAPHS if not rehearse else None
    if cache is not None:
        st = cache.state(mid, options)
        key = graphs.goal_key(spec, prev, con, ns, nd, st)
        g = cache.get(key)
        if g is None:
            raise RuntimeError("the fused mid run left no cached graph for "
                               f"{spec.name}")
        g.load(inv)
    else:
        st = StepState.working(mid, options)
    for state in (st, eager):
        state.counters.zero_()
        state.counters[CTR_LAST_N] = 1
        state.counters[CTR_BUDGET] = 256
    if cache is not None:
        g.replay(1)
    else:
        step(st)
    step(eager)
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(st.model, f), getattr(eager.model, f)) for f in PLACEMENT)
    same = same and torch.equal(st.counters, eager.counters)
    log(f"K8 step graph ({spec.name}): one replay equals the eager gated step: {same}")
    if not same:
        raise RuntimeError("a replayed step graph disagrees with the eager gated step")
    for state in (st, eager):
        state.counters[CTR_LAST_N] = 0
    step_ms = time_ms(torch, (lambda: g.replay(1)) if cache is not None else (lambda: step(st)))
    plain_step_ms = time_ms(torch, lambda: step(eager))
    replay_device_ms = None
    if cache is not None:
        from torch.profiler import ProfilerActivity, profile
        n_prof = 10
        with cache.lock, profile(activities=[ProfilerActivity.CUDA]) as prof:
            g.replay(n_prof)
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if ops:  # else the profiler saw no device op inside the replays
            replay_device_ms = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / n_prof
    R, B = mid.num_replicas_padded, mid.num_brokers
    step_bytes = R * (4 + 4 + 4 + 1 + 32 + 1 + 4 + 1 + 4) + B * 60 + R * 9
    steps = sum(r.steps for r in run_fused.goal_results)
    out = {
        "step_graph": dict(launches=replays, max_abs_err=0.0, ms=step_ms,
                           device_ms_per_launch=replay_device_ms,
                           plain_ms=plain_step_ms, bound_ms=bound_ms(step_bytes)),
        "goal_chain": dict(launches=1, max_abs_err=0.0, ms=chain_wall * 1e3,
                           plain_ms=eager_wall * 1e3,
                           bound_ms=bound_ms(step_bytes * max(steps, 1))),
    }
    log(f"K8 step replay {step_ms:.4f} ms (device {replay_device_ms} ms per replay, "
        f"profiled alone, gated off) vs eager gated step {plain_step_ms:.4f} ms; "
        f"K12 fused mid driver {chain_wall:.3f} s with graphs vs {eager_wall:.3f} s eager")
    return out


# ---------------------------------------------------------------------------
# Phase 4: each kernel against its plain version
# ---------------------------------------------------------------------------

def time_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_time_ms(torch, fn, runs: int = 3) -> float:
    """Host-clock stand-in for ``time_ms`` in the CPU rehearsal."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def check_kernels(torch, np, dev, captured, wrappers, log, time_ms):
    from cruise_control_tpu_torch.analyzer import optimizer as opt
    from cruise_control_tpu_torch.analyzer.actions import (ActionType, Candidates,
                                                           apply_candidates_plain)
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.ops.segment import (broker_aggregates_plain,
                                                      masked_segment_sum)

    rng = np.random.default_rng(SEED)
    out = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- K1: broker aggregates.  Floats within rtol 1e-5 of each column's
    # max |value| (the kernel sums in another order than index_add_);
    # counts exact.
    k1 = wrappers["broker_aggregates"]
    cap = captured["broker_aggregates"]
    R, B = cap[0].shape[0], cap[5]
    fix = (t(rng.integers(0, B, R).astype(np.int32)), t(rng.random(R) < 0.9),
           t(rng.random(R) < 0.33),
           t(rng.exponential(100.0, (R, 4)).astype(np.float32)),
           t(rng.exponential(100.0, (R, 4)).astype(np.float32)), B)
    err = 0.0
    for args in (cap, fix):
        got = k1(*args)
        ref = broker_aggregates_plain(*args)
        for g, r in zip(got, ref):
            if g.dtype == torch.int32:
                if not torch.equal(g, r):
                    raise RuntimeError("K1 counts disagree with the plain version")
            else:
                scale = r.abs().amax(dim=0).clamp(min=1e-30)
                rel = ((g - r).abs() / scale).max().item()
                if rel > 1e-5:
                    raise RuntimeError(f"K1 sums disagree: {rel:.3g} of column max")
                err = max(err, (g - r).abs().max().item())
    rb, valid, lead, ll, lf, _ = cap
    stacked = torch.cat([torch.where(lead[:, None], ll, lf),
                         torch.ones_like(ll[:, :1]), lead[:, None].float(),
                         ll[:, 2:3], torch.where(lead, ll[:, 1], 0.0)[:, None]], 1)
    stacked = torch.where(valid[:, None], stacked, 0.0)
    idx = torch.where(valid, rb, 0)
    acc = torch.zeros((B, 8), device=dev)
    out["broker_aggregates"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: k1(*cap)),
        plain_ms=time_ms(torch, lambda: broker_aggregates_plain(*cap)),
        library_ms=time_ms(torch, lambda: acc.zero_().index_add_(0, idx, stacked)),
        bound_ms=bound_ms(_k1_bytes(valid, lead, B)))
    log(f"K1 broker_aggregates: R={R} B={B} ok, max |err| {err:.3g}")

    # ---- K2: best per segment.  Exact.
    k2 = wrappers["best_per_segment"]
    cap = captured["best_per_segment"]
    K, S = cap[0].shape[0], cap[2]
    Kf, Sf = 32768, 6400
    score = rng.integers(-3, 4, Kf).astype(np.float32)
    score[rng.random(Kf) < 0.02] = np.inf
    score[rng.random(Kf) < 0.02] = -np.inf
    zero = score == 0
    score[zero & (rng.random(Kf) < 0.5)] = -0.0
    fix = (t(score), t(rng.integers(0, Sf, Kf).astype(np.int32)), Sf,
           t(rng.random(Kf) < 0.7))
    for args in (cap, fix):
        if not torch.equal(k2(*args), opt._best_per_segment_plain(*args)):
            raise RuntimeError("K2 disagrees with the plain version")
    out["best_per_segment"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k2(*cap)),
        plain_ms=time_ms(torch, lambda: opt._best_per_segment_plain(*cap)),
        library_ms=None, bound_ms=bound_ms(K * 10))
    log(f"K2 best_per_segment: K={K} S={S} ok (exact)")

    # ---- K3: prefix cut.  Exact, except in segments holding a position
    # whose running total lies within 2 eps of a bound (the kernel's
    # segmented scan rounds differently from the global cumsum).
    k3 = wrappers["prefix_cut"]
    cap = captured["prefix_cut"]
    K, C, S = cap[0].shape[0], cap[2].shape[1], cap[7]

    def k3_fixture(Kf, Sf, Cf):
        seg = rng.choice(np.arange(0, Sf, 2), Kf).astype(np.int32)  # odd: empty
        sc = rng.integers(0, 50, Kf).astype(np.float32)             # ties
        deltas = rng.normal(0.0, 1.0, (Kf, Cf)).astype(np.float32)
        cum = rng.normal(0.0, 2.0, (Sf, Cf)).astype(np.float32)
        lo = (-rng.uniform(5.0, 40.0, (Sf, Cf))).astype(np.float32)
        hi = rng.uniform(5.0, 40.0, (Sf, Cf)).astype(np.float32)
        lo[rng.random((Sf, Cf)) < 0.2] = -np.inf
        hi[rng.random((Sf, Cf)) < 0.2] = np.inf
        cum[rng.random((Sf, Cf)) < 0.05] = 100.0                     # out of band
        return (t(sc), t(seg), t(deltas), t(rng.random(Kf) < 0.8), t(cum), t(lo),
                t(hi), Sf)

    near_total = 0
    for args in (cap, k3_fixture(8192, 64, 8), k3_fixture(8192, 64, 16)):
        got = k3(*args)
        ref = gk.prefix_cut_admit_plain(*args)
        near_seg = _near_bound_segments(torch, gk, *args)
        bad = (got != ref) & ~near_seg[args[1].long()]
        if bad.any():
            raise RuntimeError(f"K3 disagrees at {int(bad.sum())} positions "
                               "away from a band edge")
        near_total += int(near_seg.sum())
    out["prefix_cut"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k3(*cap)),
        plain_ms=time_ms(torch, lambda: gk.prefix_cut_admit_plain(*cap)),
        library_ms=None, bound_ms=bound_ms(K * 10 + int(cap[3].sum()) * 4 * C + S * 12 * C))
    log(f"K3 prefix_cut: K={K} C={C} S={S} ok; segments with a position within "
        f"2 eps of a bound: {near_total}")

    # ---- K7: apply.  Exact.
    k7 = wrappers["apply_actions"]
    model, cand, mask = captured["apply_actions"]
    Kc = cand.k
    fmodel, fcand, fmask = _k7_fixture(torch, np, rng, model, ActionType, Candidates)
    for m, c, k in ((model, cand, mask), (fmodel, fcand, fmask)):
        got = k7(m, c, k)
        ref = apply_candidates_plain(m, c, k)
        for f in ("replica_broker", "replica_disk", "replica_is_leader"):
            if not torch.equal(getattr(got, f), getattr(ref, f)):
                raise RuntimeError(f"K7 disagrees with the plain version on {f}")
    Rm, Bm = model.num_replicas_padded, model.num_brokers
    out["apply_actions"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k7(model, cand, mask)),
        plain_ms=time_ms(torch, lambda: apply_candidates_plain(model, cand, mask)),
        library_ms=None, bound_ms=bound_ms(_k7_bytes(cand, mask, Rm, Bm)))
    log(f"K7 apply_actions: K={Kc} R={Rm} ok (exact)")
    # ---- K1's segment_sum (the selection's round sums).  Within rtol of
    # each column's max |value| of the plain index_add_ (another order), and
    # bit-identical between two launches (no atomics).
    ks = wrappers["segment_sum"]
    cap = captured["segment_sum"]
    N, C, S = cap[0].shape[0], cap[0].shape[1], cap[3]
    fix = (t(rng.normal(0.0, 50.0, (9000, 8)).astype(np.float32)),
           t(rng.integers(0, 64, 9000).astype(np.int32)), t(rng.random(9000) < 0.6), 64)
    err = 0.0
    for args in (cap, fix):
        got, again = ks(*args), ks(*args)
        if not torch.equal(got, again):
            raise RuntimeError("segment_sum differs between two launches")
        ref = masked_segment_sum(args[0], args[1], args[3], args[2])
        scale = ref.abs().amax(dim=0).clamp(min=1e-30)
        rel = ((got - ref).abs() / scale).max().item()
        if rel > SEGSUM_RTOL:
            raise RuntimeError(f"segment_sum disagrees: {rel:.3g} of column max")
        err = max(err, (got - ref).abs().max().item())
    v0, s0, m0 = cap[0], torch.where(cap[2], cap[1], 0), cap[2]
    vz = torch.where(m0[:, None], v0, 0.0)
    acc_s = torch.zeros((S, C), device=dev)
    out["segment_sum"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: ks(*cap)),
        plain_ms=time_ms(torch, lambda: masked_segment_sum(cap[0], cap[1], cap[3], cap[2])),
        library_ms=time_ms(torch, lambda: acc_s.zero_().index_add_(0, s0, vz)),
        bound_ms=bound_ms(N + int(cap[2].sum()) * (4 + 4 * C) + S * 4 * C))
    log(f"K1 segment_sum: N={N} C={C} S={S} ok, deterministic, max |err| {err:.3g}")

    # ---- K5: goal masks.  Exact (score bits and eligible), for every goal
    # of the stack on the captured batch, healthy and with a dead broker.
    k5 = wrappers["goal_masks"]
    spec0, model, arrays, cand, con, bands, accepted = captured["goal_masks"]
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    from cruise_control_tpu_torch.model.tensor_model import BrokerState
    dead = model.set_broker_state(2, BrokerState.DEAD)
    acc_fix = t(rng.random(cand.k) < 0.8)
    modes = set()
    for m in (model, dead):
        arr = BrokerArrays.from_model(m, with_topic_counts=True)
        for spec in goals_by_priority(STACK):
            for acc in (None, acc_fix):
                got = k5(spec, m, arr, cand, con, accepted=acc)
                ref = gk.goal_masks_plain(spec, m, arr, cand, con, accepted=acc)
                if not (torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
                        and torch.equal(got[1], ref[1])):
                    bad = int((got[0] != ref[0]).sum()) + int((got[1] != ref[1]).sum())
                    raise RuntimeError(f"K5 disagrees with the plain version on "
                                       f"{spec.name} ({bad} lanes)")
            modes.add(spec.kind)
    K, R, B = cand.k, model.num_replicas_padded, model.num_brokers
    k5_args = (spec0, model, arrays, cand, con, bands, accepted)
    out["goal_masks"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k5(*k5_args)),
        plain_ms=time_ms(torch, lambda: gk.goal_masks_plain(*k5_args)), library_ms=None,
        bound_ms=bound_ms(_k5_bytes(spec0, model, K, accepted)))
    log(f"K5 goal_masks: K={K} first kind {spec0.kind}; {len(modes)} kinds x healthy/dead "
        "x accepted ok (exact)")

    # ---- K6: transport rank and slot lookup.  Exact.
    from cruise_control_tpu_torch.analyzer import candidates as cgen
    k6r = wrappers["transport_rank"]
    cap = captured["transport_rank"]
    N = cap[1].shape[0]
    key_f = rng.integers(0, 301, 20000).astype(np.int32)
    fix = (t(np.argsort(key_f, kind="stable").astype(np.int64)), t(key_f), 300)
    for args in (cap, fix):
        if not torch.equal(k6r(*args), cgen.transport_rank_plain(*args)):
            raise RuntimeError("K6 rank disagrees with the plain version")
    out["transport_rank"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k6r(*cap)),
        plain_ms=time_ms(torch, lambda: cgen.transport_rank_plain(*cap)),
        library_ms=None, bound_ms=bound_ms(N * 16))
    log(f"K6 transport_rank: N={N} ok (exact)")
    k6l = wrappers["transport_lookup"]
    cap = captured["transport_lookup"]
    L, W, NS = cap[4].shape[0], cap[2], cap[0].shape[0]
    sizes = rng.integers(0, 4, 40 * 96).astype(np.int32)
    fix = (t(np.cumsum(sizes).astype(np.int32)), t(rng.integers(0, 48, 40 * 96).astype(np.int32)),
           96, t(rng.integers(0, 40, 8192).astype(np.int32)),
           t(rng.integers(0, 200, 8192).astype(np.int32)))
    for args in (cap, fix):
        got, ref = k6l(*args), cgen.transport_lookup_plain(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise RuntimeError("K6 lookup disagrees with the plain version")
    out["transport_lookup"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k6l(*cap)),
        plain_ms=time_ms(torch, lambda: cgen.transport_lookup_plain(*cap)),
        library_ms=None, bound_ms=bound_ms(L * 8 + NS * 8 + L * 9))
    log(f"K6 transport_lookup: L={L} width={W} slots={NS} ok (exact)")

    # ---- K13: cluster stats.  Within K13_RTOL of each column's max |value|.
    from cruise_control_tpu_torch.model.stats import column_stats_plain
    k13 = wrappers["cluster_stats"]
    cap = captured["cluster_stats"]
    Bs, Cs = cap[0].shape
    err = 0.0
    for args in (cap, (t(rng.exponential(80.0, (333, 7)).astype(np.float32)),
                       t(rng.random(333) < 0.9)),
                 (cap[0], torch.zeros_like(cap[1]))):
        got, ref = k13(*args), column_stats_plain(*args)
        fin = torch.isfinite(ref)
        if not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin], ref[~fin]):
            raise RuntimeError("K13 disagrees on the empty-mask values")
        scale = torch.where(fin, ref, 0.0).abs().amax(dim=0).clamp(min=1e-30)
        diff = torch.where(fin, got - ref, 0.0).abs()
        if (diff / scale).max().item() > K13_RTOL:
            raise RuntimeError(f"K13 disagrees: {(diff / scale).max().item():.3g}")
        err = max(err, diff.max().item())
    out["cluster_stats"] = dict(
        max_abs_err=err, ms=time_ms(torch, lambda: k13(*cap)),
        plain_ms=time_ms(torch, lambda: column_stats_plain(*cap)), library_ms=None,
        bound_ms=bound_ms(Bs * (4 * Cs + 1) + 16 * Cs))
    log(f"K13 cluster_stats: B={Bs} C={Cs} ok within rtol {K13_RTOL}, max |err| {err:.3g}")

    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
    return out


def _k1_bytes(valid, lead, B):
    """Bytes K1 must move: every replica's valid flag; a valid replica's
    broker id and leader flag, and a leader's load row (16 bytes: its NW_IN
    and NW_OUT are in it) or a follower's row and its leader row's NW_OUT
    (20 bytes); 32 bytes written per broker."""
    leaders = int((valid & lead).sum())
    followers = int((valid & ~lead).sum())
    return valid.numel() + (leaders + followers) * 5 + leaders * 16 + followers * 20 + B * 32


def _k5_bytes(spec, model, K, accepted):
    """Bytes K5 must move for ``spec``'s kind, as its branch of the kernel
    reads them: each lane's action, replica, source and destination (16),
    its valid flag, its accepted flag when a mask is given, its delta (band
    kinds only: 4 bytes for the count, potential NW_OUT and leader-count
    kinds, 8 for the load pairs and leader bytes-in), the score and eligible
    flag written (5); every table of the branch read once, whole: the
    offline flags and alive brokers always, the band's metric and limits,
    the topic counts and limits, or the rack branch's replica partitions,
    brokers, conflict flags, partition rows and broker racks."""
    from cruise_control_tpu_torch.analyzer.goals.kernels import _DELTA_OF_KIND
    R, B = model.num_replicas_padded, model.num_brokers
    lane = 16 + 1 + 5 + (1 if accepted is not None else 0)
    tables = R + B
    if spec.kind == "rack":
        tables += R * (4 + 4 + 1) + model.partition_replicas.numel() * 4 + B * 4
    elif spec.kind == "topic_replica_distribution":
        T = model.num_topics
        tables += R * 4 + T * B * 4 + T * 12
    else:
        lane += 4 if _DELTA_OF_KIND.get(spec.kind, spec.resource) in (4, 5, 6) else 8
        tables += B * 12
    return K * lane + tables


def _k7_bytes(cand, mask, R, B):
    """Bytes K7 must move: every lane's apply flag; an applied lane's kind,
    replica and partner (12) and what its kind reads (a move its
    destination, a swap its source and destination, an intra-broker move
    its destination disk, an intra-broker swap both disks); the first-disk
    table once when a lane moves across brokers; and the placement copied
    (9 bytes a replica read, 9 written)."""
    kind = cand.action_type[mask]
    n = [int((kind == a).sum()) for a in range(5)]  # ActionType order
    lanes = mask.numel() + int(mask.sum()) * 12 + (n[0] + n[2]) * 4 + (n[3] + n[4]) * 8
    return lanes + (B * 4 if n[0] + n[3] else 0) + 2 * R * 9


def _near_bound_segments(torch, gk, score, seg, deltas, kept, cum_before, lo, hi,
                         num_segments):
    """bool[S] — segments holding a position whose float64 running total of
    some channel lies within 2 eps of lo or hi."""
    order = gk._prefix_order(score, seg)
    s_seg = seg[order].long()
    d = torch.where(kept[order][:, None], deltas[order].double(), 0.0)
    cs = torch.cumsum(d, 0)
    K = score.shape[0]
    pos = torch.arange(K, device=score.device)
    start = torch.full((num_segments,), K, device=score.device).scatter_reduce_(
        0, s_seg, pos, "amin")
    base = torch.where((start > 0)[:, None], cs[(start - 1).clamp(min=0)], 0.0)
    prefix = cum_before[s_seg].double() + cs - base[s_seg]
    h, l = hi[s_seg].double(), lo[s_seg].double()
    scale = torch.clamp(torch.maximum(torch.where(torch.isfinite(h), h.abs(), 0.0),
                                      torch.where(torch.isfinite(l), l.abs(), 0.0)),
                        min=1.0)
    eps = 1e-6 * scale
    near = (((prefix - h).abs() <= 2 * eps) | ((prefix - l).abs() <= 2 * eps)).any(1)
    flag = torch.zeros((num_segments,), dtype=torch.bool, device=score.device)
    flag[s_seg[near]] = True
    return flag


def _k7_fixture(torch, np, rng, model, ActionType, Candidates):
    """All five action kinds on distinct replicas, plus masked lanes that
    duplicate applied replicas (they must change nothing)."""
    dev = model.device
    R, B = model.num_replicas_padded, model.num_brokers
    n = min(4096, R // 2)
    perm = rng.permutation(R)[: 2 * n].astype(np.int32)
    r1, r2 = perm[:n], perm[n:]
    kind = rng.integers(0, 5, n).astype(np.int32)
    dest = rng.integers(0, B, n).astype(np.int32)
    rb = model.replica_broker.cpu().numpy()
    rd = model.replica_disk.cpu().numpy()
    lead = model.replica_is_leader.cpu().numpy()
    # The selection's contract for leadership lanes: a leader hands over to
    # a follower.  Other draws become moves.
    kind[(kind == 1) & ~(lead[r1] & ~lead[r2])] = 0
    dest_replica = np.where(np.isin(kind, (1, 3, 4)), r2, -1).astype(np.int32)
    mask = np.ones(n, bool)
    dup = rng.integers(0, n, n // 4)
    kind = np.concatenate([kind, rng.integers(0, 5, dup.size).astype(np.int32)])
    r1 = np.concatenate([r1, r1[dup]])
    dest = np.concatenate([dest, rng.integers(0, B, dup.size).astype(np.int32)])
    dest_replica = np.concatenate([dest_replica, dest_replica[dup]])
    mask = np.concatenate([mask, np.zeros(dup.size, bool)])
    safe2 = np.where(dest_replica >= 0, dest_replica, r1)
    src = rb[r1]
    src_disk = rd[r1]
    dest_disk = np.where(kind == 4, rd[safe2], rng.integers(0, B, kind.size)).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    k = kind.size
    zf = torch.zeros((k, 4), device=dev)
    z = torch.zeros((k,), device=dev)
    zi = torch.zeros((k,), dtype=torch.int32, device=dev)
    cand = Candidates(action_type=t(kind), replica=t(r1), src=t(src.astype(np.int32)),
                      dest=t(dest), dest_replica=t(dest_replica), partition=zi,
                      partition2=zi, valid=t(mask), delta_src=zf, delta_dest=zf,
                      d_replica_count=zi, d_leader_count=zi, d_potential_nw_out=z,
                      d_leader_bytes_in_src=z, d_leader_bytes_in_dest=z,
                      src_disk=t(src_disk.astype(np.int32)), dest_disk=t(dest_disk))
    return model, cand, t(mask)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
