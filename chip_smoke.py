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
   on seeded fixtures and on the captured inputs (K9's sweep, frontier mask
   and batch on the mid rung, the second mid snapshot with its dead broker
   and the large rung; K11 and K11 cross's gate on their case tables; K11
   cross's touched pass on seeded placement changes; K5b on the captured
   batch; the ordered sum of the band averages), with timings (CUDA events,
   median of 20), the least time the card could take for the same bytes
   and, where one PyTorch call computes the same function, its time;
5. mid rung on the grouped stack the service runs below 65 brokers,
   ``optimize(fused=True, donate_model=True)``: a warm-up run captures the
   step graphs, then a timed run with the launch counters set to 0 just
   before: every hard goal satisfied, ``verify_run`` passes, every kernel
   of the path launched (graph replays counted), graph captures, replays,
   gated-off replays and host fetches; a second fused run gives identical
   proposals; the unfused timed run gives the same placement; K8 (one
   replayed step against the same step run eagerly) and K12 (the fused
   driver with its step graphs against the same driver with its gated steps
   run eagerly) are timed and checked;
6. a second snapshot of exactly the mid shape, in which every field but
   the padding masks holds other data (from seed 2027: relabelled brokers,
   partitions, topics and disks, new leaders, loads, capacities, racks and
   hosts, a dead broker) and whose request options exclude a topic and two
   brokers, goes through the cached graphs, with no new capture, and
   equals the eager fused driver on it, placement for placement;
7. profiles of the fused and of the unfused mid run under
   ``torch.profiler``: device ops per step and the device's busy share;
8. large rung (200 brokers, ~100k replicas), the full stack on the
   sequential per-goal path, ``optimize(fused=True, pipeline=False,
   donate_model=True)``: warm-up (captures), a timed run with the counters
   set to 0 just before — every hard goal satisfied, ``verify_run``, every
   kernel of the path launched, at least one chunk compacted and one
   speculative follow-up — per goal its chunks, buckets, replays (gated
   off), follow-ups (wasted), host fetches and wall; a repeat gives
   identical proposals; a profile gives the busy share and ops per step;
   every frontier mask the warm-up computed is held against the plain
   version;
9. large rung, the service's call: the full stack through
   ``optimize(fused=True, donate_model=True)`` with no ``pipeline``
   argument — the inter-goal pipeline: warm-up, then a timed run with the
   counters set to 0 just before — every hard goal satisfied,
   ``verify_run``, every kernel of the path launched (K9 batch and K11
   cross included), at least one opener dispatched; per goal whether it
   adopted an opener, its boundary gap, openers dispatched and wasted,
   their replays (gated off), fused group, chunks, replays and wall; a
   repeat gives identical proposals; a profile; the sequential and the
   pipelined walls timed in turns in this call (and the pipeline with one
   gated step queued behind each opener), and whether their placements
   agree;
10. the skewed 16-broker model (tests/test_pipeline.py's recipe), dense
    floor 8, fusion off: pipelined equals sequential in placement and per
    goal steps and actions, with a goal boundary overlapped, and the card
    equals the CPU plain path;
11. a second large snapshot (the same changes as phase 6) through the
    cached per-goal graphs and frontier buffers, with no new capture, equal
    to the eager per-goal driver, and the same on the pipelined path
    against the eager pipelined driver (stale-buffer checks);
12. a 12-broker cluster and the mid rung (unfused), and a 100-broker
    cluster on the sequential per-goal path and on the default pipelined
    path, solved on the card and on the CPU plain path: per goal the same
    flags (and for the 100-broker cluster the same steps, actions,
    ``pipelined`` and fused group, and placement);
13. warm starts: at the large rung a cold default solve, a load-only
    change of a few partitions, ``model_delta``, and the warm solve —
    ``warm``, ``verify_run``, the hard goals, at least as many goals
    skipped as the cold solve of the changed snapshot, the seed's size and
    whether a first chunk ran compacted on it; at 100 brokers the same
    warm solve on the card and on the CPU agree per goal and in placement;
14. execution (``bench.py --execute`` in the port): the mid rung's fused
    solve of ``donation_copy(mid)`` (the cached step graphs, after other
    shapes': the proposals of phase 5), its proposals and bench.py's throttle
    rule, ``run_simulated_execution`` with the balancedness scorer, the
    launch counters set to 0 just before: the result ok with no dead or
    aborted task, the ledger's totals reconciled, off-target bytes never
    growing and ending at 0, the first and last scores equal to the run's
    balancedness before and after within 1e-6, K10 launched once per
    ``score_checkpoints`` flush; the same proposals on the CPU path give
    the same result and checkpoints (scores within 1e-9); the host wall,
    the wall inside ``score_checkpoints``, flushes and checkpoints.  K10's
    two launches are held exactly against their plain twins on 256 blends
    of the mid solve (here), of the large pipelined solve (phase 9) and of
    the xl250 solve (phase 15), and timed;
15. xl250 rung (1000 brokers, ~250k replicas, ``segment_steps`` 32 by the
    JAX package's rule) on the default pipelined path, the stack of
    ``XL_GOALS``; then the mid fused solve again (the graph cache past its
    four shapes): the proposals of phase 5;
16. the goal kinds beyond the 15-goal stack (``check_goal_kinds``), each
    timed run with the launch counters set to 0 just before and each new
    mode's own counter read after it: the facade's default order
    (``DEFAULT_GOAL_ORDER``, MinTopicLeadersPerBrokerGoal second) with the
    rung's four topics of the most partitions designated — mid on the
    grouped path, card against CPU; large on the sequential and on the
    pipelined path, placements equal, walls, per-goal rows, openers and
    busy share — and with none designated (K3's topic cuts still run: the
    mid window of goals before the topic goal, and large pipelined); the
    demote path at large (every tenth broker DEMOTED, its leadership
    excluded, PreferredLeaderElectionGoal: no movable leader left on a
    demoted broker, no replica moved) and the broken-preference recipe
    (every preferred replica leads after); the kafka-assigner pair at mid
    (at most one replica of a partition a rack) and RackAwareDistributionGoal
    on a 50-broker, 2-rack, RF-3 cluster with a third of its partitions on
    one rack, each card against CPU; the default order with designated
    topics at 100 brokers, pipelined, card against CPU; the ledgers of
    executing the mid default-order solve, a mid demote and the 2-rack
    solve (K10 scoring the new kinds); and K5's, K5b's and K9's new modes
    against their plain twins on the inputs the runs gave them, healthy and
    with a dead broker, exactly, each timed;
17. the intra-broker disk path (``check_jbod``, JBOD: the mid rung with 4
    disks a broker, every DISK capacity scaled so that the fullest broker
    sits at 70 %): ``INTRA_BROKER_GOAL_ORDER`` on the grouped path, card
    against CPU, replica brokers unchanged and ``verify_run`` — healthy and
    with the first disk of brokers 0, 10, 20, 30 and 40 dead (no replica
    left on a dead disk); the mixed stack IntraBrokerDiskCapacityGoal,
    DiskCapacityGoal, DiskUsageDistributionGoal (the disk veto on
    inter-broker moves), card against CPU; the large rung with 4 disks a
    broker on the pipelined and the sequential path, timed in turns,
    placed alike, with its busy share; the mid solve's proposals executed
    (the intra-broker phase), the ledger scored by K10's disk kinds, card
    against CPU; K5's mode 7, K5b's disk veto, K9's kinds 12-13 and
    ``segment_sum``'s disk modes against their plain twins on the inputs
    of the healthy and the dead-disk runs, exactly, each timed; K10's disk
    loads and disk kinds against their twins on 256 blends at mid (healthy
    and dead disks), large and xl250 with 4 disks a broker, timed;
18. from metric samples to anomalies (``check_detection``; its kernels,
    K14's peer and row passes, are held against their plain versions with
    phase 4's, ``check_k14``: bit for bit on seeded histories at 7,000
    brokers and 20 windows — rows with no valid history, one valid window,
    an invalid latest window; again with no valid latest window — and on
    tests/test_device_detector.py's three fixtures, timed beside the plain
    versions and ``torch.nanquantile``): the xl250
    rung's placement as cluster metadata, six windows of the synthetic
    sampler into a ``LoadMonitor`` on the card (flush times and bytes-in
    added to its broker history, an excursion on brokers 3, 17 and 501 in
    the latest window), its model equal field for field to its CPU build;
    one tick of every detector through the manager with the counters set to
    0 just before (``CRUISE_DETECTOR_ORACLE=1``): K14 launched once for both
    finder families, flagging exactly the slow brokers, K9's sweep once for
    the 15 detection goals, the violated goals healed by a stand-in context
    whose ``rebalance`` solves the monitor's model (``verify_run``, hard
    goals, every kernel of the pipelined path launched); then brokers 0, 10,
    ..., 90 die: the broker-failure detector reports them, the notifier
    waits out its alert threshold, the goal-violation detector defers on
    K9's offline flag with the balancedness score pinned;
19. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
    line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --rehearse-cpu`` runs the same phases on the CPU
with the plain PyTorch versions at small sizes, without building, timing on
the card, graphs or launch-count checks (the plain path launches no
kernel), to find faults in this script without a GPU.  It prints no result
line and exits with 3.
"""

from __future__ import annotations

import dataclasses
import functools
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
# the mid, large and xl250 rungs of bench.py, and the 100-broker cluster of
# the card-against-CPU check.
MID = (50, 10, 40, 84.0, 3)
LARGE = (200, 20, 100, 333.0, 3)
XL250 = (1000, 40, 200, 417.0, 3)
HUNDRED = (100, 10, 40, 84.0, 3)
XL_GOALS = STACK  # the full stack: the whole script stays well inside its limit
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
    "prefix_cut": ("prefix_cut_kernel", "scan_blocks_kernel", "block_totals_kernel",
                   "add_back_kernel"),
    "goal_masks": ("goal_masks_kernel",),
    "transport_rank": ("transport_rank_kernel",),
    "transport_lookup": ("transport_lookup_kernel",),
    "apply_actions": ("apply_actions_kernel",),
    "cluster_stats": ("cluster_stats_kernel",),
    "structural_accepts": ("structural_accepts_kernel",),
    "stack_sweep": ("stack_sweep_kernel",),
    "frontier_active": ("frontier_active_kernel",),
    "frontier_active_batch": ("frontier_active_batch_kernel",),
    "chunk_gate": ("chunk_gate_kernel",),
    "cross_gate": ("cross_gate_kernel",),
    "chunk_touched": ("chunk_touched_kernel",),
    "ordered_sum": ("ordered_sum_kernel",),
    "blend_aggregates": ("blend_aggregates_kernel",),
    "stack_sweep_batch": ("stack_sweep_batch_kernel",),
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
    "structural_accepts": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                           "cruise_control_tpu/analyzer/goals/kernels.py:464"),
    "stack_sweep": ("cruise_control_tpu_torch/csrc/stack_sweep.cu",
                    "cruise_control_tpu/analyzer/optimizer.py:2332"),
    "frontier_active": ("cruise_control_tpu_torch/csrc/frontier_active.cu",
                        "cruise_control_tpu/analyzer/goals/kernels.py:842"),
    "frontier_active_batch": ("cruise_control_tpu_torch/csrc/frontier_active.cu",
                              "cruise_control_tpu/analyzer/goals/kernels.py:912"),
    "chunk_gate": ("cruise_control_tpu_torch/csrc/chunk_gate.cu",
                   "cruise_control_tpu/analyzer/optimizer.py:1489"),
    "cross_gate": ("cruise_control_tpu_torch/csrc/chunk_gate.cu",
                   "cruise_control_tpu/analyzer/optimizer.py:1514"),
    "chunk_touched": ("cruise_control_tpu_torch/csrc/chunk_gate.cu",
                      "cruise_control_tpu/analyzer/optimizer.py:1671"),
    "ordered_sum": ("cruise_control_tpu_torch/csrc/ordered.cu",
                    "cruise_control_tpu/analyzer/goals/kernels.py:190"),
    "blend_aggregates": ("cruise_control_tpu_torch/csrc/placement_score.cu",
                         "cruise_control_tpu/analyzer/optimizer.py:2392"),
    "stack_sweep_batch": ("cruise_control_tpu_torch/csrc/placement_score.cu",
                          "cruise_control_tpu/analyzer/optimizer.py:2392"),
}
# Kernels a path does not launch: the unfused path has no chunk gate and no
# frontier count; only the pipelined path sweeps every goal's frontier (K9
# batch) and queues the next goal's openers (K11 cross).
PIPELINE_ONLY = ("frontier_active_batch", "cross_gate", "chunk_touched")
NOT_ON = {"unfused": ("chunk_gate", "frontier_active") + PIPELINE_ONLY,
          "grouped": PIPELINE_ONLY, "sequential": PIPELINE_ONLY}
# K10 scores the checkpoints of an execution: no solve launches it.
EXECUTION_ONLY = ("blend_aggregates", "stack_sweep_batch")
K10_BATCH = 256  # checkpoints per K10 check: the mid execution's 187 pad to 256
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
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.verifier import verify_run
    from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
    from cruise_control_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {n: cuda.COUNTED[n] for n in KERNELS}
    dev = torch.device("cpu" if rehearse else "cuda")
    mid_rung, large_rung, hundred_rung, xl_rung = MID, LARGE, HUNDRED, XL250
    two_racks_rung = TWO_RACKS
    timer = time_ms
    # The per-goal path as the service asks for it above 64 brokers.
    per_goal = dict(pipeline=False)
    if rehearse:
        mid_rung, large_rung, timer = (12, 4, 6, 20.0, 2), (16, 4, 8, 20.0, 3), host_time_ms
        hundred_rung, xl_rung = (16, 4, 5, 30.0, 2), (20, 4, 6, 20.0, 2)
        two_racks_rung = (12, 2, 6, 20.0, 3)
        # Small clusters: ask for the per-goal path (below 100 brokers
        # pipeline=False alone keeps the grouped stack); phase 8 lowers the
        # dense floor so that its chunks compact.
        per_goal = dict(pipeline=False, fuse_group_size=1)
        torch.cuda.synchronize = lambda: None
    t_start = time.monotonic()

    def phase(name):
        log(f"--- {name} ({time.monotonic() - t_start:.1f} s)")

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

    def check_launched(label, counts, path=None):
        skip = NOT_ON.get(path, ()) + EXECUTION_ONLY + tuple(DETECTION_KERNELS)
        idle = [n for n, c in counts.items() if c == 0 and n not in skip]
        if not rehearse and idle:
            raise RuntimeError(f"kernels not launched on the {label} path: {idle}; {counts}")

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
    phase("mid warm-up")
    mid = generate_cluster(spec_of(mid_rung), device=dev)
    log(f"mid rung: {int(mid.replica_valid.sum())} replicas, {mid.num_brokers} brokers, "
        f"{mid.num_partitions} partitions")
    cuda.CAPTURE = {}
    t0 = time.monotonic()
    run_warm = opt.optimize(mid, STACK, raise_on_hard_failure=False, device=dev)
    torch.cuda.synchronize()
    log(f"mid unfused warm-up run: {time.monotonic() - t0:.2f} s")
    captured, cuda.CAPTURE = cuda.CAPTURE, None
    missing = [n for n in wrappers
               if n not in captured and n not in NOT_ON["unfused"] + EXECUTION_ONLY]
    if missing:
        raise RuntimeError(f"kernels never launched in the warm-up run: {missing}")
    warm_props = check_run("mid-warm", mid, run_warm, STACK)

    # 4. kernels against their plain versions
    phase("kernels")
    second, second_opts = second_snapshot(torch, np, mid, SECOND_SEED)
    large = generate_cluster(spec_of(large_rung), device=dev)
    results = check_kernels(torch, np, dev, captured, wrappers, log, timer)
    results.update(check_frontier_kernels(torch, np, captured, wrappers, log, timer,
                                          {"mid": mid, "second": second, "large": large}))
    results.update(check_pipeline_kernels(torch, np, wrappers, log, timer,
                                          {"mid": mid, "second": second, "large": large}))
    # K14 (phase 18's kernels) here, where the profiler reads device times
    # reliably: late in the script its sessions now and then record no op.
    import types
    k14_rows = check_k14(types.SimpleNamespace(torch=torch, np=np, log=log, dev=dev,
                                               rehearse=rehearse, timer=timer))

    # 5. mid rung as the service runs it: fused, step graphs
    phase("mid fused")
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
    check_launched("fused mid", fused_counts, "grouped")
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
    check_launched("unfused mid", mid_counts, "unfused")
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
    phase("mid second snapshot")
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
    phase("mid profiles")
    if not rehearse:
        prof_fused = profile_mid(torch, lambda: fused_run(mid), fused_wall, fused_steps,
                                 "fused", log)
        prof_unfused = profile_mid(
            torch, lambda: opt.optimize(mid, STACK, raise_on_hard_failure=False,
                                        device=dev), mid_wall, mid_steps, "unfused", log)
    else:
        prof_fused = prof_unfused = {"ops": None, "ops_per_step": None, "busy": None,
                                     "per_launch": {n: None for n in wrappers}}

    # 8. large rung, the full stack on the sequential per-goal path
    phase("large per-goal")
    if rehearse:
        opt._FRONTIER_DENSE_MIN = 8
    log(f"large rung: {int(large.replica_valid.sum())} replicas, {large.num_brokers} brokers")
    torch.cuda.synchronize()
    mem0 = (0, 0) if rehearse else (torch.cuda.memory_allocated(),
                                    torch.cuda.memory_reserved())
    n_graphs0 = len(graphs.GRAPHS)
    # Every frontier mask the warm-up computes, by its inputs (the broker
    # rows ``frontier_inputs`` hands to K9's frontier mask).
    frontier_inputs = []
    real_inputs = gk.frontier_inputs

    def recording_inputs(*args):
        out = real_inputs(*args)
        frontier_inputs.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in out))
        return out

    gk.frontier_inputs = recording_inputs
    try:
        t0 = time.monotonic()
        run_large_warm = fused_run(large, **per_goal)  # captures
        torch.cuda.synchronize()
        large_warm_s = time.monotonic() - t0
    finally:
        gk.frontier_inputs = real_inputs
    mem1 = (0, 0) if rehearse else (torch.cuda.memory_allocated(),
                                    torch.cuda.memory_reserved())
    large_captures = sum(g.fresh_compile for g in run_large_warm.goal_results)
    log(f"large per-goal warm-up run: {large_warm_s:.2f} s, {large_captures} goals "
        f"captured graphs, graphs cached {n_graphs0} -> {len(graphs.GRAPHS)}, frontier "
        f"buffer sets {graphs.GRAPHS.num_frontiers()}; device memory allocated "
        f"+{(mem1[0] - mem0[0]) / 2**20:.1f} MiB, reserved +{(mem1[1] - mem0[1]) / 2**20:.1f} "
        f"MiB")
    sweeps0 = dict(opt.SWEEP_COUNTERS)
    fetch0 = dict(opt.FETCH_COUNTERS)
    run_large, large_wall, large_counts = timed(lambda: fused_run(large, **per_goal))
    sweeps = {k: opt.SWEEP_COUNTERS[k] - sweeps0[k] for k in sweeps0}
    fetch_c = {k: opt.FETCH_COUNTERS[k] - fetch0[k] for k in fetch0}
    large_props = check_run("large", large, run_large, STACK)
    large_summary = per_goal_report(run_large, log, "large")
    log(f"large per-goal timed run: {large_wall:.3f} s wall, {large_summary}, "
        f"{len(large_props)} proposals; sweeps {sweeps}; fetch counters {fetch_c}")
    log(f"large launches: {large_counts}")
    check_launched("large per-goal", large_counts, "sequential")
    if not rehearse and not (large_summary["compacted_chunks"] > 0
                             and large_summary["speculative"] > 0):
        raise RuntimeError("the large per-goal run neither compacted nor speculated: "
                           f"{large_summary}")
    run_large_again = fused_run(large, **per_goal)
    large_again = props.diff(large, run_large_again.model) == large_props and \
        same_placement(run_large_again, run_large)
    log(f"large per-goal repeat: identical proposals {large_again}")
    if not large_again:
        raise RuntimeError("two large per-goal runs gave different proposals")
    large_steps = large_summary["steps"]
    if not rehearse:
        prof_large = profile_mid(torch, lambda: fused_run(large, **per_goal), large_wall,
                                 large_steps, "large-per-goal", log)
    else:
        prof_large = {"ops": None, "ops_per_step": None, "busy": None,
                      "per_launch": {n: None for n in wrappers}}
    frontier_checked = check_recorded_frontiers(torch, gk, frontier_inputs, log)

    # 9. large rung, the service's call: the inter-goal pipeline
    phase("large pipelined")
    n_graphs0 = len(graphs.GRAPHS)
    t0 = time.monotonic()
    run_pipe_warm = fused_run(large)  # captures what the sequential run did not
    torch.cuda.synchronize()
    log(f"large pipelined warm-up run: {time.monotonic() - t0:.2f} s, "
        f"{sum(g.fresh_compile for g in run_pipe_warm.goal_results)} goals captured "
        f"graphs, graphs cached {n_graphs0} -> {len(graphs.GRAPHS)}")
    sweeps0 = dict(opt.SWEEP_COUNTERS)
    fetch0 = dict(opt.FETCH_COUNTERS)
    run_pipe, pipe_wall, pipe_counts = timed(lambda: fused_run(large))
    sweeps = {k: opt.SWEEP_COUNTERS[k] - sweeps0[k] for k in sweeps0}
    fetch_c = {k: opt.FETCH_COUNTERS[k] - fetch0[k] for k in fetch0}
    pipe_props = check_run("large-pipelined", large, run_pipe, STACK)
    pipe_summary = pipeline_report(run_pipe, log, "large-pipelined")
    log(f"large pipelined timed run: {pipe_wall:.3f} s wall, pipelined {run_pipe.pipelined}, "
        f"goals overlapped {run_pipe.goals_overlapped}, fused {run_pipe.goals_fused}, "
        f"skipped {run_pipe.goals_skipped}; {pipe_summary}; {len(pipe_props)} proposals; "
        f"sweeps {sweeps}; fetch counters {fetch_c}")
    log(f"large pipelined launches: {pipe_counts}")
    check_launched("large pipelined", pipe_counts)
    if not run_pipe.pipelined or pipe_summary["openers"] < 1:
        raise RuntimeError(f"the large service call dispatched no opener: {pipe_summary}")
    run_pipe_again = fused_run(large)
    pipe_again = props.diff(large, run_pipe_again.model) == pipe_props and \
        same_placement(run_pipe_again, run_pipe)
    log(f"large pipelined repeat: identical proposals {pipe_again}")
    if not pipe_again:
        raise RuntimeError("two large pipelined runs gave different proposals")
    pipe_steps = pipe_summary["steps"]
    if not rehearse:
        prof_pipe = profile_mid(torch, lambda: fused_run(large), pipe_wall, pipe_steps,
                                "large-pipelined", log)
    else:
        prof_pipe = {"ops": None, "ops_per_step": None, "busy": None,
                     "per_launch": {n: None for n in wrappers}}
    # The sequential and the pipelined walls in turns, in this call, and the
    # pipeline with one gated step queued behind each opener
    # (opt.OPENER_QUEUE = 1) beside its default.
    walls = {"sequential": [], "pipelined": [], "opener step queued": []}
    queue = opt.OPENER_QUEUE
    try:
        for label in ("sequential", "pipelined", "opener step queued") * 2 + \
                ("opener step queued", "pipelined", "sequential") * 2:
            opt.OPENER_QUEUE = 1 if label == "opener step queued" else queue
            kw = per_goal if label == "sequential" else {}
            out, wall, _ = timed(lambda: fused_run(large, **kw))
            walls[label].append(wall)
            if not same_placement(out, run_large):
                raise RuntimeError(f"the large {label} run placed replicas differently")
    finally:
        opt.OPENER_QUEUE = queue
    rows_agree = [(g.steps, g.actions_applied) for g in run_pipe.goal_results] == \
        [(g.steps, g.actions_applied) for g in run_large.goal_results]
    log(f"large walls in turns: " + "; ".join(
        f"{label} median {statistics.median(w):.4f} s {[round(x, 4) for x in w]}"
        for label, w in walls.items()) + f"; placements agree "
        f"{same_placement(run_pipe, run_large)}, per-goal steps and actions agree "
        f"{rows_agree}")
    # K10 on blends of the large rung and its pipelined solve.
    k10 = {"large": check_placement_kernels(torch, np, wrappers, log, timer, large,
                                            run_pipe.model, "large", rehearse)}

    # 10. the skewed 16-broker model on the pipelined path, card and CPU
    phase("small pipelined")
    check_small_pipeline(torch, np, opt, generate_cluster, ClusterSpec, dev,
                         same_placement, log)

    # 11. stale frontier buffers: a second large snapshot through the cached
    # graphs (a warm-up first captures any bucket it needs that the first
    # snapshot did not; the first snapshot then runs again, so that every
    # static buffer holds its data), against the eager driver, on the
    # sequential path and on the pipelined path.
    phase("large second snapshot")
    second_l, second_l_opts = second_snapshot(torch, np, large, SECOND_SEED)
    for label, kw, eager in (
            ("per-goal", per_goal,
             lambda: drive_per_goal(opt, second_l, STACK, second_l_opts, None, per_goal)),
            ("pipelined", {},
             lambda: drive_pipelined(opt, second_l, STACK, second_l_opts, None))):
        fused_run(second_l, options=second_l_opts, **kw)
        fused_run(large, **kw)
        n_graphs = len(graphs.GRAPHS)
        run_second_l = fused_run(second_l, options=second_l_opts, **kw)
        run_second_l_eager = eager()
        fresh_l = sum(g.fresh_compile for g in run_second_l.goal_results)
        second_l_same = same_placement(run_second_l, run_second_l_eager) and \
            [(g.steps, g.actions_applied) for g in run_second_l.goal_results] == \
            [(g.steps, g.actions_applied) for g in run_second_l_eager.goal_results]
        per_goal_report(run_second_l, log, f"large-second-{label}")
        log(f"large second snapshot {label} (seed {SECOND_SEED}): new captures {fresh_l} "
            f"(cache {n_graphs} -> {len(graphs.GRAPHS)}); cached graphs equal the eager "
            f"driver: {second_l_same}; differs from the first snapshot's run: "
            f"{not same_placement(run_second_l, run_large)}")
        if not rehearse and (fresh_l or len(graphs.GRAPHS) != n_graphs):
            raise RuntimeError(f"the second large snapshot ({label}) did not go through "
                               "the cached graphs")
        if not second_l_same:
            raise RuntimeError(f"cached {label} graphs replayed a stale snapshot or "
                               "frontier")
        check_run(f"large-second-{label}", second_l, run_second_l, STACK)

    # 12. the card against the CPU plain path: a 12-broker cluster and the mid
    # rung (unfused), and a 100-broker cluster on the per-goal and on the
    # default pipelined path
    phase("card vs CPU")
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
    hundred_runs = {}
    for label, kw in (("per-goal", per_goal), ("pipelined", {})):
        run_card = fused_run(generate_cluster(spec_of(hundred_rung), device=dev), **kw)
        t0 = time.monotonic()
        run_cpu = opt.optimize(generate_cluster(spec_of(hundred_rung), device="cpu"), STACK,
                               fused=True, raise_on_hard_failure=False, device="cpu", **kw)
        compare_card_cpu(run_card, run_cpu, same_placement, log,
                         f"{hundred_rung[0]}-broker {label}", time.monotonic() - t0)
        hundred_runs[label] = (run_card, run_cpu)
    if not hundred_runs["pipelined"][0].pipelined:
        raise RuntimeError("the 100-broker default solve did not pipeline")

    # 13. warm starts: at the large rung, and at 100 brokers card against CPU
    phase("warm start")
    warm_summary = check_warm_large(torch, np, opt, large, run_pipe, fused_run, timed,
                                    check_run, log)
    check_warm_card_cpu(torch, np, opt, hundred_runs["pipelined"], fused_run,
                        same_placement, log, f"{hundred_rung[0]}-broker")

    # 14. the mid solve's proposals executed on the simulated fleet, the
    # ledger's balancedness curve scored by K10; the same on the CPU
    phase("execution")
    exec_summary, exec_counts, exec_run = check_execution(
        torch, np, opt, props, mid, dev, wrappers, log, smi, rehearse, fused_props)
    k10["mid"] = check_placement_kernels(torch, np, wrappers, log, timer, mid,
                                         exec_run.model, "mid", rehearse)

    # 15. xl250 rung on the default pipelined path
    phase("xl250")
    xl = generate_cluster(spec_of(xl_rung), device=dev)
    log(f"xl250 rung: {int(xl.replica_valid.sum())} replicas, {xl.num_brokers} brokers, "
        f"goals {len(XL_GOALS)}")
    t0 = time.monotonic()
    fused_run(xl, XL_GOALS)
    torch.cuda.synchronize()
    xl_warm = time.monotonic() - t0
    run_xl, xl_wall, xl_counts = timed(lambda: fused_run(xl, XL_GOALS))
    check_run("xl250", xl, run_xl, XL_GOALS)
    xl_summary = pipeline_report(run_xl, log, "xl250")
    log(f"xl250 pipelined {run_xl.pipelined}: warm-up {xl_warm:.2f} s, timed {xl_wall:.3f} "
        f"s, {xl_summary}")
    check_launched("xl250", xl_counts)
    if not run_xl.pipelined:
        raise RuntimeError("the xl250 default solve did not pipeline")
    k10["xl250"] = check_placement_kernels(torch, np, wrappers, log, timer, xl,
                                           run_xl.model, "xl250", rehearse)
    del xl, run_xl
    # The mid shape once more, after the xl250 shape pushed the cache past
    # its four shapes: the same proposals as in phase 5.
    again_after = props.diff(mid, fused_run(mid).model) == fused_props
    log(f"mid fused after the xl250 rung: identical proposals {again_after}")
    if not again_after:
        raise RuntimeError("the mid fused solve after the xl250 rung differs from phase 5's")

    # 16. the goal kinds beyond the 15-goal stack
    phase("goal kinds")
    cx = types.SimpleNamespace(
        torch=torch, np=np, opt=opt, props=props, gk=gk, cuda=cuda, log=log, dev=dev,
        rehearse=rehearse, timer=timer, fused_run=fused_run, mid=mid, mid_rung=mid_rung,
        large=large, large_rung=large_rung, hundred_rung=hundred_rung, xl_rung=xl_rung,
        two_racks_rung=two_racks_rung, spec_of=spec_of, generate_cluster=generate_cluster,
        compare_card_cpu=compare_card_cpu, same_placement=same_placement,
        per_goal=per_goal, pipeline_report=pipeline_report, per_goal_report=per_goal_report,
        profile_mid=profile_mid, check_run=check_run,
        execute=lambda before, run, con, label, cpu_twin=False: execute_proposals(
            torch, np, opt, before, run, props.diff(before, run.model), con, log, smi,
            rehearse, label, cpu_twin=cpu_twin))
    mode_rows, kind_counts, kinds_summary = check_goal_kinds(cx)

    # 17. the intra-broker disk path (JBOD)
    phase("JBOD")
    jbod_rows, jbod_counts, jbod_summary = check_jbod(cx)

    # 18. from metric samples to anomalies: the monitor, the detectors (K14,
    # K9's sweep) and the manager, with a stand-in heal
    phase("detection")
    cx.check_launched = check_launched
    t_detect = time.monotonic()
    detect_counts, detect_summary = check_detection(cx)
    detect_summary["phase_s"] = round(time.monotonic() - t_detect, 1)
    log(f"detection summary: {detect_summary}")

    # 19. results
    phase("results")
    log(f"summary: mid fused wall {fused_wall:.3f} s ({fused_steps} steps, "
        f"{fused_wall / max(fused_steps, 1) * 1e3:.1f} ms/step, {replays} replays, "
        f"{fetches} fetches, ops/step {prof_fused['ops_per_step']}, busy "
        f"{prof_fused['busy']}); mid unfused wall {mid_wall:.3f} s ({mid_steps} steps, "
        f"ops/step {prof_unfused['ops_per_step']}, busy {prof_unfused['busy']}); "
        f"large per-goal wall {large_wall:.3f} s ({large_steps} steps, ops/step "
        f"{prof_large['ops_per_step']}, busy {prof_large['busy']}); large pipelined wall "
        f"{pipe_wall:.3f} s ({pipe_steps} steps, ops/step {prof_pipe['ops_per_step']}, "
        f"busy {prof_pipe['busy']}); warm start {warm_summary}; xl250 {len(XL_GOALS)} "
        f"goals {xl_wall:.3f} s; frontier masks checked {frontier_checked}; execution "
        f"{exec_summary}; goal kinds {kinds_summary}; JBOD {jbod_summary}; detection "
        f"{detect_summary}; card {smi}")
    for name in EXECUTION_ONLY:
        # The mid shape is the execution's; the large and xl250 numbers beside.
        results[name] = dict(k10["mid"][name])
        for rung in ("large", "xl250"):
            results[name].update({f"{k}_{rung}": v for k, v in k10[rung][name].items()
                                  if k != "max_abs_err"})
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        device_ms = r.get("device_ms")
        for prof in (prof_pipe, prof_large, prof_fused):
            if device_ms is None:
                device_ms = prof["per_launch"].get(name)
        launches = exec_counts[name] if name in EXECUTION_ONLY else pipe_counts[name]
        extra = {k: v for k, v in r.items() if k.endswith(("_large", "_xl250"))
                 or k == "shape"}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches, **extra,
                     "launches_per_large_step": pipe_counts[name] / max(pipe_steps, 1),
                     "launches_large_sequential": large_counts[name],
                     "launches_fused_mid": fused_counts[name],
                     "launches_unfused_mid": mid_counts[name],
                     "launches_xl250": xl_counts[name],
                     "launches_execution": exec_counts[name],
                     "launches_detection_tick": detect_counts["tick"][name],
                     "launches_detectors": detect_counts["detect"].get(name, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": device_ms,
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": r["library_ms"]})
    # The new goal kinds' modes, each with the launches of the run that
    # needs it (and K3's topic cuts, which the min-leaders budgets run).
    # K10's kinds: the mid blends, the large and xl250 numbers beside.
    for goal_kind in NEW_KINDS:
        name = f"stack_sweep_batch[{goal_kind}]"
        mode_rows[name] = dict(k10["mid"][name])
        for rung in ("large", "xl250"):
            mode_rows[name].update({f"{k}_{rung}": v for k, v in k10[rung][name].items()
                                    if k != "max_abs_err"})
    for name, (source, replaces, run_label) in MODE_KERNELS.items():
        r = mode_rows[name]
        extra = {k: v for k, v in r.items() if k.endswith(("_large", "_xl250"))
                 or k == "shape"}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": kind_counts[run_label].get(name, 0),
                     "launches_run": run_label, **extra,
                     "launches_large_designated": kind_counts["large designated"].get(name, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": r["device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": None})
    # The disk path's modes, each with the launches of its JBOD run; K10's
    # disk kinds on the mid blends, the large and xl250 numbers beside.
    for name, (source, replaces, run_label) in JBOD_MODES.items():
        r = jbod_rows[name]
        extra = {k: v for k, v in r.items() if k.endswith(("_large", "_xl250"))
                 or k == "shape"}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": r["launches"],
                     "launches_run": run_label, **extra,
                     "launches_large_jbod_pipelined":
                         jbod_counts["large jbod pipelined"].get(name, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": r["device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": r["library_ms"]})
    # K14's two launches: timed at 7,000 brokers x 20 windows, launched in the
    # fleet tick (once each, for both finder families).
    for name, (source, replaces) in DETECTION_KERNELS.items():
        r = k14_rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": detect_counts["tick"][name],
                     "launches_run": "detection tick", "shape": r["shape"],
                     "launches_shape": detect_summary["k14_shape"],
                     "launches_dead_tick": detect_counts["dead"].get(name, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": r["device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # K12's device time is the whole fused solve's (its eager per-goal
    # set-up included), from the fused profile.
    graph_results["goal_chain"]["device_ms_per_launch"] = prof_fused.get("device_ms")
    for name, (source, replaces) in GRAPH_KERNELS.items():
        line.append({"name": name, "route": "cuda_graph", "source": source,
                     "replaces": replaces, **graph_results[name],
                     "bound_by": "bytes", "library_ms": None})
    log(f"total {time.monotonic() - t_start:.1f} s")
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


def pipeline_report(run, log, label):
    """Per goal of a pipelined run: whether it adopted the opener queued for
    it, its boundary gap, the openers it queued for the next goal and the
    discarded ones, their gated steps (gated off), its fused group, chunks,
    replays (gated off) and wall; returns the run's totals."""
    tot = dict(steps=0, chunks=0, compacted_chunks=0, replays=0, gated_off=0, openers=0,
               openers_wasted=0, opener_replays=0, opener_gated_off=0, adopted=0,
               fused=0, skipped=0)
    for g in run.goal_results:
        chunks = g.chunks or []
        compacted = sum(c["bucket"] is not None for c in chunks)
        log(f"  {label} {g.name:38s} adopted={int(g.pipelined)} "
            f"gap={g.boundary_gap_s * 1e3:8.2f}ms openers={g.chunks_cross_goal} "
            f"(wasted {g.chunks_cross_wasted}) opener replays={g.cross_replays} (gated off "
            f"{g.cross_replays_wasted}) group={g.fused_group} chunks={len(chunks):2d} "
            f"compacted={compacted:2d} steps={g.steps:3d} replays={g.replays:3d} (gated off "
            f"{g.replays - g.steps:3d}) wall={g.duration_s:.3f}s")
        tot["steps"] += g.steps
        tot["chunks"] += len(chunks)
        tot["compacted_chunks"] += compacted
        tot["replays"] += g.replays
        tot["gated_off"] += g.replays - g.steps
        tot["openers"] += g.chunks_cross_goal
        tot["openers_wasted"] += g.chunks_cross_wasted
        tot["opener_replays"] += g.cross_replays
        tot["opener_gated_off"] += g.cross_replays_wasted
        tot["adopted"] += g.pipelined
        tot["fused"] += g.fused_group > 1
        tot["skipped"] += g.chunks is None and g.fused_group == 1
    return tot


SMALL_PIPE_GOALS = ["RackAwareGoal", "ReplicaDistributionGoal",
                    "LeaderReplicaDistributionGoal"]


def skewed_small(torch, np, generate_cluster, ClusterSpec, dev):
    """The skewed 16-broker model of tests/test_pipeline.py:53-75, built in
    the port: one broker over its replica-count band, every other one in
    it."""
    m = generate_cluster(ClusterSpec(num_brokers=16, num_racks=4, num_topics=5,
                                     mean_partitions_per_topic=40.0, replication_factor=2,
                                     distribution="exponential", seed=7), device="cpu")
    rb = m.replica_broker.numpy()
    rv = m.replica_valid.numpy()
    cnt = np.bincount(rb[rv], minlength=16)
    total = int(cnt.sum())
    target = np.full(16, total // 16)
    target[0] += total % 16
    pool = [list(np.nonzero(rv & (rb == b))[0]) for b in range(16)]
    moves, dests = [], []
    for b in range(16):
        moves += [pool[b].pop() for _ in range(max(cnt[b] - target[b], 0))]
        dests += [b] * max(target[b] - cnt[b], 0)
    m = m.relocate_replicas(torch.tensor(moves, dtype=torch.int32),
                            torch.tensor(dests, dtype=torch.int32),
                            torch.ones(len(moves), dtype=torch.bool))
    return m.to(dev)


def check_small_pipeline(torch, np, opt, generate_cluster, ClusterSpec, dev, same_placement,
                         log):
    """The skewed 16-broker model with the dense floor lowered to 8 and
    fusion off: on the card pipelined equals sequential in placement and per
    goal steps and actions and overlaps a goal boundary (the JAX package's
    tests/test_pipeline.py:174-204), and the pipelined run equals the CPU
    plain path's."""
    floor, fuse = opt._FRONTIER_DENSE_MIN, os.environ.get("CRUISE_PIPELINE_FUSE")
    opt._FRONTIER_DENSE_MIN = 8
    os.environ["CRUISE_PIPELINE_FUSE"] = "0"
    try:
        runs = {(str(d), pipe): opt.optimize(
                    skewed_small(torch, np, generate_cluster, ClusterSpec, d),
                    SMALL_PIPE_GOALS, fused=True, pipeline=pipe, raise_on_hard_failure=False,
                    device=d)
                for d in (dev, "cpu") for pipe in (True, False)}
    finally:
        opt._FRONTIER_DENSE_MIN = floor
        if fuse is None:
            os.environ.pop("CRUISE_PIPELINE_FUSE", None)
        else:
            os.environ["CRUISE_PIPELINE_FUSE"] = fuse
    card, seq, cpu = runs[(str(dev), True)], runs[(str(dev), False)], runs[("cpu", True)]

    def rows(r):
        return [(g.name, g.steps, g.actions_applied) for g in r.goal_results]

    def pipe_rows(r):
        return [(g.name, g.steps, g.actions_applied, g.satisfied_after, g.pipelined,
                 g.chunks_cross_goal, g.chunks_cross_wasted) for g in r.goal_results]

    ok_seq = same_placement(card, seq) and rows(card) == rows(seq)
    ok_cpu = same_placement(card, cpu) and pipe_rows(card) == pipe_rows(cpu)
    log(f"small pipelined (16 brokers, floor 8, fusion off): {pipe_rows(card)}, goals "
        f"overlapped {card.goals_overlapped}; equals sequential {ok_seq}; card equals CPU "
        f"{ok_cpu}")
    if not (ok_seq and ok_cpu and card.pipelined and card.goals_overlapped >= 1):
        raise RuntimeError("the small pipelined check failed")


def perturb_partitions(torch, np, model, seed):
    """A load-only change (the replica axis and placement unchanged):
    the leader and follower loads of up to 64 partitions whose replicas all
    lie on the first 16 brokers (or the first quarter) scale by a seeded
    factor in [2, 3), as a traffic tick of a few hot partitions does."""
    rng = np.random.default_rng(seed)
    rb = model.replica_broker.cpu().numpy()
    rp = model.replica_partition.cpu().numpy()
    rv = model.replica_valid.cpu().numpy()
    near = model.partition_valid.cpu().numpy().copy()
    np.logical_and.at(near, rp[rv], rb[rv] < min(16, max(model.num_brokers // 4, 2)))
    hot = np.flatnonzero(near)[:64]
    factor = np.ones((model.num_partitions, 1), np.float32)
    factor[hot] = rng.uniform(2.0, 3.0, (hot.size, 1)).astype(np.float32)
    f = torch.from_numpy(factor[rp]).to(model.device)
    return model.replace(replica_load_leader=model.replica_load_leader * f,
                         replica_load_follower=model.replica_load_follower * f)


def check_warm_large(torch, np, opt, large, cold, fused_run, timed, check_run, log):
    """The warm start at the large rung: the cold default solve ``cold``'s
    placement with a load-only change, its ``model_delta``, a cold solve of
    the changed snapshot, a warm-up warm solve (captures) and the timed warm
    solve.  Fails unless the run is warm, ``verify_run`` passes, the hard
    goals hold and it skips at least as many goals as the cold solve."""
    from cruise_control_tpu_torch.analyzer.state import WarmStart, model_delta
    changed = perturb_partitions(torch, np, cold.model, SEED)
    delta = model_delta(cold.model, changed)
    warm_start = WarmStart(prev_model=cold.model, active_mask=delta.changed_mask)
    run_cold, cold_wall, _ = timed(lambda: fused_run(changed))
    fused_run(changed, warm_start=warm_start)
    run_warm, warm_wall, _ = timed(lambda: fused_run(changed, warm_start=warm_start))
    check_run("large-warm", changed, run_warm, STACK)
    driven = [g for g in run_warm.goal_results if g.chunks]
    first = driven[0].chunks[0]["bucket"] if driven else None
    out = dict(changed=delta.num_changed, magnitude=round(delta.magnitude, 6),
               seed=run_warm.seed_frontier_size, skipped_warm=run_warm.goals_skipped,
               skipped_cold=run_cold.goals_skipped,
               steps_warm=sum(g.steps for g in run_warm.goal_results),
               steps_cold=sum(g.steps for g in run_cold.goal_results),
               first_chunk_bucket=first, wall_warm=round(warm_wall, 4),
               wall_cold=round(cold_wall, 4))
    log(f"large warm start: {out}")
    if not run_warm.warm or run_warm.goals_skipped < run_cold.goals_skipped:
        raise RuntimeError(f"the large warm start failed its checks: {out}")
    return out


def check_warm_card_cpu(torch, np, opt, runs, fused_run, same_placement, log, label):
    """The same warm solve on the card and on the CPU plain path, from the
    two equal cold default solves ``runs`` (card, CPU): the same load-only
    change, the seed mask of the CPU's ``model_delta``; per goal and in
    placement equal."""
    from cruise_control_tpu_torch.analyzer.state import WarmStart, model_delta
    card, cpu = runs
    changed = {"card": perturb_partitions(torch, np, card.model, SEED),
               "cpu": perturb_partitions(torch, np, cpu.model, SEED)}
    delta = model_delta(cpu.model, changed["cpu"])
    delta_card = model_delta(card.model, changed["card"])
    warm_card = fused_run(changed["card"], warm_start=WarmStart(
        prev_model=card.model, active_mask=delta.changed_mask))
    t0 = time.monotonic()
    warm_cpu = opt.optimize(changed["cpu"], STACK, fused=True, raise_on_hard_failure=False,
                            device="cpu", warm_start=WarmStart(
                                prev_model=cpu.model, active_mask=delta.changed_mask))
    log(f"{label} warm start: seed {warm_card.seed_frontier_size} brokers (the card's "
        f"model_delta equals the CPU's: "
        f"{bool((delta_card.changed_mask == delta.changed_mask).all())}), skipped "
        f"{warm_card.goals_skipped}")
    compare_card_cpu(warm_card, warm_cpu, same_placement, log, f"{label} warm",
                     time.monotonic() - t0)
    if not (warm_card.warm and warm_cpu.warm):
        raise RuntimeError(f"{label}: the warm solves were not warm")


def k10_masks(torch, np, before, after, c, seed):
    """bool[c, P] landed masks on the models' device: the landed sets of a
    seeded prefix order over the partitions whose replicas the solve moved
    (row 0 lands none of them, row c - 1 all)."""
    moved = ((before.replica_broker != after.replica_broker)
             | (before.replica_is_leader != after.replica_is_leader)
             | (before.replica_disk != after.replica_disk)) & before.replica_valid
    parts = np.unique(before.replica_partition[moved].cpu().numpy())
    order = np.random.default_rng(seed).permutation(parts)
    m = np.zeros((c, before.num_partitions), bool)
    for i in range(c):
        m[i, order[:(i * len(order)) // max(c - 1, 1)]] = True
    return torch.from_numpy(m).to(before.device), len(order)


def device_ms(torch, fn, names, log, runs: int = 5):
    """Device time per launch of the kernel named ``names[0]`` over ``runs``
    calls of ``fn`` under ``torch.profiler``: the time of its device kernels
    whose names contain one of ``names`` over the count of the first; None
    (and the device ops seen, logged) when three sessions saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then records no device op
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        hits = [e for e in ops if any(n in e.name for n in names)]
        launches = sum(names[0] in e.name for e in hits)
        if launches:
            return sum(e.time_range.elapsed_us() for e in hits) / 1e3 / launches
        log(f"  profiler, attempt {attempt + 1}: no {names[0]} among {len(ops)} device "
            f"ops {sorted({e.name[:60] for e in ops})[:6]}")
    return None


def _k10_bytes(before, c, topic, g=None, leaders=False, preferred=False):
    """Bytes K10 must move for ``c`` blends.  The aggregates: the masks
    (c x P), both placements (broker id and leader flag, 5 bytes each), the
    replica partitions, valid flags, topics and both load rows, each read
    once; c x B x 32 bytes of aggregates, the c x T x B topic counts and
    (``leaders``) topic leader counts written.  The sweep (``g`` goals):
    those aggregates and the masks read, both placements' broker ids, the
    replica partitions and valid flags, the sibling rows and the broker
    columns (alive, valid, capacity, rack) once, the replication factors,
    and for the preferred-leader goal both placements' leader flags and
    disks, the offline flags, original brokers, broker states and disk
    capacities; c x G flags written."""
    R, P, B, T = (before.num_replicas_padded, before.num_partitions, before.num_brokers,
                  before.num_topics)
    aggs = c * B * 32 + (c * T * B * 4 if topic else 0) + (c * T * B * 4 if leaders else 0)
    if g is None:
        return c * P + R * (2 * 5 + 4 + 1 + 32 + (4 if topic or leaders else 0)) + aggs
    extra = P * 4 + (T if leaders else 0)
    if preferred:
        extra += R * (2 * 1 + 2 * 4 + 1 + 4) + B + before.num_disks * 4
    return (aggs + c * P + R * (2 * 4 + 4 + 1) + before.partition_replicas.numel() * 4
            + B * (1 + 1 + 16 + 4) + extra + c * g)


def check_placement_kernels(torch, np, wrappers, log, time_ms, before, after, label,
                            rehearse):
    """K10's two launches against their plain twins on the card, on K10_BATCH
    blends of ``before`` and ``after`` (``k10_masks``), for the goals of
    ``K10_GOALS`` (every inter-broker kind) with the four topics of the most
    partitions designated: the aggregates bit for bit (and an all-false row
    equal to K1's), topic leader counts included, the flags exactly.  Then each
    launch timed (CUDA events, median; device time under the profiler), its
    plain twin timed (3 runs), the bound, and for the aggregates one
    ``index_add_`` over flattened (blend, broker) segments of the blended
    rows (the library call)."""
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays

    # Every inter-broker goal kind, with the rung's designated topics.
    specs = tuple(goals_by_priority(K10_GOALS))
    con, _ = designated_constraint(torch, before)
    masks, moved = k10_masks(torch, np, before, after, K10_BATCH, SEED)
    ka, ks = wrappers["blend_aggregates"], wrappers["stack_sweep_batch"]
    got = ka(before, after, masks, True, with_topic_leaders=True)
    ref = gk.blend_aggregates_plain(before, after, masks, True, True)
    k1 = BrokerArrays.from_model(before, True, True)
    k1 = (k1.load, k1.replica_count, k1.leader_count, k1.potential_nw_out,
          k1.leader_bytes_in, k1.topic_counts, k1.topic_leader_counts)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    fields = ("load", "replica_count", "leader_count", "potential_nw_out",
              "leader_bytes_in", "topic_counts", "topic_leader_counts")
    for f, g, r, k in zip(fields, got, ref, k1):
        if not torch.equal(bits(g), bits(r)):
            raise RuntimeError(f"K10 aggregates ({label}): {f} differs from the plain twin")
        if not torch.equal(bits(g[0]), bits(k)):
            raise RuntimeError(f"K10 aggregates ({label}): the all-false blend's {f} "
                               "differs from K1's")
    sat = ks(specs, before, after, masks, got, con)
    sat_ref = gk.stack_sweep_batch_plain(specs, before, after, masks, ref, con)
    if not torch.equal(sat, sat_ref):
        bad = torch.nonzero(sat != sat_ref)[:5].tolist()
        raise RuntimeError(f"K10 sweep ({label}) differs from the plain twin at "
                           f"(blend, goal) {bad}")
    # The scorer's own call: in slices of 64 blends above 256 MiB of topic
    # tables (two [C, T, B] tables here), the same flags.
    from cruise_control_tpu_torch.analyzer import optimizer as opt
    sliced = 2 * masks.shape[0] * before.num_topics * before.num_brokers * 4 > \
        opt._SCORE_SLICE_BYTES
    scored = opt._get_placement_score_fn(specs, con, masks.shape[0])(before, after, masks)
    if not torch.equal(scored, sat):
        raise RuntimeError(f"K10 ({label}): the scorer's call (sliced {sliced}) differs "
                           "from one launch")
    log(f"K10 {label}: the scorer's call, sliced {sliced}, equals one launch")
    C, R, B, T = masks.shape[0], before.num_replicas_padded, before.num_brokers, \
        before.num_topics
    shape = dict(C=C, P=before.num_partitions, R=R, B=B, G=len(specs), T=T,
                 moved_partitions=moved)
    # The library call: the blended rows of every (blend, replica) summed
    # into (blend, broker) segments by one index_add_.
    part = before.replica_partition.clamp(0, before.num_partitions - 1).long()
    rmask = masks[:, part]
    rb = torch.where(rmask, after.replica_broker, before.replica_broker).long()
    lead = torch.where(rmask, after.replica_is_leader, before.replica_is_leader)
    ll, lf = before.replica_load_leader, before.replica_load_follower
    rows = torch.cat([torch.where(lead[..., None], ll, lf), torch.ones_like(rb[..., None],
                      dtype=torch.float32), lead[..., None].float(),
                      ll[:, 2:3].expand(C, R, 1), torch.where(lead, ll[:, 1], 0.0)[..., None]],
                     -1)
    rows = torch.where(before.replica_valid[None, :, None], rows, 0.0).reshape(-1, 8)
    seg = (torch.arange(C, device=rb.device)[:, None] * B + rb).reshape(-1)
    acc = torch.zeros((C * B, 8), device=rb.device)
    fast = 5 if T * B * C > 1 << 24 else TIMED_RUNS
    out = {
        "blend_aggregates": dict(
            max_abs_err=0.0, shape=shape,
            ms=time_ms(torch, lambda: ka(before, after, masks, True,
                                         with_topic_leaders=True), fast),
            plain_ms=time_ms(torch, lambda: gk.blend_aggregates_plain(before, after, masks,
                                                                       True, True), 3),
            library_ms=time_ms(torch, lambda: acc.zero_().index_add_(0, seg, rows), fast),
            bound_ms=bound_ms(_k10_bytes(before, C, True, leaders=True)),
            device_ms=None if rehearse else device_ms(
                torch, lambda: ka(before, after, masks, True, with_topic_leaders=True),
                ("blend_aggregates_kernel",), log)),
        "stack_sweep_batch": dict(
            max_abs_err=0.0, shape=shape,
            ms=time_ms(torch, lambda: ks(specs, before, after, masks, got, con), fast),
            plain_ms=time_ms(torch, lambda: gk.stack_sweep_batch_plain(
                specs, before, after, masks, ref, con), 3),
            library_ms=None,
            bound_ms=bound_ms(_k10_bytes(before, C, True, len(specs), leaders=True,
                                         preferred=True)),
            device_ms=None if rehearse else device_ms(
                torch, lambda: ks(specs, before, after, masks, got, con),
                ("stack_sweep_batch_kernel",), log)),
    }
    # Each new kind's sweep alone (one goal of the kind), exact and timed.
    for kind in NEW_KINDS:
        sk = tuple(sp for sp in specs if sp.kind == kind)[:1]
        got_k = ks(sk, before, after, masks, got, con)
        if not torch.equal(got_k, gk.stack_sweep_batch_plain(sk, before, after, masks, ref,
                                                             con)):
            raise RuntimeError(f"K10 sweep ({label}, {kind}) differs from the plain twin")
        out[f"stack_sweep_batch[{kind}]"] = dict(
            max_abs_err=0.0, shape=dict(shape, G=1),
            ms=time_ms(torch, lambda: ks(sk, before, after, masks, got, con), fast),
            plain_ms=time_ms(torch, lambda: gk.stack_sweep_batch_plain(
                sk, before, after, masks, ref, con), 3),
            library_ms=None,
            bound_ms=bound_ms(_k10_bytes(before, C, False, 1,
                                         leaders=kind == "min_topic_leaders",
                                         preferred=kind == "preferred_leader")),
            device_ms=None if rehearse else device_ms(
                torch, lambda: ks(sk, before, after, masks, got, con),
                ("stack_sweep_batch_kernel",), log))
    del rows, seg, acc, rmask
    log(f"K10 {label}: C={C} P={before.num_partitions} R={R} B={B} G={len(specs)} T={T}, "
        f"{moved} partitions moved; aggregates bit-equal to the plain twin (all-false "
        f"blend = K1), flags exact, {int((~sat).sum())} of {sat.numel()} flags violated")
    for name, r in out.items():
        log(f"  K10 {label} {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']}), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.6f} ms")
    return out


def check_execution(torch, np, opt, props, mid, dev, wrappers, log, smi, rehearse,
                    fused_props):
    """``bench.py --execute`` in the port: the mid rung's fused solve of a
    copy (through the step graphs cached since phase 5, after other shapes'
    captures: its proposals must be ``fused_props``, phase 5's), its
    proposals, bench.py's throttle rule, and the simulated
    execution with the balancedness scorer, the launch counters set to 0
    just before and read just after.  Fails unless the result is ok with no
    dead or aborted task, the ledger's totals reconcile, off-target bytes
    never grow and end at 0, the first and last scores are the run's
    balancedness before and after (within 1e-6) and K10 launched once per
    flush; then the same proposals on the CPU path must give the same
    result and checkpoints, field for field, the scores within 1e-9.
    Returns (summary, launch counts, run)."""
    run = opt.optimize(opt.donation_copy(mid), STACK, fused=True, donate_model=True,
                       raise_on_hard_failure=False, device=dev)
    proposals = props.diff(mid, run.model)
    log(f"mid execution's solve: {len(proposals)} proposals, equal to the mid fused run's "
        f"{proposals == fused_props}; selection constants cached "
        f"{opt._selection_consts.cache_info().currsize}")
    if proposals != fused_props:
        raise RuntimeError("the mid solve through the cached step graphs differs from "
                           "the same solve in phase 5")
    summary, counts = execute_proposals(torch, np, opt, mid, run, proposals, None, log, smi,
                                        rehearse, "mid", cpu_twin=True)
    return summary, counts, run


def execute_proposals(torch, np, opt, mid, run, proposals, con, log, smi, rehearse, label,
                      cpu_twin):
    """``proposals`` of ``run`` (solved from ``mid`` under constraint ``con``)
    executed on the simulated fleet with bench.py's throttle rule and the
    balancedness scorer, the launch counters set to 0 just before and read
    just after: the checks of ``check_execution``, and with ``cpu_twin`` the
    same on the CPU path.  Returns (summary, every launch count)."""
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    from cruise_control_tpu_torch.executor import simulate as sim
    from cruise_control_tpu_torch.executor.ledger import ExecutionLedger
    from cruise_control_tpu_torch.ops import cuda

    inter_bytes = sum(int(p.partition_size * 1e6) * len(p.replicas_to_add) for p in proposals)
    intra_moves = sum(len(p._intra_broker_moves()) for p in proposals)
    moves_bytes = inter_bytes > 0 or intra_moves > 0
    rate = max(1_000_000.0, inter_bytes / max(mid.num_brokers, 1) / 300.0)
    goals = [g.name for g in run.goal_results]
    flushes = []  # per flush that scored: (wall s, its landed sets)
    real_flush = ExecutionLedger.score_checkpoints

    def timed_flush(ledger):
        pending = [cp["_landed_set"] for cp in ledger.checkpoints
                   if cp["balancedness"] is None and "_landed_set" in cp]
        t0 = time.monotonic()
        real_flush(ledger)
        if pending:
            flushes.append((time.monotonic() - t0, pending))

    def execute(before, after):
        flushes.clear()
        cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        result, ex, admin = sim.run_simulated_execution(
            before, proposals, model_after=after, goal_names=goals, constraint=con,
            tick_ms=1000, rate_bytes_per_sec=rate)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        return result, ex.progress(verbose=True), wall, cuda.launch_counts(), list(flushes)

    ExecutionLedger.score_checkpoints = timed_flush
    try:
        result, prog, wall, counts, card_flushes = execute(mid, run.model)
        if cpu_twin:
            cpu_result, cpu_prog, cpu_wall, _, cpu_flushes = execute(mid.to("cpu"),
                                                                     run.model.to("cpu"))
    finally:
        ExecutionLedger.score_checkpoints = real_flush
    cps = prog["checkpoints"]
    scored = [c["balancedness"] for c in cps if c["balancedness"] is not None]
    off = [c["offTargetBytes"] for c in cps]
    n_flush = len(card_flushes)
    n_scored = sum(len(f[1]) for f in card_flushes)
    summary = dict(proposals=len(proposals), tasks=prog["totalTasks"], polls=result.polls,
                   checkpoints=len(cps), checkpoints_scored=n_scored, flushes=n_flush,
                   host_wall_s=round(wall, 4),
                   score_wall_s=round(sum(f[0] for f in card_flushes), 4),
                   fleet_s=prog["elapsedMs"] / 1000.0, rate_bytes_per_sec=rate,
                   balancedness_before=run.balancedness_before,
                   balancedness_after=run.balancedness_after,
                   first_score=scored[0] if scored else None,
                   last_score=scored[-1] if scored else None,
                   k10_launches={n: counts[n] for n in EXECUTION_ONLY})
    if cpu_twin:
        summary.update(cpu_host_wall_s=round(cpu_wall, 4),
                       cpu_score_wall_s=round(sum(f[0] for f in cpu_flushes), 4))
    log(f"{label} execution on {smi}: {summary}")
    log(f"{label} execution launches: { {n: c for n, c in counts.items() if c} }")
    checks = {
        "ok": result.ok and result.dead == 0 and result.aborted == 0,
        "totals": (prog["taskCounts"]["completed"] == result.completed
                   and prog["taskCounts"]["dead"] == result.dead
                   and prog["taskCounts"]["aborted"] == result.aborted
                   and prog["totalTasks"] == result.completed
                   and prog["bytesMoved"] == prog["totalBytes"]
                   and (prog["totalBytes"] > 0) == moves_bytes
                   and prog["bytesInFlight"] == 0),
        "off-target": all(b <= a for a, b in zip(off, off[1:])) and off[-1] == 0,
        # A leadership-only execution lands in one phase: its one checkpoint
        # is the run's balancedness after.
        "scores": (len(scored) >= (2 if moves_bytes else 1)
                   and (len(scored) < 2
                        or abs(scored[0] - run.balancedness_before) < 1e-6)
                   and abs(scored[-1] - run.balancedness_after) < 1e-6),
        "launches": rehearse or (n_flush >= 1 and all(counts[n] == n_flush
                                                      for n in EXECUTION_ONLY)),
    }
    if not cpu_twin:
        log(f"{label} execution: checks {checks}")
        if not all(checks.values()):
            raise RuntimeError(f"the {label} execution failed its checks: {checks}")
        return summary, counts
    # The CPU path: the same result and checkpoints, field for field.
    same_result = dataclasses.asdict(result) == dataclasses.asdict(cpu_result)
    cpu_cps = cpu_prog["checkpoints"]
    flipped = []
    same_cps = len(cps) == len(cpu_cps)
    for a, b in zip(cps, cpu_cps):
        keys = set(a) | set(b)
        if any(a.get(k) != b.get(k) for k in keys - {"balancedness"}):
            same_cps = False
        sa, sb = a.get("balancedness"), b.get("balancedness")
        if (sa is None) != (sb is None) or (sa is not None and abs(sa - sb) > 1e-9):
            same_cps = False
            flipped.append((a["poll"], sa, sb))
    if flipped:
        # Name each flipped goal and its margin: the distance of the metric
        # closest to its band edge on the CPU's blend.
        specs = tuple(goals_by_priority(goals))
        con = con or BalancingConstraint.default()
        before_c, after_c = mid.to("cpu"), run.model.to("cpu")
        fn = opt._get_placement_score_fn(specs, con, 1)
        for (_, landed_sets), _ in zip(card_flushes, range(4)):
            for landed in landed_sets:
                mask = np.zeros((1, mid.num_partitions), bool)
                mask[0, list(landed)] = True
                m_card = torch.from_numpy(mask).to(dev)
                card_sat = fn(mid, run.model, m_card).cpu()[0]
                cpu_sat = fn(before_c, after_c, torch.from_numpy(mask))[0]
                for j in torch.nonzero(card_sat != cpu_sat).flatten().tolist():
                    spec = specs[j]
                    blend = gk.blend_placement(before_c, after_c, torch.from_numpy(mask[0]))
                    arr = BrokerArrays.from_model(blend, with_topic_counts=True)
                    metric = gk.broker_metric(spec, blend, arr, con)
                    lower, upper = gk.limits(spec, blend, arr, con)
                    margin = torch.minimum((metric - upper).abs(), (metric - lower).abs())
                    log(f"  flipped flag: {spec.name} card {bool(card_sat[j])} CPU "
                        f"{bool(cpu_sat[j])}, margin {float(margin[arr.alive].min()):.6g}")
    log(f"{label} execution card vs CPU: result equal {same_result}, checkpoints equal "
        f"{same_cps} ({len(cps)} vs {len(cpu_cps)}), flipped scores {flipped[:5]}; "
        f"checks {checks}")
    if not all(checks.values()) or not (same_result and same_cps):
        raise RuntimeError(f"the {label} execution failed its checks: {checks}, result "
                           f"equal {same_result}, checkpoints equal {same_cps}")
    return summary, counts


def per_goal_report(run, log, label):
    """Per goal of a per-goal run: chunks, buckets, replays (gated off),
    follow-ups (wasted), host fetches and wall; returns the run's totals."""
    tot = dict(steps=0, chunks=0, compacted_chunks=0, replays=0, gated_off=0,
               speculative=0, wasted=0, fetches=0, skipped=0)
    for g in run.goal_results:
        chunks = g.chunks or []
        buckets = sorted({c["bucket"] for c in chunks if c["bucket"] is not None})
        compacted = sum(c["bucket"] is not None for c in chunks)
        log(f"  {label} {g.name:38s} chunks={len(chunks):2d} compacted={compacted:2d} "
            f"buckets={buckets} steps={g.steps:3d} replays={g.replays:3d} "
            f"(gated off {g.replays - g.steps:3d}) follow-ups={g.chunks_speculative} "
            f"(wasted {g.chunks_wasted}) fetches={g.fetches} wall={g.duration_s:.3f}s "
            f"fetch wait={g.fetch_wait_s:.3f}s")
        tot["steps"] += g.steps
        tot["chunks"] += len(chunks)
        tot["compacted_chunks"] += compacted
        tot["replays"] += g.replays
        tot["gated_off"] += g.replays - g.steps
        tot["speculative"] += g.chunks_speculative
        tot["wasted"] += g.chunks_wasted
        tot["fetches"] += g.fetches
        tot["skipped"] += g.chunks is None
    return tot


def compare_card_cpu(card, cpu, same_placement, log, label, cpu_s):
    """Per goal the same satisfied flags, steps, actions, ``pipelined`` and
    fused group, and the same placement; on a difference, the first goal and chunk that differ."""
    rows = [[(g.satisfied_before, g.satisfied_after, g.steps, g.actions_applied,
              g.pipelined, g.fused_group) for g in run.goal_results] for run in (card, cpu)]
    same = same_placement(card, cpu)
    log(f"{label} card vs CPU plain path ({cpu_s:.1f} s on the CPU): per-goal rows equal "
        f"{rows[0] == rows[1]}, identical placement {same}")
    if rows[0] != rows[1] or not same:
        for a, b in zip(card.goal_results, cpu.goal_results):
            ca, cb = a.chunks or [], b.chunks or []
            keys = ("steps", "actions", "bucket", "ns", "nd", "speculative", "num_active")
            for i, (x, y) in enumerate(zip(ca, cb)):
                if [x[k] for k in keys] != [y[k] for k in keys]:
                    log(f"  first differing chunk: {a.name} chunk {i}: card "
                        f"{[x[k] for k in keys]} vs CPU {[y[k] for k in keys]}")
                    break
            else:
                if len(ca) != len(cb) or (a.steps, a.actions_applied) != \
                        (b.steps, b.actions_applied):
                    log(f"  first differing goal: {a.name}: card {len(ca)} chunks, "
                        f"CPU {len(cb)}")
                else:
                    continue
            break
        raise RuntimeError(f"{label}: the card and the CPU plain path disagree")


def check_recorded_frontiers(torch, gk, inputs, log):
    """K9's frontier mask on the card against the plain twin on CPU copies of
    the same inputs, for every mask the large run's warm-up computed (each
    band goal's first fetched mask among them).  Exact."""
    if not inputs or inputs[0][0].device.type == "cpu":
        return len(inputs)
    for i, args in enumerate(inputs):
        got, count = gk.frontier_mask(*args)
        ref, ref_count = gk.frontier_mask_plain(
            *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        if not (torch.equal(got.cpu(), ref) and torch.equal(count.cpu(), ref_count)):
            raise RuntimeError(f"K9 frontier mask disagrees with the plain version on "
                               f"recorded input {i}")
    log(f"K9 frontier_active: {len(inputs)} masks of the large run equal the plain "
        "version on the CPU (exact)")
    return len(inputs)


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
    # Device time per launch of each port kernel: the time of all its device
    # kernels over the count of the first (K2 is two device kernels, K3 its
    # cut and the launches of its scan).
    per_launch = {}
    for wrapper, names in PROFILE_NAMES.items():
        hits = {k: [(n, t) for name, (n, t) in by_name.items() if k in name]
                for k in names}
        launches = sum(n for n, _ in hits[names[0]])
        total = sum(t for h in hits.values() for _, t in h)
        per_launch[wrapper] = total / launches if launches else None
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


def drive_per_goal(opt, model, goals, options, cache, kw):
    """``optimize(fused=True, **kw)``'s sequential per-goal driver at the
    defaults the runs use (default widths, step budget and chunk lengths),
    without the before/after statistics: with ``cache`` the goals' step
    graphs replay, with None the same gated steps run eagerly."""
    import contextlib
    import inspect
    import types
    from cruise_control_tpu_torch.analyzer import candidates as cgen
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
    if kw.get("pipeline") is not False:
        raise ValueError("drive_per_goal mirrors optimize(pipeline=False)")
    specs = goals_by_priority(goals)
    options = options if options is not None else OptimizationOptions.none(model)
    max_steps = inspect.signature(opt.optimize).parameters["max_steps_per_goal"].default
    b = model.num_brokers
    with cache.lock if cache is not None else contextlib.nullcontext():
        final, results, _, _ = opt._optimize_per_goal(
            model, options, specs, BalancingConstraint.default(),
            cgen.default_num_sources(model), cgen.default_num_dests(model), max_steps,
            32 if b >= 500 else None, b > opt._FRONTIER_DENSE_MIN, False,
            lambda *a: 0, cache)
    return types.SimpleNamespace(model=final, goal_results=results)


def drive_pipelined(opt, model, goals, options, cache):
    """``optimize(fused=True)``'s pipelined driver at the defaults the runs
    use above the dense floor (default widths, step budget and chunk
    lengths, auto-fusion as the environment says), without the before/after
    statistics: with ``cache`` the goals' step graphs replay, with None the
    same gated steps run eagerly."""
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
    b = model.num_brokers
    with cache.lock if cache is not None else contextlib.nullcontext():
        final, results, _, counts = opt._optimize_pipelined(
            model, options, specs, BalancingConstraint.default(),
            cgen.default_num_sources(model), cgen.default_num_dests(model), max_steps,
            32 if b >= 500 else None, b > opt._FRONTIER_DENSE_MIN, False,
            lambda *a: 0, cache)
    return types.SimpleNamespace(model=final, goal_results=results, **counts)


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

    # ---- K1: broker aggregates.  Exact against the plain version on CPU
    # copies of the same inputs (the kernel adds each broker's rows in the
    # CPU index_add_'s row order); the plain version on the card (float
    # atomics, in no fixed order) within rtol 1e-5 of each column's max.

    def cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)

    def same_bits(g, r):
        g, r = g.cpu(), r.cpu()
        if g.dtype == torch.float32:
            return torch.equal(g.view(torch.int32), r.view(torch.int32))
        return torch.equal(g, r)

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
        if not all(same_bits(g, r) for g, r in zip(got, broker_aggregates_plain(*cpu(args)))):
            raise RuntimeError("K1 differs from the plain version on the CPU")
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
    log(f"K1 broker_aggregates: R={R} B={B} equal to the plain version on the CPU (exact); card twin max |err| {err:.3g}")

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

    # ---- K3: prefix cut.  Exact (the kernel cuts on the plain version's
    # running totals, ``ordered_cumsum``); segments holding a position whose
    # running total lies within 2 eps of a bound are counted.
    k3 = wrappers["prefix_cut"]
    cap = captured["prefix_cut"][:8]  # without the segments' name
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
        if not torch.equal(got, ref):
            raise RuntimeError(f"K3 disagrees at {int((got != ref).sum())} positions")
        near_total += int(_near_bound_segments(torch, gk, *args).sum())
    out["prefix_cut"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k3(*cap)),
        plain_ms=time_ms(torch, lambda: gk.prefix_cut_admit_plain(*cap)),
        library_ms=None, bound_ms=bound_ms(K * 10 + int(cap[3].sum()) * 4 * C + S * 12 * C))
    log(f"K3 prefix_cut: K={K} C={C} S={S} ok (exact); segments with a position "
        f"within 2 eps of a bound: {near_total}")

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
        ca = cpu(args)
        if not same_bits(got, masked_segment_sum(ca[0], ca[1], ca[3], ca[2])):
            raise RuntimeError("segment_sum differs from the plain version on the CPU")
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
    log(f"K1 segment_sum: N={N} C={C} S={S} equal to the plain version on the CPU (exact), deterministic; card twin max |err| {err:.3g}")

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


# K11 cases: (steps, budget, last_n, satisfied at exit, offline at exit,
# gate) — capped, converged, satisfied, offline, host-decided.
GATE_CASES = [(4, 4, 3, False, False, True), (2, 4, 0, False, False, True),
              (4, 4, 0, True, False, True), (4, 4, 2, True, False, True),
              (4, 4, 2, True, True, True), (0, 8, 0, True, False, False),
              (3, 8, 5, False, True, False)]


def check_frontier_kernels(torch, np, captured, wrappers, log, time_ms, models):
    """This slice's kernels against their plain versions: K5b on the captured
    batch (and with a dead broker, for rack, topic and both), K9's sweep on
    the full stack for the mid snapshot, the second mid snapshot (a dead
    broker) and the large rung, K9's frontier mask for every band goal of
    those clusters (against the plain version on CPU copies of the inputs:
    the CPU cumsum is the order the kernel reproduces), K11 on its case
    table, the ordered sum of the band averages on the captured input and on
    seeded fixtures.  All exact."""
    from cruise_control_tpu_torch.analyzer import optimizer as opt
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS, goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    from cruise_control_tpu_torch.model.tensor_model import BrokerState
    from cruise_control_tpu_torch.ops import order

    out = {}
    con = BalancingConstraint.default()
    specs = tuple(goals_by_priority(STACK))

    def on_cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)

    # ---- K5b: structural accepts.  Exact.
    k5b = wrappers["structural_accepts"]
    prevs, model, arrays, cand, con0 = captured["structural_accepts"]
    rack, topic = (GOAL_SPECS["RackAwareGoal"],), (GOAL_SPECS["TopicReplicaDistributionGoal"],)
    vetoes = 0
    for m in (model, model.set_broker_state(2, BrokerState.DEAD)):
        arr = BrokerArrays.from_model(m, with_topic_counts=True)
        for prev in (rack, topic, rack + topic):
            got = k5b(prev, m, arr, cand, con)
            ref = gk.structural_accepts_plain(prev, m, arr, cand, con)
            if not torch.equal(got, ref):
                raise RuntimeError(f"K5b disagrees with the plain version on "
                                   f"{[p.kind for p in prev]} ({int((got != ref).sum())} "
                                   "lanes)")
            vetoes += int((~ref).sum())
    out["structural_accepts"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k5b(prevs, model, arrays, cand, con0)),
        plain_ms=time_ms(torch, lambda: gk.structural_accepts_plain(prevs, model, arrays,
                                                                    cand, con0)),
        library_ms=None, bound_ms=bound_ms(_k5b_bytes(prevs, model, cand)))
    log(f"K5b structural_accepts: K={cand.k} captured {[p.kind for p in prevs]}; rack, "
        f"topic, both x healthy/dead ok (exact), {vetoes} vetoes")

    # ---- K9, sweep.  Exact booleans.
    k9 = wrappers["stack_sweep"]
    for label, m in models.items():
        arr = BrokerArrays.from_model(m, with_topic_counts=True)
        got = k9(specs, m, arr, con)
        ref = gk.stack_satisfied_plain(specs, m, arr, con)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise RuntimeError(f"K9 sweep disagrees with the plain version on {label}")
        log(f"K9 stack_sweep {label}: satisfied {got[0].int().tolist()}, offline "
            f"{bool(got[1][0])} (exact)")
    large = models["large"]
    arr_l = BrokerArrays.from_model(large, with_topic_counts=True)
    out["stack_sweep"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k9(specs, large, arr_l, con)),
        plain_ms=time_ms(torch, lambda: gk.stack_satisfied_plain(specs, large, arr_l, con)),
        library_ms=None, bound_ms=bound_ms(_k9_bytes(specs, large)))

    # ---- K9, frontier mask.  Exact against the plain version on the CPU.
    kf = wrappers["frontier_active"]
    band = [s for s in specs if gk.is_band_kind(s)]
    n = card_diff = 0
    for label, m in models.items():
        arr = BrokerArrays.from_model(m)
        for spec in band:
            inp = gk.frontier_inputs(spec, m, arr, con)
            got, count = kf(*inp)
            ref, ref_count = gk.frontier_mask_plain(*on_cpu(inp))
            if not (torch.equal(got.cpu(), ref) and torch.equal(count.cpu(), ref_count)):
                raise RuntimeError(f"K9 frontier mask disagrees with the plain version on "
                                   f"{label} {spec.name}")
            card_diff += int((gk.frontier_mask_plain(*inp)[0].cpu() != ref).sum())
            n += 1
    inp_l = gk.frontier_inputs(GOAL_SPECS["ReplicaDistributionGoal"], large,
                                BrokerArrays.from_model(large), con)
    B = large.num_brokers
    out["frontier_active"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: kf(*inp_l)),
        plain_ms=time_ms(torch, lambda: gk.frontier_mask_plain(*inp_l)), library_ms=None,
        bound_ms=bound_ms(B * 18 + B + 4))
    log(f"K9 frontier_active: {n} masks (band goals x mid, second, large) ok (exact); the "
        f"plain version run on the card differs from it on the CPU in {card_diff} brokers")

    # ---- K11: chunk gate.  Exact.
    kg = wrappers["chunk_gate"]
    dev = large.device

    def gate_args(case):
        steps, budget, last_n, sat, off, gate = case
        return (torch.tensor([steps, 9, last_n, 2, 5, 77, budget], dtype=torch.int32,
                             device=dev),
                torch.tensor([1], dtype=torch.int32, device=dev),
                torch.tensor([sat], device=dev), torch.tensor([off], device=dev),
                torch.tensor([12], dtype=torch.int32, device=dev),
                torch.full((11,), -7, dtype=torch.int32, device=dev), True, gate, 16)

    for case in GATE_CASES:
        a, b = gate_args(case), gate_args(case)
        kg(*a)
        opt.chunk_gate_plain(*b)
        for x, y in zip(a[:6], b[:6]):
            if not torch.equal(x, y):
                raise RuntimeError(f"K11 disagrees with the plain version on case {case}")
    a = gate_args(GATE_CASES[0])
    out["chunk_gate"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: kg(*a)),
        plain_ms=time_ms(torch, lambda: opt.chunk_gate_plain(*a)), library_ms=None,
        bound_ms=bound_ms(8 * 4 + 2 + 4 + 11 * 4 + 8 * 4))
    log(f"K11 chunk_gate: {len(GATE_CASES)} cases ok (exact)")

    # ---- The ordered sum of the band averages.  Exact, against the plain
    # version on the card and on a CPU copy, on the captured input and on
    # seeded vectors and [n, 4] tables around the window edges.
    ks = wrappers["ordered_sum"]
    (x_cap,) = captured["ordered_sum"]
    rng = np.random.default_rng(SEED)
    fixtures = [x_cap]
    for n in (1, 31, 32, 33, 200, 1000, 1025, 16384):
        for shape in ((n,), (n, 4)):
            mag = rng.exponential(1.0, shape) * 10.0 ** rng.integers(-3, 5, shape)
            fixtures.append(torch.from_numpy(
                (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)).to(dev))
    for x in fixtures:
        got = ks(x)
        if not (torch.equal(got, order.ordered_sum_plain(x))
                and torch.equal(got.cpu(), order.ordered_sum_plain(x.cpu()))):
            raise RuntimeError(f"ordered_sum disagrees with the plain version on "
                               f"{tuple(x.shape)}")
    out["ordered_sum"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: ks(x_cap)),
        plain_ms=time_ms(torch, lambda: order.ordered_sum_plain(x_cap)),
        library_ms=time_ms(torch, lambda: torch.sum(x_cap, dim=0)),
        bound_ms=bound_ms(x_cap.numel() * 4 + max(x_cap[0].numel(), 1) * 4))
    log(f"ordered_sum: captured {tuple(x_cap.shape)} and {len(fixtures) - 1} fixtures ok "
        "(exact, against the plain version on the card and on the CPU)")
    for name in ("structural_accepts", "stack_sweep", "frontier_active", "chunk_gate",
                 "ordered_sum"):
        r = out[name]
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
    return out


# K11 cross's gate cases: (satisfied, capped, offline, conflict) of the
# closed row it reads — done, unsatisfied, capped, offline, conflict.
CROSS_CASES = [(1, 0, 0, 0), (0, 0, 0, 0), (1, 1, 0, 0), (1, 0, 1, 0), (1, 0, 0, 3)]


def check_pipeline_kernels(torch, np, wrappers, log, time_ms, models):
    """The pipeline's kernels against their plain versions, all exact: K9
    batch for the full stack on the mid snapshot, the second mid snapshot
    (its dead broker) and the large rung, every row, against the plain
    version on CPU copies of the inputs (the CPU running sums are the order
    the kernel reproduces); K11 cross's gate on its case table with each
    entry state; its touched pass on seeded placement changes of the large
    rung (broker only, leadership only, disk only, invalid replicas,
    replicas moved away and back, out-of-range brokers) OR-ed into a seeded
    mask; K11's close with a conflict count and its open gated from an
    earlier closed row."""
    from cruise_control_tpu_torch.analyzer import optimizer as opt
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays

    out = {}
    con = BalancingConstraint.default()
    specs = tuple(goals_by_priority(STACK))

    def on_cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)

    # ---- K9 batch.
    kb = wrappers["frontier_active_batch"]
    for label, m in models.items():
        inp = gk.frontier_inputs_batch(specs, m, BrokerArrays.from_model(m), con)
        got, count = kb(*inp)
        ref, ref_count = gk.frontier_active_batch_plain(*on_cpu(inp))
        if not (torch.equal(got.cpu(), ref) and torch.equal(count.cpu(), ref_count)):
            raise RuntimeError(f"K9 batch disagrees with the plain version on {label}")
        log(f"K9 frontier_active_batch {label}: populations {ref_count.tolist()} (exact)")
    large = models["large"]
    inp_l = gk.frontier_inputs_batch(specs, large, BrokerArrays.from_model(large), con)
    G, B = inp_l[0].shape
    n_band = int(inp_l[3].sum())
    out["frontier_active_batch"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: kb(*inp_l)),
        plain_ms=time_ms(torch, lambda: gk.frontier_active_batch_plain(*inp_l)),
        library_ms=None, bound_ms=bound_ms(n_band * B * 12 + B * 6 + G * 5 + G * B + G * 4))

    # ---- K11 cross, the gate.
    kc = wrappers["cross_gate"]
    dev = large.device

    def cross_args(case, sat, off):
        packed = torch.zeros((11,), dtype=torch.int32, device=dev)
        packed[3], packed[4], packed[9], packed[10] = case
        return (torch.tensor([5, 9, 3, 2, 5, 77, 64], dtype=torch.int32, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev),
                torch.tensor([sat], device=dev), torch.tensor([off], device=dev), packed, 7)

    n_cases = 0
    for case in CROSS_CASES:
        for sat, off in ((False, False), (True, False), (True, True)):
            a, b = cross_args(case, sat, off), cross_args(case, sat, off)
            kc(*a)
            opt.cross_gate_plain(*b)
            if not all(torch.equal(x, y) for x, y in zip(a[:2], b[:2])):
                raise RuntimeError(f"K11 cross gate disagrees on case {case} {sat} {off}")
            n_cases += 1
    a = cross_args(CROSS_CASES[0], False, False)
    out["cross_gate"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: kc(*a)),
        plain_ms=time_ms(torch, lambda: opt.cross_gate_plain(*a)), library_ms=None,
        bound_ms=bound_ms(2 + 4 * 4 + 7 * 4 + 4))
    log(f"K11 cross_gate: {n_cases} cases ok (exact)")

    # ---- K11 cross, the touched pass.
    kt = wrappers["chunk_touched"]
    rng = np.random.default_rng(SEED)
    R = large.num_replicas_padded
    valid = large.replica_valid
    rb0, rl0, rd0 = (large.replica_broker.clone(), large.replica_is_leader.clone(),
                     large.replica_disk.clone())
    per = min(512, int(valid.sum()) // 6)
    rows = rng.permutation(np.flatnonzero(valid.cpu().numpy()))[:6 * per]
    groups = [torch.from_numpy(g).to(dev) for g in np.split(rows, 6)]
    rb, rl, rd = rb0.clone(), rl0.clone(), rd0.clone()
    rb[groups[0]] = (rb0[groups[0]] + 1 + torch.from_numpy(
        rng.integers(0, B - 1, per).astype(np.int32)).to(dev)) % B     # broker only
    rl[groups[1]] = ~rl0[groups[1]]                                       # leadership only
    rd[groups[2]] = rd0[groups[2]] + 1                                    # disk only
    rb[groups[3]] = rb0[groups[3]]                                        # away and back
    rb[groups[4][:per // 2]] = -3                                         # out of range
    rb[groups[4][per // 2:]] = B + 5
    rb[groups[5]] = (rb0[groups[5]] + 7) % B                              # broker and disk
    rd[groups[5]] = rd0[groups[5]] + 7
    invalid = torch.from_numpy(np.flatnonzero(~valid.cpu().numpy())).to(dev)  # mark nothing
    if invalid.numel():
        rb[invalid] = (rb0[invalid] + 3) % B
    touched0 = torch.from_numpy(rng.random(B) < 0.05).to(dev)
    args = (rb0, rl0, rd0, rb, rl, rd, valid)
    got = touched0.clone()
    kt(*args, got)
    ref = touched0.cpu().clone()
    opt.chunk_touched_plain(*on_cpu(args), ref)
    if not torch.equal(got.cpu(), ref):
        raise RuntimeError("K11 cross touched pass disagrees with the plain version")
    scratch = touched0.clone()
    out["chunk_touched"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: kt(*args, scratch)),
        plain_ms=time_ms(torch, lambda: opt.chunk_touched_plain(*args, scratch)),
        library_ms=None, bound_ms=bound_ms(R * 19 + B))
    log(f"K11 cross chunk_touched: R={R} B={B}, {rows.size} changed rows and "
        f"{invalid.numel()} invalid rows, {int(ref.sum())} brokers touched (exact)")

    # ---- K11: the close's conflict count, the open gated from an earlier row.
    kg = wrappers["chunk_gate"]
    n_gate = 0
    for capped_src in (0, 1):
        for conflict in (False, True):
            outs = []
            mask = torch.from_numpy(rng.random(B) < 0.3).to(dev) if conflict else None
            for fn in (kg, opt.chunk_gate_plain):
                c = torch.tensor([4, 9, 3, 2, 5, 77, 4], dtype=torch.int32, device=dev)
                e = torch.ones((1,), dtype=torch.int32, device=dev)
                packed = torch.full((11,), -7, dtype=torch.int32, device=dev)
                src = torch.zeros((11,), dtype=torch.int32, device=dev)
                src[4] = capped_src
                fn(c, e, torch.tensor([False], device=dev), torch.tensor([True], device=dev),
                   torch.tensor([12], dtype=torch.int32, device=dev), packed, True, True, 16,
                   touched=ref.to(dev) if conflict else None, mask=mask, gate_src=src)
                outs.append((c.cpu(), e.cpu(), packed.cpu()))
            if not all(torch.equal(x, y) for x, y in zip(*outs)):
                raise RuntimeError(f"K11 disagrees with its conflict count or source gate "
                                   f"({capped_src}, {conflict})")
            n_gate += 1
    log(f"K11 chunk_gate conflict count and source gate: {n_gate} cases ok (exact)")
    for name in ("frontier_active_batch", "cross_gate", "chunk_touched"):
        r = out[name]
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
    return out


def _k5b_bytes(prevs, model, cand):
    """Bytes K5b must move: each lane's action, replica, endpoints and
    partner (20) and its flag written (1); the rack branches' replica
    partitions and brokers, partition rows and broker racks (and the
    replication factors for the quota), the topic branch's replica topics,
    (topic, broker) counts and topic bands, the min-leaders branch's replica
    topics and leader flags, alive brokers, (topic, broker) leader counts
    and designated flags, each read once, whole."""
    R, B, T = model.num_replicas_padded, model.num_brokers, model.num_topics
    kinds = {p.kind for p in prevs}
    tables = 0
    if kinds & {"rack", "rack_distribution"}:
        tables += R * 8 + model.partition_replicas.numel() * 4 + B * 4
    if "rack_distribution" in kinds:
        tables += model.num_partitions * 4
    if "topic_replica_distribution" in kinds:
        tables += R * 4 + T * B * 4 + T * 8
    if "min_topic_leaders" in kinds:
        tables += R * 5 + B + T * B * 4 + T
    intra = kinds & set(INTRA_KINDS)
    if intra:
        # The lanes' disks; the replicas' leader flags and DISK columns;
        # the disk loads and each earlier disk goal's upper band.
        tables += cand.k * 8 + R * 9 + model.num_disks * 4 * (1 + len(intra))
    return cand.k * 21 + tables


def _k9_bytes(specs, model):
    """Bytes K9's sweep must move: the alive and valid flags, each broker
    column the stack's kinds read (replica and leader counts, the load and
    capacity columns, potential NW_OUT, leader bytes-in), the rack goals'
    replica brokers, partitions and sibling rows and the broker racks (and
    the replication factors), the preferred-leader goal's leader, broker,
    partition and offline rows, preferred column and broker states, the
    topic goal's [T, B] counts, the min-leaders goal's [T, B] leader counts
    and designated flags, every replica's offline and valid flags, each read
    once; G + 1 flags written."""
    R, B, T = model.num_replicas_padded, model.num_brokers, model.num_topics
    cols = set()
    extra = 0
    for s in specs:
        if s.is_hard:
            cols.add("rc")
        if s.kind in ("capacity", "resource_distribution"):
            cols |= {f"load{s.resource}", f"cap{s.resource}"}
        elif s.kind == "potential_nw_out":
            cols |= {"pnw", "cap2"}
        elif s.kind in ("replica_capacity", "replica_distribution"):
            cols.add("rc")
        elif s.kind == "leader_replica_distribution":
            cols.add("lc")
        elif s.kind == "leader_bytes_in":
            cols.add("lbi")
        if s.kind in ("rack", "rack_distribution") and "rack" not in cols:
            cols.add("rack")
            extra += R * 8 + model.partition_replicas.numel() * 4 + B * 4
        if s.kind == "rack_distribution" and "rf" not in cols:
            cols.add("rf")
            extra += model.num_partitions * 4
        elif s.kind == "topic_replica_distribution" and "topic" not in cols:
            cols.add("topic")
            extra += T * B * 4
        elif s.kind == "preferred_leader" and "preferred" not in cols:
            # Leader flags, brokers, partitions and offline flags of the
            # replicas, the preferred column and the broker states.
            cols.add("preferred")
            extra += R * 10 + model.num_partitions * 4 + B
        elif s.kind == "min_topic_leaders" and "leaders" not in cols:
            cols.add("leaders")
            extra += T * B * 4 + T
        elif s.kind in INTRA_KINDS and "disks" not in cols:
            # The disk loads, capacities and valid flags, each broker's
            # disk list.
            cols.add("disks")
            extra += model.num_disks * 9 + model.broker_disks.numel() * 4
    per_broker = len(cols - {"rack", "rf", "topic", "preferred", "leaders", "disks"})
    return 2 * B + 4 * B * per_broker + extra + 2 * R + len(specs) + 1


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
    the topic counts and limits, the rack branches' replica partitions,
    brokers, conflict flags, partition rows and broker racks (and the
    replication factors), the preferred-leader branch's partner, partition,
    broker, leader and valid rows, preferred column and broker states, or
    the min-leaders branch's replica topics and leader flags, (topic,
    broker) leader counts and designated flags."""
    from cruise_control_tpu_torch.analyzer.goals.kernels import _DELTA_OF_KIND
    R, B, T = model.num_replicas_padded, model.num_brokers, model.num_topics
    lane = 16 + 1 + 5 + (1 if accepted is not None else 0)
    tables = R + B
    if spec.kind in ("rack", "rack_distribution"):
        tables += R * (4 + 4 + 1) + model.partition_replicas.numel() * 4 + B * 4
        if spec.kind == "rack_distribution":
            tables += model.num_partitions * 4
    elif spec.kind == "topic_replica_distribution":
        tables += R * 4 + T * B * 4 + T * 12
    elif spec.kind == "preferred_leader":
        # The lane's partner; the replicas' partitions, brokers, leader and
        # valid flags, the preferred column and the broker states.
        lane += 4
        tables += R * 10 + model.num_partitions * 4 + B
    elif spec.kind == "min_topic_leaders":
        tables += R * 5 + T * B * 4 + T
    elif spec.kind in INTRA_KINDS:
        # The lane's partner and disks; the replicas' leader flags and the
        # DISK columns of both load rows; the disks' loads, bands,
        # capacities and brokers.
        lane += 12
        tables += R * 9 + model.num_disks * 20
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


# ---------------------------------------------------------------------------
# The goal kinds beyond the 15-goal stack (phase 16)
# ---------------------------------------------------------------------------

# The facade's default stack when no goals are configured
# (cruise_control_tpu/analyzer/goals/specs.py:122-139, api/facade.py:146).
DEFAULT_GOAL_ORDER = STACK[:1] + ["MinTopicLeadersPerBrokerGoal"] + STACK[1:]
KAFKA_ASSIGNER = ["KafkaAssignerEvenRackAwareGoal", "KafkaAssignerDiskUsageDistributionGoal"]
# RackAwareDistributionGoal and a goal after it (so that its veto runs).
RACK_DIST_GOALS = ["RackAwareDistributionGoal", "ReplicaDistributionGoal"]
# The default order's first goals with no topic goal: the (topic, broker)
# budgets, and K3's topic cuts, come from MinTopicLeaders alone.
WINDOW_GOALS = DEFAULT_GOAL_ORDER[:2] + ["ReplicaDistributionGoal"]
# Every inter-broker goal kind and flag: K10's stack in its kernel checks.
K10_GOALS = DEFAULT_GOAL_ORDER + ["PreferredLeaderElectionGoal",
                                  "RackAwareDistributionGoal"] + KAFKA_ASSIGNER
# 50 brokers on 2 racks at RF 3 (a quota of 2 replicas a rack), seed 2026.
TWO_RACKS = (50, 2, 40, 84.0, 3)
DESIGNATED_TOPICS = 4  # the rung's topics with the most partitions
NEW_KINDS = ("preferred_leader", "min_topic_leaders", "rack_distribution")
# The new modes' launch counters: name -> (source, JAX function it replaces,
# the run whose launches the kernel line reports).
_JK = "cruise_control_tpu/analyzer/goals/kernels.py"
MODE_KERNELS = {
    "goal_masks[preferred_leader]": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                                     f"{_JK}:560", "demote"),
    "goal_masks[min_topic_leaders]": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                                      f"{_JK}:569", "large designated"),
    "goal_masks[rack_distribution]": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                                      f"{_JK}:599", "rack distribution"),
    "structural_accepts[min_topic_leaders]": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                                              f"{_JK}:476", "large designated"),
    "structural_accepts[rack_distribution]": ("cruise_control_tpu_torch/csrc/goal_masks.cu",
                                              f"{_JK}:511", "rack distribution"),
    "stack_sweep[preferred_leader]": ("cruise_control_tpu_torch/csrc/stack_sweep.cu",
                                      "cruise_control_tpu/analyzer/optimizer.py:2332",
                                      "demote"),
    "stack_sweep[min_topic_leaders]": ("cruise_control_tpu_torch/csrc/stack_sweep.cu",
                                       "cruise_control_tpu/analyzer/optimizer.py:2332",
                                       "large designated"),
    "stack_sweep[rack_distribution]": ("cruise_control_tpu_torch/csrc/stack_sweep.cu",
                                       "cruise_control_tpu/analyzer/optimizer.py:2332",
                                       "rack distribution"),
    "stack_sweep_batch[preferred_leader]": ("cruise_control_tpu_torch/csrc/placement_score.cu",
                                            "cruise_control_tpu/analyzer/optimizer.py:2392",
                                            "demote execution"),
    "stack_sweep_batch[min_topic_leaders]": (
        "cruise_control_tpu_torch/csrc/placement_score.cu",
        "cruise_control_tpu/analyzer/optimizer.py:2392", "default order execution"),
    "stack_sweep_batch[rack_distribution]": (
        "cruise_control_tpu_torch/csrc/placement_score.cu",
        "cruise_control_tpu/analyzer/optimizer.py:2392", "rack distribution execution"),
    "prefix_cut[topic]": ("cruise_control_tpu_torch/csrc/prefix_cut.cu", f"{_JK}:1031",
                          "window"),
}


def designated_constraint(torch, model, n=DESIGNATED_TOPICS):
    """The default constraint with the ``n`` topics of ``model`` that have the
    most partitions designated for MinTopicLeadersPerBrokerGoal (one leader
    each per broker)."""
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    valid = model.partition_valid.cpu()
    counts = torch.bincount(model.partition_topic.cpu()[valid].long(),
                            minlength=model.num_topics)
    top = torch.argsort(-counts, stable=True)[:n].tolist()
    return dataclasses.replace(BalancingConstraint.default(), min_leader_topic_ids=tuple(top),
                               min_topic_leaders_per_broker=1), counts[top].tolist()


def demoted(torch, model, brokers):
    """``model`` with ``brokers`` DEMOTED, and request options excluding them
    from leadership: what the facade's demote_brokers hands the optimizer."""
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
    from cruise_control_tpu_torch.model.tensor_model import BrokerState
    for b in brokers:
        model = model.set_broker_state(b, BrokerState.DEMOTED)
    mask = torch.zeros((model.num_brokers,), dtype=torch.bool, device=model.device)
    mask[list(brokers)] = True
    options = dataclasses.replace(OptimizationOptions.none(model),
                                  broker_excluded_leadership=mask)
    return model, options


def broken_preference(torch, model):
    """The second replica leads every partition of RF >= 2
    (tests/test_goals_extended.py:30-41)."""
    pr = model.partition_replicas
    rows = pr[:, 1] >= 0
    lead = model.replica_is_leader.clone()
    lead[pr[rows, 0].long()] = False
    lead[pr[rows, 1].long()] = True
    return model.replace(replica_is_leader=lead)


def one_rack(torch, np, model, every=3):
    """Every ``every``-th partition's replicas moved onto distinct brokers of
    rack 0: over the quota of a 2-rack, RF-3 cluster."""
    rb = model.replica_broker.cpu().numpy().copy()
    on_rack0 = np.nonzero(model.broker_rack.cpu().numpy() == 0)[0]
    pr = model.partition_replicas.cpu().numpy()
    for p in range(0, pr.shape[0], every):
        reps = pr[p][pr[p] >= 0]
        if len(reps) <= len(on_rack0):
            rb[reps] = on_rack0[(p + np.arange(len(reps))) % len(on_rack0)]
    first = model.broker_first_disk.cpu().numpy()
    t = torch.from_numpy(rb.astype(np.int32)).to(model.device)
    disk = torch.from_numpy(first[rb].astype(np.int32)).to(model.device)
    return model.replace(replica_broker=t, replica_original_broker=t, replica_disk=disk)


def movable_leaders_on(model, brokers):
    """Leaders on ``brokers`` with a valid, online sibling on an alive,
    non-demoted broker (api/facade.py:890-909 ``_movable_leaders_on``)."""
    import numpy as np
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


def _clone(torch, x):
    """A deep copy of a kernel argument: tensors cloned, dataclasses of
    tensors (models, arrays, candidates) field by field."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(torch, a) for a in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(torch, getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


class ModeCapture:
    """While entered, keeps a deep copy of the inputs of the first launch of
    K5, K5b and K9's sweep that computes each goal kind of ``kinds``, and of
    K3's first cut and K1's first segment sum of each segment mode of
    ``kinds`` (outside CUDA graph captures: a graph's eager warm-up run
    calls every wrapper with its real inputs); with ``device``, only of
    launches on that device's type (a model built on the CPU first sums its
    disks there)."""

    def __init__(self, torch, cuda, kinds=NEW_KINDS + ("topic",), device=None):
        self.torch, self.cuda, self.inputs = torch, cuda, {}
        self.kinds = set(kinds)
        self.device = device
        self.real = cuda.record

    def __enter__(self):
        self.cuda.record = self.record
        return self

    def __exit__(self, *exc):
        self.cuda.record = self.real

    def record(self, name, args):
        self.real(name, args)
        if name == "goal_masks":
            kinds = {args[0].kind}
        elif name in ("structural_accepts", "stack_sweep"):
            kinds = {s.kind for s in args[0]}
        elif name in ("prefix_cut", "segment_sum"):
            kinds = {args[-1]}
        else:
            return
        torch = self.torch
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        on = args[0].device if name in ("prefix_cut", "segment_sum") else args[1].device
        if self.device is not None and on.type != torch.device(self.device).type:
            return
        for kind in kinds & self.kinds:
            if (name, kind) not in self.inputs:
                self.inputs[(name, kind)] = _clone(torch, args)


def log_goals(log, label, run, kinds=("MinTopicLeadersPerBrokerGoal",
                                      "PreferredLeaderElectionGoal",
                                      "RackAwareDistributionGoal")):
    """One line per goal of ``run`` (flags, steps, actions, wall), and the
    new goals' flags before and after."""
    for g in run.goal_results:
        log(f"  {label} {g.name:38s} steps={g.steps:3d} actions={g.actions_applied:5d} "
            f"satisfied {g.satisfied_before}->{g.satisfied_after} {g.duration_s:.3f}s "
            f"pipelined={g.pipelined} fused={g.fused_group}")
    return {g.name: (g.satisfied_before, g.satisfied_after) for g in run.goal_results
            if g.name in kinds}


def leaders_moved(before, after):
    """Partitions whose leader replica changed."""
    changed = (before.replica_is_leader != after.replica_is_leader) & before.replica_valid
    return int(changed.sum()) // 2


def verify_if_hard_held(log, label, initial, run, goals, con):
    """``verify_run`` when every hard goal ended satisfied (a solve may leave
    one unsatisfied, as ``facade._optimize``'s raise_on_hard_failure=False
    allows); the unsatisfied hard goals otherwise, logged."""
    from cruise_control_tpu_torch.analyzer import proposals as props
    from cruise_control_tpu_torch.analyzer.verifier import verify_run
    bad = [g.name for g in run.goal_results if g.is_hard and not g.satisfied_after]
    if bad:
        log(f"  {label}: hard goals left unsatisfied {bad}; verify_run skipped")
        return False
    verify_run(initial, run, goals, constraint=con, proposals=props.diff(initial, run.model))
    return True


def all_counts(cx, fn):
    """``fn()`` with every launch counter set to 0 just before: (its result,
    its wall, every counter read just after)."""
    cx.cuda.reset_launch_counts()
    cx.torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    cx.torch.cuda.synchronize()
    return out, time.monotonic() - t0, cx.cuda.launch_counts()


def need_launched_in(cx, label, c, names):
    idle = [n for n in names if c.get(n, 0) == 0]
    if not cx.rehearse and idle:
        raise RuntimeError(f"{label}: kernels not launched: {idle}")


def card_against_cpu(cx, label, make, goals, con, **kw):
    """``goals`` on the card (a warm-up that captures, then a timed run with
    the counters set to 0 just before) and on the CPU plain path: per-goal
    rows and placement equal.  Returns (card model, card run, wall,
    counts, CPU run)."""
    model = make(cx.dev)
    cx.fused_run(model, goals, constraint=con, **kw)
    run, wall, c = all_counts(cx, lambda: cx.fused_run(model, goals, constraint=con, **kw))
    t0 = time.monotonic()
    run_cpu = cx.opt.optimize(make("cpu"), goals, constraint=con, fused=True,
                              raise_on_hard_failure=False, device="cpu", **kw)
    cx.compare_card_cpu(run, run_cpu, cx.same_placement, cx.log, label,
                        time.monotonic() - t0)
    return model, run, wall, c


def check_goal_kinds(cx):
    """Phase 16: the goal kinds beyond the 15-goal stack on their paths.
    ``cx`` carries main's helpers.  Returns (kernel rows of the new modes,
    launch counts per run, summary)."""
    torch, np, opt, gk, cuda = cx.torch, cx.np, cx.opt, cx.gk, cx.cuda
    log, rehearse = cx.log, cx.rehearse
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    counts, summary = {}, {}
    run_all_counts = functools.partial(all_counts, cx)
    need_launched = functools.partial(need_launched_in, cx)
    card_cpu = functools.partial(card_against_cpu, cx)

    capture = ModeCapture(torch, cuda)
    with capture:
        # 1. The default order with designated topics: mid on the grouped
        # path (card against CPU), large on the sequential and the pipelined
        # path; then the order with no designated topic.
        mid_con, mid_top = designated_constraint(torch, cx.mid)
        log(f"designated topics (mid): {mid_con.min_leader_topic_ids}, partitions {mid_top}")
        mid_d, run_mid, mid_wall, c = card_cpu(
            "mid default order (designated)",
            lambda d: cx.generate_cluster(cx.spec_of(cx.mid_rung), device=d),
            DEFAULT_GOAL_ORDER, mid_con)
        counts["mid designated"] = c
        need_launched("mid default order", c, ["goal_masks[min_topic_leaders]",
                                                "structural_accepts[min_topic_leaders]",
                                                "stack_sweep[min_topic_leaders]",
                                                "prefix_cut[topic]"])
        flags = log_goals(log, "mid-designated", run_mid)
        verify_if_hard_held(log, "mid-designated", mid_d, run_mid, DEFAULT_GOAL_ORDER, mid_con)
        summary["mid designated"] = dict(
            wall_s=round(mid_wall, 4), steps=sum(g.steps for g in run_mid.goal_results),
            min_leaders=flags.get("MinTopicLeadersPerBrokerGoal"),
            leaders_moved=leaders_moved(mid_d, run_mid.model))
        log(f"mid default order (designated): {summary['mid designated']}")

        # The window of goals before the topic goal, no designated topic:
        # the topic cuts come from the min-leaders budgets alone.
        _, win_wall, c = run_all_counts(lambda: cx.fused_run(cx.mid, WINDOW_GOALS))
        counts["window"] = c
        log(f"mid {WINDOW_GOALS} (no designated topic): {win_wall:.3f} s, K3 topic cuts "
            f"{c['prefix_cut[topic]']}, broker cuts {c['prefix_cut[broker]']}")
        need_launched("window", c, ["prefix_cut[topic]"])

        large = cx.large
        con_l, top_l = designated_constraint(torch, large)
        log(f"designated topics (large): {con_l.min_leader_topic_ids}, partitions {top_l}")
        runs_l = {}
        for label, kw in (("sequential", cx.per_goal), ("pipelined", {})):
            cx.fused_run(large, DEFAULT_GOAL_ORDER, constraint=con_l, **kw)  # captures
            sweeps0 = dict(opt.SWEEP_COUNTERS)
            run, wall, c = run_all_counts(
                lambda: cx.fused_run(large, DEFAULT_GOAL_ORDER, constraint=con_l, **kw))
            runs_l[label] = run
            counts[f"large designated {label}"] = c
            flags = log_goals(log, f"large-designated-{label}", run)
            report = (cx.pipeline_report if label == "pipelined" else cx.per_goal_report)(
                run, log, f"large-designated-{label}")
            summary[f"large designated {label}"] = dict(
                wall_s=round(wall, 4), pipelined=run.pipelined,
                goals_overlapped=run.goals_overlapped, goals_fused=run.goals_fused,
                goals_skipped=run.goals_skipped, min_leaders=flags.get(
                    "MinTopicLeadersPerBrokerGoal"),
                leaders_moved=leaders_moved(large, run.model),
                sweeps={k: opt.SWEEP_COUNTERS[k] - sweeps0[k] for k in sweeps0}, **report)
            log(f"large default order (designated) {label}: "
                f"{summary[f'large designated {label}']}")
        counts["large designated"] = counts["large designated pipelined"]
        need_launched("large designated pipelined", counts["large designated"],
                      [n for n, v in MODE_KERNELS.items() if v[2] == "large designated"])
        if not cx.same_placement(runs_l["pipelined"], runs_l["sequential"]):
            raise RuntimeError("the large default order (designated): the pipelined run "
                               "placed replicas otherwise than the sequential one")
        verify_if_hard_held(log, "large-designated", large, runs_l["pipelined"],
                            DEFAULT_GOAL_ORDER, con_l)
        if not rehearse:
            prof = cx.profile_mid(torch, lambda: cx.fused_run(large, DEFAULT_GOAL_ORDER,
                                                              constraint=con_l),
                                  summary["large designated pipelined"]["wall_s"],
                                  summary["large designated pipelined"]["steps"],
                                  "large-designated-pipelined", log)
            summary["large designated pipelined"]["busy"] = prof["busy"]
        cx.fused_run(large, DEFAULT_GOAL_ORDER)  # captures
        run_free, free_wall, c = run_all_counts(lambda: cx.fused_run(large, DEFAULT_GOAL_ORDER))
        counts["large no designated"] = c
        cx.check_run("large-no-designated", large, run_free, DEFAULT_GOAL_ORDER)
        summary["large no designated"] = dict(
            wall_s=round(free_wall, 4), steps=sum(g.steps for g in run_free.goal_results),
            pipelined=run_free.pipelined, topic_cuts=c["prefix_cut[topic]"])
        log(f"large default order (no designated topic): {summary['large no designated']}")
        need_launched("large no designated", c, ["prefix_cut[topic]"])

        # 2. Demote: every tenth broker DEMOTED with its leadership excluded,
        # PreferredLeaderElectionGoal as facade.demote_brokers runs it; then
        # the broken-preference recipe.
        brokers = list(range(0, large.num_brokers, 10))
        model_d, opts_d = demoted(torch, large, brokers)
        before_left = movable_leaders_on(model_d, brokers)
        cx.fused_run(model_d, ["PreferredLeaderElectionGoal"], options=opts_d)
        run_d, wall_d, c = run_all_counts(lambda: cx.fused_run(
            model_d, ["PreferredLeaderElectionGoal"], options=opts_d))
        counts["demote"] = c
        left = movable_leaders_on(run_d.model, brokers)
        moved = int((run_d.model.replica_broker != model_d.replica_broker).sum())
        summary["demote"] = dict(brokers=len(brokers), movable_leaders_before=before_left,
                                 movable_leaders_after=left, replicas_moved=moved,
                                 leaders_moved=leaders_moved(model_d, run_d.model),
                                 wall_s=round(wall_d, 4),
                                 steps=sum(g.steps for g in run_d.goal_results))
        log_goals(log, "demote", run_d)
        log(f"demote at {large.num_brokers} brokers: {summary['demote']}")
        if left or moved or not before_left:
            raise RuntimeError(f"demote: {left} movable leaders left on demoted brokers, "
                               f"{moved} replicas moved ({before_left} before)")
        need_launched("demote", c, [n for n, v in MODE_KERNELS.items() if v[2] == "demote"])
        model_p = broken_preference(torch, large)
        run_p = cx.fused_run(model_p, ["PreferredLeaderElectionGoal"])
        pref = run_p.model.partition_replicas[:, 0]
        led = bool(run_p.model.replica_is_leader[pref[pref >= 0].long()].all())
        summary["broken preference"] = dict(
            leaders_moved=leaders_moved(model_p, run_p.model), preferred_lead=led,
            replicas_moved=int((run_p.model.replica_broker != model_p.replica_broker).sum()))
        log(f"broken preference at {large.num_brokers} brokers: {summary['broken preference']}")
        if not led or summary["broken preference"]["replicas_moved"]:
            raise RuntimeError("broken preference: a preferred replica does not lead, or a "
                               "replica moved")

        # 3. The kafka-assigner pair on mid, and rack distribution on the
        # 2-rack cluster; each card against CPU.
        con0 = BalancingConstraint.default()
        _, run_k, wall_k, c = card_cpu(
            "mid kafka-assigner",
            lambda d: cx.generate_cluster(cx.spec_of(cx.mid_rung), device=d),
            KAFKA_ASSIGNER, con0)
        counts["kafka-assigner"] = c
        racks = int(run_k.model.partition_rack_counts().max())
        log_goals(log, "kafka-assigner", run_k)
        summary["kafka-assigner"] = dict(wall_s=round(wall_k, 4), max_replicas_a_rack=racks)
        log(f"mid kafka-assigner: {summary['kafka-assigner']}")
        if racks > 1:
            raise RuntimeError(f"kafka-assigner: {racks} replicas of a partition on a rack")
        two_racks = cx.two_racks_rung
        rd_model, run_rd, wall_rd, c = card_cpu(
            f"{two_racks[0]}-broker 2-rack rack distribution",
            lambda d: one_rack(torch, np, cx.generate_cluster(cx.spec_of(two_racks), device=d)),
            RACK_DIST_GOALS, con0)
        counts["rack distribution"] = c
        flags = log_goals(log, "rack-distribution", run_rd)
        summary["rack distribution"] = dict(wall_s=round(wall_rd, 4),
                                            flags=flags.get("RackAwareDistributionGoal"))
        log(f"2-rack rack distribution: {summary['rack distribution']}")
        if flags.get("RackAwareDistributionGoal") != (False, True):
            raise RuntimeError(f"rack distribution: flags {flags}")
        need_launched("rack distribution", c,
                      [n for n, v in MODE_KERNELS.items() if v[2] == "rack distribution"])

        # 4. The default order with designated topics at 100 brokers,
        # pipelined: card against CPU.
        h_con, _ = designated_constraint(torch, cx.generate_cluster(
            cx.spec_of(cx.hundred_rung), device="cpu"))
        card_cpu(f"{cx.hundred_rung[0]}-broker default order (designated) pipelined",
                 lambda d: cx.generate_cluster(cx.spec_of(cx.hundred_rung), device=d),
                 DEFAULT_GOAL_ORDER, h_con)

    # 5. The ledger of executing such solves scores the new kinds in K10.
    mid_dem, opts_m = demoted(torch, cx.mid, list(range(0, cx.mid.num_brokers, 10)))
    run_md = cx.fused_run(mid_dem, ["PreferredLeaderElectionGoal"], options=opts_m)
    for label, before, run, con in (
            ("default order", mid_d, run_mid, mid_con),
            ("demote", mid_dem, run_md, con0),
            ("rack distribution", rd_model, run_rd, con0)):
        s, c = cx.execute(before, run, con, f"mid {label}" if label != "rack distribution"
                          else f"{two_racks[0]}-broker {label}")
        counts[f"{label} execution"] = c
        summary[f"{label} execution"] = s
        need_launched(f"{label} execution", c,
                      [n for n, v in MODE_KERNELS.items() if v[2] == f"{label} execution"])

    # 6. The new modes against their plain twins on the captured inputs,
    # healthy and with a dead broker.
    rows = check_mode_kernels(torch, np, gk, cuda, capture.inputs, log, cx.timer, rehearse)
    for name, (_, _, run_label) in MODE_KERNELS.items():
        if name in rows:
            rows[name]["launches"] = counts[run_label].get(name, 0)
            rows[name]["launches_run"] = run_label
    return rows, counts, summary


def check_mode_kernels(torch, np, gk, cuda, inputs, log, time_ms, rehearse):
    """K5's, K5b's and K9's new modes on the inputs ``ModeCapture`` kept,
    and on the same inputs with broker 2 dead: the kernel against its plain
    twin, exactly (score bits, flags).  Each timed (CUDA events, median;
    device time under the profiler) beside its plain twin and its bound.
    K3's topic cuts were held against their twin in phase 4's K3 check (the
    same kernel); their row reports the launches only."""
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    from cruise_control_tpu_torch.model.tensor_model import BrokerState
    wrappers = {"goal_masks": (gk.goal_masks, gk.goal_masks_plain),
                "structural_accepts": (gk.structural_accepts, gk.structural_accepts_plain),
                "stack_sweep": (gk.stack_satisfied, gk.stack_satisfied_plain)}
    rows = {}
    topic_cut = inputs.pop(("prefix_cut", "topic"), None)
    if topic_cut is not None:
        args = topic_cut[:8]
        got = gk.prefix_cut_admit(*topic_cut)
        if not torch.equal(got, gk.prefix_cut_admit_plain(*args)):
            raise RuntimeError("K3's topic cut disagrees with its plain twin")
        K, C, S = args[0].shape[0], args[2].shape[1], args[7]
        rows["prefix_cut[topic]"] = dict(
            max_abs_err=0.0, ms=time_ms(torch, lambda: gk.prefix_cut_admit(*topic_cut)),
            plain_ms=time_ms(torch, lambda: gk.prefix_cut_admit_plain(*args)),
            library_ms=None,
            bound_ms=bound_ms(K * 10 + int(args[3].sum()) * 4 * C + S * 12 * C),
            device_ms=None if rehearse else device_ms(
                torch, lambda: gk.prefix_cut_admit(*topic_cut), ("prefix_cut_kernel",
                                                                 "scan_blocks_kernel",
                                                                 "block_totals_kernel",
                                                                 "add_back_kernel"), log),
            shape=dict(K=K, C=C, S=S))
        log(f"prefix_cut[topic]: K={K} C={C} S={S} equal to the plain twin (exact)")
    elif not rehearse:
        raise RuntimeError("no captured input for K3's topic cut")
    for (name, kind), args in sorted(inputs.items()):
        kernel, plain = wrappers[name]
        specs = (args[0],) if name == "goal_masks" else tuple(args[0])
        model = args[1]
        checked = 0
        for m in (model, model.set_broker_state(2, BrokerState.DEAD)):
            arr = BrokerArrays.for_specs(m, specs)
            call = (args[0], m, arr) + tuple(args[3:])
            got, ref = kernel(*call), plain(*call)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g, r in zip(got, ref):
                g = g.view(torch.int32) if g.dtype == torch.float32 else g
                r = r.view(torch.int32) if r.dtype == torch.float32 else r
                if not torch.equal(g, r):
                    raise RuntimeError(f"{name}[{kind}] disagrees with its plain twin "
                                       f"({int((g != r).sum())} entries)")
            checked += 1
        # Time the mode alone: K9 on the goals of this kind only.
        if name == "stack_sweep":
            timed = (tuple(s for s in args[0] if s.kind == kind),) + tuple(args[1:])
        else:
            timed = args
        names = {"goal_masks": ("goal_masks_kernel",),
                 "structural_accepts": ("structural_accepts_kernel",),
                 "stack_sweep": ("stack_sweep_kernel",)}[name]
        nbytes = {"goal_masks": lambda: _k5_bytes(args[0], model, args[3].k, args[6]),
                  "structural_accepts": lambda: _k5b_bytes(
                      [s for s in args[0] if s.kind == kind], model, args[3]),
                  "stack_sweep": lambda: _k9_bytes(timed[0], model)}[name]()
        rows[f"{name}[{kind}]"] = dict(
            max_abs_err=0.0, ms=time_ms(torch, lambda: kernel(*timed)),
            plain_ms=time_ms(torch, lambda: plain(*timed)), library_ms=None,
            bound_ms=bound_ms(nbytes),
            device_ms=None if rehearse else device_ms(torch, lambda: kernel(*timed), names,
                                                      log),
            shape=dict(K=args[3].k if name != "stack_sweep" else None,
                       G=len(timed[0]) if name == "stack_sweep" else None,
                       R=model.num_replicas_padded, B=model.num_brokers,
                       T=model.num_topics))
        r = rows[f"{name}[{kind}]"]
        log(f"{name}[{kind}]: healthy and dead broker equal to the plain twin (exact, "
            f"{checked} inputs); kernel {r['ms']:.4f} ms (device {r['device_ms']}), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms; {r['shape']}")
    missing = [f"{n}[{k}]" for n in wrappers for k in NEW_KINDS
               if (n, k) not in inputs and not (n == "structural_accepts"
                                                and k == "preferred_leader")]
    if missing and not rehearse:
        raise RuntimeError(f"no captured input for {missing}")
    return rows


# ---------------------------------------------------------------------------
# Phase 17: the intra-broker disk path (rebalance_disk=true, JBOD)
# ---------------------------------------------------------------------------

# The facade's stack for rebalance_disk=true (specs.INTRA_BROKER_GOAL_ORDER),
# and a goals= request mixing the intra-broker capacity goal with the
# inter-broker disk goals (the intra goal's disk veto judges their moves).
INTRA_GOALS = ["IntraBrokerDiskCapacityGoal", "IntraBrokerDiskUsageDistributionGoal"]
MIXED_GOALS = ["IntraBrokerDiskCapacityGoal", "DiskCapacityGoal", "DiskUsageDistributionGoal"]
INTRA_KINDS = ("intra_disk_capacity", "intra_disk_distribution")
JBOD_DISKS = 4  # disks per broker
# Every disk and broker DISK capacity scaled by one factor so that the
# fullest broker's disks sit at 70 % together: at a 50 % mean disk the
# exponential rung's 12 fullest brokers (mid) are over the 0.8 threshold
# as a whole, where no intra-broker move can satisfy the hard goal.
JBOD_FULLEST = 0.7
DEAD_DISK_BROKERS = (0, 10, 20, 30, 40)  # their first disk dead (capacity -1)
_JT = "cruise_control_tpu/model/tensor_model.py"
_PS = "cruise_control_tpu_torch/csrc/placement_score.cu"
_GM = "cruise_control_tpu_torch/csrc/goal_masks.cu"
JBOD_MODES = {
    "goal_masks[intra_disk_capacity]": (_GM, f"{_JK}:578", "mid jbod"),
    "goal_masks[intra_disk_distribution]": (_GM, f"{_JK}:578", "mid jbod"),
    "structural_accepts[intra_disk_capacity]": (_GM, f"{_JK}:492", "mid jbod"),
    "stack_sweep[intra_disk_capacity]": ("cruise_control_tpu_torch/csrc/stack_sweep.cu",
                                         "cruise_control_tpu/analyzer/optimizer.py:2332",
                                         "mid jbod"),
    "stack_sweep[intra_disk_distribution]": ("cruise_control_tpu_torch/csrc/stack_sweep.cu",
                                             "cruise_control_tpu/analyzer/optimizer.py:2332",
                                             "mid jbod"),
    "segment_sum[disk]": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu", f"{_JT}:170",
                          "mid jbod"),
    "segment_sum[disk_broker]": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                                 f"{_JK}:163", "mid jbod"),
    "blend_aggregates[disk]": (_PS, "cruise_control_tpu/analyzer/optimizer.py:2392",
                               "jbod execution"),
    "stack_sweep_batch[intra_disk_capacity]": (
        _PS, "cruise_control_tpu/analyzer/optimizer.py:2392", "jbod execution"),
    "stack_sweep_batch[intra_disk_distribution]": (
        _PS, "cruise_control_tpu/analyzer/optimizer.py:2392", "jbod execution"),
}


def jbod_model(torch, generate_cluster, spec, device, dead=()):
    """``spec``'s cluster with JBOD_DISKS disks a broker, every DISK capacity
    scaled so that the fullest broker sits at JBOD_FULLEST, and the first
    disk of each broker in ``dead`` dead (capacity -1); built on the CPU and
    moved to ``device``, so that the card and the CPU get the same bits."""
    from cruise_control_tpu_torch.common.resources import Resource
    m = generate_cluster(dataclasses.replace(spec, disks_per_broker=JBOD_DISKS), device="cpu")
    seg = m.disk_broker.long()
    load = torch.zeros(m.num_brokers, dtype=torch.float64).index_add_(
        0, seg, m.disk_load().double())
    cap = torch.zeros(m.num_brokers, dtype=torch.float64).index_add_(
        0, seg, m.disk_capacity.double())
    f = float((load / cap.clamp(min=1e-30)).max()) / JBOD_FULLEST
    disk_cap = (m.disk_capacity.double() * f).float()
    broker_cap = m.broker_capacity.clone()
    broker_cap[:, Resource.DISK] = (broker_cap[:, Resource.DISK].double() * f).float()
    for b in dead:
        if b < m.num_brokers:
            disk_cap[int(m.broker_disks[b, 0])] = -1.0
    return m.replace(disk_capacity=disk_cap, broker_capacity=broker_cap).to(device)


def intra_shuffle(torch, np, model, seed, frac=0.3):
    """``model`` with a seeded ``frac`` of its replicas on another disk of
    their broker: an intra-broker placement to blend with (K10's timings at
    large and xl250)."""
    rng = np.random.default_rng(seed)
    rb = model.replica_broker.cpu().numpy()
    rd = model.replica_disk.cpu().numpy().copy()
    disks = model.broker_disks.cpu().numpy()
    pick = np.nonzero(model.replica_valid.cpu().numpy() & (rng.random(rd.shape[0]) < frac))[0]
    rd[pick] = disks[rb[pick], rng.integers(0, disks.shape[1], pick.shape[0])]
    return model.replace(replica_disk=torch.from_numpy(rd).to(model.device))


def disks_left_dead(model) -> int:
    """Valid replicas on a dead disk."""
    rd = model.replica_disk
    dead = model.disk_capacity[rd.clamp(min=0).long()] < 0
    return int((dead & (rd >= 0) & model.replica_valid).sum())


def check_jbod(cx):
    """Phase 17: the intra-broker disk path.  ``cx`` carries main's helpers.
    Returns (kernel rows of the new modes, launch counts per run, summary)."""
    torch, np, opt, gk, cuda = cx.torch, cx.np, cx.opt, cx.gk, cx.cuda
    log, rehearse = cx.log, cx.rehearse
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    con = BalancingConstraint.default()
    counts, summary = {}, {}
    mid_spec = cx.spec_of(cx.mid_rung)

    def make(dead=()):
        return lambda d: jbod_model(torch, cx.generate_cluster, mid_spec, d, dead)

    def solved(label, model, run, wall, goals, intra_only=True):
        steps = sum(g.steps for g in run.goal_results)
        moved_disks = int(((run.model.replica_disk != model.replica_disk)
                           & model.replica_valid).sum())
        same_broker = torch.equal(run.model.replica_broker, model.replica_broker)
        summary[label] = dict(wall_s=round(wall, 4), steps=steps,
                              actions=sum(g.actions_applied for g in run.goal_results),
                              replicas_moved_disk=moved_disks, broker_unchanged=same_broker,
                              left_on_dead_disks=disks_left_dead(run.model),
                              flags=[(g.satisfied_before, g.satisfied_after)
                                     for g in run.goal_results])
        for g in run.goal_results:
            log(f"  {label} {g.name:38s} steps={g.steps:3d} actions={g.actions_applied:5d} "
                f"satisfied {g.satisfied_before}->{g.satisfied_after} {g.duration_s:.3f}s "
                f"pipelined={g.pipelined}")
        log(f"{label}: {summary[label]}")
        if intra_only and not same_broker:
            raise RuntimeError(f"{label}: the intra-broker stack moved a replica across "
                               "brokers")
        if not intra_only:
            return
        # The rehearsal's small clusters hold replicas too big for a
        # broker's other disks; the rung's must drain every dead disk and
        # satisfy the hard goal.
        if rehearse:
            verify_if_hard_held(log, label, model, run, goals, con)
            return
        if summary[label]["left_on_dead_disks"]:
            raise RuntimeError(f"{label}: replicas left on dead disks")
        cx.check_run(label, model, run, goals)

    capture = ModeCapture(torch, cuda, INTRA_KINDS + ("disk", "disk_broker"), cx.dev)
    capture_dead = ModeCapture(torch, cuda, INTRA_KINDS + ("disk", "disk_broker"), cx.dev)
    mid_names = [n for n, v in JBOD_MODES.items() if v[2] == "mid jbod"]
    with capture:
        # 1. mid JBOD on the grouped path, card against CPU.
        mid_j, run_j, wall, c = card_against_cpu(cx, "mid JBOD", make(), INTRA_GOALS, con)
        counts["mid jbod"] = c
        need_launched_in(cx, "mid JBOD", c, mid_names)
        solved("mid JBOD", mid_j, run_j, wall, INTRA_GOALS)
    # The dead-disk model has the healthy one's shape: without its cached
    # step graphs the run's eager warm-ups hand the wrappers its inputs.
    opt.graphs.GRAPHS.clear()
    with capture_dead:
        # 2. the same model with disk 0 of brokers 0, 10, 20, 30, 40 dead.
        dead = tuple(b for b in DEAD_DISK_BROKERS if b < cx.mid_rung[0])
        mid_d, run_d, wall_d, c = card_against_cpu(cx, "mid JBOD dead disks", make(dead),
                                                   INTRA_GOALS, con)
        counts["mid jbod dead"] = c
        if disks_left_dead(mid_d) == 0:
            raise RuntimeError("mid JBOD dead disks: no replica on a dead disk to heal")
        log(f"mid JBOD dead disks: {disks_left_dead(mid_d)} replicas on {len(dead)} dead "
            "disks before")
        solved("mid JBOD dead disks", mid_d, run_d, wall_d, INTRA_GOALS)
    # 3. the mixed stack: the intra goal's disk veto on inter-broker moves.
    mid_m, run_m, wall_m, c = card_against_cpu(cx, "mid JBOD mixed", make(), MIXED_GOALS, con)
    counts["mid jbod mixed"] = c
    need_launched_in(cx, "mid JBOD mixed", c, ["structural_accepts[intra_disk_capacity]"])
    solved("mid JBOD mixed", mid_m, run_m, wall_m, MIXED_GOALS, intra_only=False)
    # The inter-broker goals after it may leave the hard intra goal
    # violated at the end, in the JAX package as on the CPU (the same
    # placement, tests/test_torch_intra_disk_8.py): logged, not verified.
    from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    end = bool(gk.goal_satisfied(GOAL_SPECS[MIXED_GOALS[0]], run_m.model,
                                 BrokerArrays.from_model(run_m.model), con))
    summary["mid JBOD mixed"]["intra_capacity_held_at_end"] = end
    log(f"mid JBOD mixed: IntraBrokerDiskCapacityGoal satisfied at the end {end}")

    # 4. large JBOD: the facade's default (pipelined) and the sequential
    # path, timed in turns; the pipelined run must place as the sequential.
    large_j = jbod_model(torch, cx.generate_cluster, cx.spec_of(cx.large_rung), cx.dev)
    log(f"large JBOD: {int(large_j.replica_valid.sum())} replicas, {large_j.num_disks} disks")
    paths = {"sequential": cx.per_goal, "pipelined": {}}
    for kw in paths.values():
        cx.fused_run(large_j, INTRA_GOALS, **kw)  # captures
    walls = {k: [] for k in paths}
    runs_l = {}
    for label in ("sequential", "pipelined", "pipelined", "sequential"):
        run, w, c = all_counts(cx, lambda: cx.fused_run(large_j, INTRA_GOALS, **paths[label]))
        walls[label].append(w)
        runs_l[label] = run
        counts[f"large jbod {label}"] = c
    if not cx.same_placement(runs_l["pipelined"], runs_l["sequential"]):
        raise RuntimeError("large JBOD: the pipelined run placed replicas otherwise than "
                           "the sequential one")
    if not rehearse and not runs_l["pipelined"].pipelined:
        raise RuntimeError("large JBOD: the facade's default solve did not pipeline")
    for label in paths:
        solved(f"large JBOD {label}", large_j, runs_l[label], min(walls[label]), INTRA_GOALS)
        summary[f"large JBOD {label}"].update(
            walls_s=[round(w, 4) for w in walls[label]], pipelined=runs_l[label].pipelined)
    if not rehearse:
        prof = cx.profile_mid(torch, lambda: cx.fused_run(large_j, INTRA_GOALS),
                              min(walls["pipelined"]),
                              summary["large JBOD pipelined"]["steps"],
                              "large-jbod-pipelined", log)
        summary["large JBOD pipelined"]["busy"] = prof["busy"]
    log(f"large JBOD in turns: {walls}")

    # 5. the mid JBOD solve's proposals executed (the intra-broker phase),
    # the ledger scored by K10's disk kinds; the same on the CPU.
    s, c = cx.execute(mid_j, run_j, con, "mid JBOD", True)
    counts["jbod execution"] = c
    summary["jbod execution"] = s
    need_launched_in(cx, "mid JBOD execution", c,
                     [n for n, v in JBOD_MODES.items() if v[2] == "jbod execution"])

    # 6. the new modes against their plain twins, healthy and dead disks.
    rows = check_jbod_modes(cx, capture.inputs, capture_dead.inputs)
    # 7. K10's disk kinds at mid, large and xl250 JBOD.
    k10 = {"mid": check_jbod_placement(cx, mid_j, run_j.model, "mid JBOD"),
           "mid_dead": check_jbod_placement(cx, mid_d, run_d.model, "mid JBOD dead disks"),
           "large": check_jbod_placement(cx, large_j, intra_shuffle(torch, np, large_j, SEED),
                                         "large JBOD")}
    del large_j, runs_l
    xl_j = jbod_model(torch, cx.generate_cluster, cx.spec_of(cx.xl_rung), cx.dev)
    k10["xl250"] = check_jbod_placement(cx, xl_j, intra_shuffle(torch, np, xl_j, SEED),
                                        "xl250 JBOD")
    del xl_j
    for name in k10["mid"]:
        rows[name] = dict(k10["mid"][name])
        for rung in ("large", "xl250"):
            rows[name].update({f"{k}_{rung}": v for k, v in k10[rung][name].items()
                               if k != "max_abs_err"})
    for name, (_, _, run_label) in JBOD_MODES.items():
        rows[name]["launches"] = counts[run_label].get(name, 0)
        rows[name]["launches_run"] = run_label
    return rows, counts, summary


def _exact(torch, got, ref):
    """Tensors (or tuples of them) equal bit for bit (floats by their bits)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        if g is None and r is None:
            continue
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        r = r.view(torch.int32) if r.dtype == torch.float32 else r
        if not torch.equal(g.cpu(), r.cpu()):
            return False
    return True


def check_jbod_modes(cx, healthy, dead):
    """K5 mode 7, K5b's disk veto, K9's kinds 12-13 and ``segment_sum``'s
    disk modes on the inputs the healthy and the dead-disk mid JBOD runs
    gave them: the kernel against its plain twin, exactly; K5b also with
    both disk goals as earlier goals.  Each timed on the healthy inputs."""
    torch, gk, log, rehearse = cx.torch, cx.gk, cx.log, cx.rehearse
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.ops.segment import masked_segment_sum, segment_sum
    wrappers = {"goal_masks": (gk.goal_masks, gk.goal_masks_plain),
                "structural_accepts": (gk.structural_accepts, gk.structural_accepts_plain),
                "stack_sweep": (gk.stack_satisfied, gk.stack_satisfied_plain)}
    names = {"goal_masks": ("goal_masks_kernel",),
             "structural_accepts": ("structural_accepts_kernel",),
             "stack_sweep": ("stack_sweep_kernel",), "segment_sum": ("segment_sum_kernel",)}
    both = tuple(goals_by_priority(INTRA_GOALS))
    rows = {}
    keys = [(n, k) for n in ("goal_masks", "stack_sweep") for k in INTRA_KINDS] + \
        [("structural_accepts", "intra_disk_capacity"), ("segment_sum", "disk"),
         ("segment_sum", "disk_broker")]
    for name, kind in keys:
        if (name, kind) not in healthy or (name, kind) not in dead:
            if rehearse:
                continue
            raise RuntimeError(f"no captured input for {name}[{kind}]")
        args = healthy[(name, kind)]
        if name != "segment_sum" and not bool((dead[(name, kind)][1].disk_capacity < 0).any()):
            raise RuntimeError(f"{name}[{kind}]: the dead-disk run's inputs have no dead disk")
        checked = 0
        for inputs in (healthy[(name, kind)], dead[(name, kind)]):
            if name == "segment_sum":
                got = segment_sum(*inputs)
                cpu = tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in inputs)
                ref = masked_segment_sum(cpu[0], cpu[1], cpu[3], cpu[2])
                calls = [(got, ref)]
            else:
                kernel, plain = wrappers[name]
                calls = [(kernel(*inputs), plain(*inputs))]
                if name == "structural_accepts":
                    # Both disk goals as earlier goals: both upper bands.
                    call = (both,) + tuple(inputs[1:])
                    calls.append((kernel(*call), plain(*call)))
            for got, ref in calls:
                if not _exact(torch, got, ref):
                    raise RuntimeError(f"{name}[{kind}] disagrees with its plain twin")
                checked += 1
        model = None if name == "segment_sum" else args[1]
        if name == "segment_sum":
            values, ids, mask, n = args[:4]
            timed = lambda: segment_sum(*args)  # noqa: E731
            plain = lambda: masked_segment_sum(values, ids, n, mask)  # noqa: E731
            keep = torch.where(mask, ids, 0).long()
            rows_v = torch.where(mask[:, None], values, 0.0)
            acc = torch.zeros((n, values.shape[1]), device=values.device)
            library = lambda: acc.zero_().index_add_(0, keep, rows_v)  # noqa: E731
            nbytes = mask.numel() + int(mask.sum()) * (4 + 4 * values.shape[1]) + \
                n * 4 * values.shape[1]
            shape = dict(N=values.shape[0], C=values.shape[1], S=n)
        else:
            kernel, plain_fn = wrappers[name]
            call = args
            if name == "stack_sweep":
                call = (tuple(s for s in args[0] if s.kind == kind),) + tuple(args[1:])
            timed = lambda: kernel(*call)  # noqa: E731
            plain = lambda: plain_fn(*call)  # noqa: E731
            library = None
            nbytes = {"goal_masks": lambda: _k5_bytes(args[0], model, args[3].k, args[6]),
                      "structural_accepts": lambda: _k5b_bytes(args[0], model, args[3]),
                      "stack_sweep": lambda: _k9_bytes(call[0], model)}[name]()
            shape = dict(K=args[3].k if name != "stack_sweep" else None,
                         R=model.num_replicas_padded, B=model.num_brokers,
                         D=model.num_disks)
        rows[f"{name}[{kind}]"] = r = dict(
            max_abs_err=0.0, ms=cx.timer(torch, timed), plain_ms=cx.timer(torch, plain),
            library_ms=None if library is None else cx.timer(torch, library),
            bound_ms=bound_ms(nbytes),
            device_ms=None if rehearse else device_ms(torch, timed, names[name], log),
            shape=shape)
        log(f"{name}[{kind}]: healthy and dead disks equal to the plain twin (exact, "
            f"{checked} calls); kernel {r['ms']:.4f} ms (device {r['device_ms']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} "
            f"ms; {shape}")
    return rows


def _k10_disk_bytes(before, c):
    """Bytes K10's disk loads must move for ``c`` blends: the masks, both
    placements' disks and leader flags, the replica partitions, valid flags
    and both DISK columns, the disk brokers and each broker's disk list,
    once; c x D disk loads written."""
    R, D = before.num_replicas_padded, before.num_disks
    return (c * before.num_partitions + R * (2 * 4 + 2 + 4 + 1 + 8) + D * 4
            + before.broker_disks.numel() * 4 + c * D * 4)


def check_jbod_placement(cx, before, after, label):
    """K10 with the disk goals on K10_BATCH blends of ``before`` and
    ``after``: the aggregates with the blends' disk loads bit for bit
    against the plain twin (an all-false blend's disk loads are
    ``segment_sum[disk]``'s, and the disk loads' launch alone equals
    them), each disk kind's sweep alone and both together exactly; each
    timed beside its plain twin and its bound, the disk loads' launch alone
    beside one ``index_add_`` over (blend, disk) segments."""
    torch, np, gk, log, rehearse = cx.torch, cx.np, cx.gk, cx.log, cx.rehearse
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    con = BalancingConstraint.default()
    specs = tuple(goals_by_priority(INTRA_GOALS))
    masks, moved = k10_masks(torch, np, before, after, K10_BATCH, SEED)
    C, R, D = masks.shape[0], before.num_replicas_padded, before.num_disks
    ka, ks = gk.blend_aggregates, gk.stack_sweep_batch
    got = ka(before, after, masks, False, with_disk_load=True)
    ref = gk.blend_aggregates_plain(before, after, masks, False, False, True)
    if not _exact(torch, tuple(got), tuple(ref)):
        raise RuntimeError(f"K10 aggregates ({label}): differ from the plain twin")
    # The disk loads alone, and against the plain version on the CPU copies.
    if not _exact(torch, gk.blend_disk_load(before, after, masks), got[7]):
        raise RuntimeError(f"K10 ({label}): the disk loads' launch alone differs from "
                           "blend_aggregates'")
    b_cpu, a_cpu = before.to("cpu"), after.to("cpu")
    cpu_dl = gk.blend_disk_load_plain(b_cpu, a_cpu, masks.cpu())
    if not _exact(torch, got[7], cpu_dl):
        raise RuntimeError(f"K10 ({label}): the blends' disk loads differ from the plain "
                           "version on the CPU")
    del b_cpu, a_cpu, cpu_dl
    if not _exact(torch, got[7][0], before.disk_load()):
        raise RuntimeError(f"K10 ({label}): the all-false blend's disk loads differ from "
                           "segment_sum[disk]'s")
    for sk in ((specs[0],), (specs[1],), specs):
        if not torch.equal(ks(sk, before, after, masks, got, con),
                           gk.stack_sweep_batch_plain(sk, before, after, masks, ref, con)):
            raise RuntimeError(f"K10 sweep ({label}, {[s.kind for s in sk]}) differs from "
                               "the plain twin")
    scored = cx.opt._get_placement_score_fn(specs, con, C)(before, after, masks)
    if not torch.equal(scored, ks(specs, before, after, masks, got, con)):
        raise RuntimeError(f"K10 ({label}): the scorer's call differs from one launch")
    shape = dict(C=C, P=before.num_partitions, R=R, B=before.num_brokers, D=D,
                 moved_partitions=moved)
    part = before.replica_partition.clamp(0, before.num_partitions - 1).long()
    rmask = masks[:, part]
    rd = torch.where(rmask, after.replica_disk, before.replica_disk)
    lead = torch.where(rmask, after.replica_is_leader, before.replica_is_leader)
    disk = torch.where(lead, before.replica_load_leader[:, 3],
                       before.replica_load_follower[:, 3])
    keep = before.replica_valid[None, :] & (rd >= 0)
    seg = (torch.arange(C, device=rd.device)[:, None] * D + rd.clamp(min=0)).reshape(-1)
    vals = torch.where(keep, disk, 0.0).reshape(-1)
    acc = torch.zeros((C * D,), device=rd.device)
    fast = 5 if R * C > 1 << 24 else TIMED_RUNS
    # The disk loads' launch alone: its event and device time, its plain
    # version in torch ops, its bound and one index_add_.
    dl_out = torch.empty_like(got[7])
    out = {"blend_aggregates[disk]": dict(
        max_abs_err=0.0, shape=shape,
        ms=cx.timer(torch, lambda: gk.blend_disk_load(before, after, masks, dl_out), fast),
        plain_ms=cx.timer(torch, lambda: gk.blend_disk_load_plain(before, after, masks), 3),
        library_ms=cx.timer(torch, lambda: acc.zero_().index_add_(0, seg, vals), fast),
        bound_ms=bound_ms(_k10_disk_bytes(before, C)),
        device_ms=None if rehearse else device_ms(
            torch, lambda: gk.blend_disk_load(before, after, masks, dl_out),
            ("blend_disk_load_kernel",), log))}
    for kind, spec in zip(INTRA_KINDS, specs):
        sk = (spec,)
        # The sweep reads the disk loads, capacities and valid flags, the
        # disk lists and the alive and valid brokers (and replica counts
        # for the hard goal) of each blend; C flags written.
        nbytes = C * D * 4 + D * 5 + before.broker_disks.numel() * 4 + \
            before.num_brokers * (2 + (4 * C if spec.is_hard else 0)) + C
        out[f"stack_sweep_batch[{kind}]"] = dict(
            max_abs_err=0.0, shape=dict(shape, G=1),
            ms=cx.timer(torch, lambda: ks(sk, before, after, masks, got, con), fast),
            plain_ms=cx.timer(torch, lambda: gk.stack_sweep_batch_plain(
                sk, before, after, masks, ref, con), 3),
            library_ms=None, bound_ms=bound_ms(nbytes),
            device_ms=None if rehearse else device_ms(
                torch, lambda: ks(sk, before, after, masks, got, con),
                ("stack_sweep_batch_kernel",), log))
    del rmask, rd, lead, seg, vals, acc, dl_out
    log(f"K10 {label}: C={C} R={R} D={D}, {moved} partitions moved; disk loads bit-equal "
        f"to the plain twin and to the plain version on the CPU (all-false blend = "
        f"segment_sum[disk]), flags exact")
    for name, r in out.items():
        log(f"  K10 {label} {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
    return out


# ---------------------------------------------------------------------------
# Phase 18: from metric samples to anomalies (the monitor and the detectors)
# ---------------------------------------------------------------------------

K14_SHAPE = (7000, 20)  # brokers (LinkedIn's largest fleets) x num.broker.metrics.windows
SLOW_BROKERS = (3, 17, 501)  # a flush-time excursion in the latest window
DEAD_BROKERS = tuple(range(0, 100, 10))
DETECTION_WINDOWS = 6  # sampler windows fed to the monitor (5 complete, 1 open)
BROKER_WINDOWS = K14_SHAPE[1]  # the broker history the tick scores: all of it
WINDOW_MS = 300_000
FLUSH = "BROKER_LOG_FLUSH_TIME_MS_999TH"
F32_PEAK_OPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
DETECTION_KERNELS = {
    "detector_peer": ("cruise_control_tpu_torch/csrc/detector_scores.cu",
                      "cruise_control_tpu/detector/device.py:102"),
    "detector_rows": ("cruise_control_tpu_torch/csrc/detector_scores.cu",
                      "cruise_control_tpu/detector/device.py:77"),
}
# tests/test_device_detector.py:33-45: flush-time histories of four brokers
# over six windows; BORDERLINE puts the latest value exactly on the anomaly
# threshold (percentile 10 x margin 1.5).
DETECTOR_FIXTURES = {
    "clean": {b: [5, 5, 5, 5, 5, 5] for b in range(4)},
    "single_slow": {0: [5, 5, 5, 5, 5, 100], 1: [5, 5, 5, 5, 5, 5],
                    2: [5, 5, 5, 5, 5, 6], 3: [5, 5, 5, 5, 5, 5]},
    "borderline": {0: [10, 10, 10, 10, 10, 15], 1: [10, 10, 10, 10, 10, 16],
                   2: [10, 10, 10, 10, 10, 10], 3: [10, 10, 10, 10, 10, 10]},
}


def k14_history(np, seed, e, w):
    """Seeded f32[E, W] flush times and bytes-in with 80 % valid windows
    (integer-valued, so ties occur); rows 0-2 with no valid history, one
    valid history window and an invalid latest window; every 97th row with
    a 40x excursion in its latest window."""
    rng = np.random.default_rng(seed)
    vals = np.round(rng.gamma(2.0, 5.0, size=(e, w))).astype(np.float32)
    bts = rng.gamma(2.0, 50.0, size=(e, w)).astype(np.float32)
    wvalid = rng.random((e, w)) < 0.8
    wvalid[0, :-1] = False
    wvalid[1, :-1] = False
    wvalid[1, 4] = True
    wvalid[2, -1] = False
    vals[3::97, -1] *= 40.0
    wvalid[3::97, -1] = True
    return vals, bts, wvalid


def fixture_history(history, windows=6):
    """tests/test_detector.py ``broker_agg_with_history`` on the port's
    aggregator."""
    from cruise_control_tpu_torch.monitor.aggregator import MetricSampleAggregator
    agg = MetricSampleAggregator(windows, WINDOW_MS)
    for w in range(windows):
        for b, series in history.items():
            agg.add_sample(b, w * WINDOW_MS + 1, {FLUSH: series[w], "LEADER_BYTES_IN": 100.0})
    for b in history:
        agg.add_sample(b, windows * WINDOW_MS, {FLUSH: 0.0, "LEADER_BYTES_IN": 100.0})
    return agg


def check_k14(cx):
    """K14's two launches against their plain versions on the card, bit for
    bit: seeded histories at E = 7,000 and W = 20 (with rows of no valid
    history, one valid window, an invalid latest window; again with every
    latest window invalid, where the peer anchor is 0), and the three
    fixtures.  Timed at 7,000 x 20 beside the plain versions and
    ``torch.nanquantile``.  Returns the kernel rows."""
    torch, np, log, dev, rehearse = cx.torch, cx.np, cx.log, cx.dev, cx.rehearse
    from cruise_control_tpu_torch.detector import device as dd
    from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF
    mid = KAFKA_METRIC_DEF.metric_info(FLUSH).metric_id
    bmid = KAFKA_METRIC_DEF.metric_info("LEADER_BYTES_IN").metric_id
    c = dd.ScoreConstants.of(dd.DeviceScorer("cpu")._params())
    e, w = K14_SHAPE

    def on_dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    vals, bts, wvalid = on_dev(*k14_history(np, SEED, e, w))
    none_latest = wvalid.clone()
    none_latest[:, -1] = False
    cases = {"seeded": (vals, bts, wvalid), "no valid latest": (vals, bts, none_latest)}
    for name, history in DETECTOR_FIXTURES.items():
        res = fixture_history(history).aggregate()
        cases[name] = tuple(on_dev(res.values[:, :, mid], res.values[:, :, bmid],
                                   res.window_valid))
    flagged = {}
    for label, (v, b, ok) in cases.items():
        peer = dd.peer_anchor(v, ok, c.peer_q)
        peer_ref = dd.peer_anchor_plain(v, ok, c.peer_q)
        got = dd.row_scores(v, b, ok, peer_ref, c)
        ref = dd.row_scores_plain(v, b, ok, peer_ref, c)
        if not (_exact(torch, peer, peer_ref) and _exact(torch, got, ref)):
            raise RuntimeError(f"K14 {label}: the kernels differ from their plain versions")
        flagged[label] = (int(ref[0].sum()), int(ref[2].sum()), float(peer_ref[0]))
    log(f"K14 against its plain versions, bit for bit: (metric flags, suspects, peer "
        f"anchor) {flagged}")
    if flagged["no valid latest"][:2] != (0, 0) or flagged["seeded"][1] == 0:
        raise RuntimeError(f"K14 cases did not exercise the flags: {flagged}")

    peer = dd.peer_anchor(vals, wvalid, c.peer_q)
    nan = torch.tensor(float("nan"), device=dev)
    hist_nan = torch.where(wvalid[:, :-1], vals[:, :-1], nan)
    norm_nan = torch.where(wvalid[:, :-1], vals[:, :-1] / torch.clamp_min(bts[:, :-1], 1e-9),
                           nan)
    latest_nan = torch.where(wvalid[:, -1], vals[:, -1], nan)
    timer = cx.timer
    m = w - 1
    rows = {
        "detector_peer": dict(
            shape=dict(E=e, W=w), max_abs_err=0.0,
            ms=timer(torch, lambda: dd.peer_anchor(vals, wvalid, c.peer_q)),
            plain_ms=timer(torch, lambda: dd.peer_anchor_plain(vals, wvalid, c.peer_q)),
            library_ms=timer(torch, lambda: torch.nanquantile(latest_nan, c.peer_q)),
            device_ms=None if rehearse else device_ms(
                torch, lambda: dd.peer_anchor(vals, wvalid, c.peer_q),
                ("detector_peer_kernel",), log),
            nbytes=e * 5 + 4, ops=e * 2),
        "detector_rows": dict(
            shape=dict(E=e, W=w), max_abs_err=0.0,
            ms=timer(torch, lambda: dd.row_scores(vals, bts, wvalid, peer, c)),
            plain_ms=timer(torch, lambda: dd.row_scores_plain(vals, bts, wvalid, peer, c)),
            library_ms=timer(torch, lambda: (torch.nanquantile(hist_nan, c.a_q, dim=1),
                                             torch.nanquantile(hist_nan, c.q, dim=1),
                                             torch.nanquantile(norm_nan, c.q, dim=1))),
            device_ms=None if rehearse else device_ms(
                torch, lambda: dd.row_scores(vals, bts, wvalid, peer, c),
                ("detector_rows_kernel",), log),
            nbytes=e * w * 9 + 4 + e * 6, ops=e * (m + 3 * m + 12)),
    }
    for name, r in rows.items():
        by_bytes = bound_ms(r.pop("nbytes"))
        by_ops = r.pop("ops") / F32_PEAK_OPS * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        log(f"  K14 {name} at E={e} W={w}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']}), plain {r['plain_ms']:.4f} ms, torch.nanquantile "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.7f} ms ({r['bound_by']})")
    return rows


def check_k14_captured(cx, captured):
    """K14's two launches against their plain versions, bit for bit, on the
    inputs the detection tick gave them (its first call of each, kept by
    ``cuda.CAPTURE``): the peer anchor from the tick's history, and the
    row pass on the tick's history and anchor.  Returns the tick's shape,
    which must span the broker aggregator's full history."""
    torch, log = cx.torch, cx.log
    from cruise_control_tpu_torch.detector import device as dd
    if "detector_peer" not in captured or "detector_rows" not in captured:
        raise RuntimeError(f"the tick launched no K14 pass: captured {sorted(captured)}")
    vals, wvalid, q = captured["detector_peer"]
    rvals, bts, rvalid, peer_tick, c = captured["detector_rows"]
    peer_ref = dd.peer_anchor_plain(vals, wvalid, q)
    same = (_exact(torch, dd.peer_anchor(vals, wvalid, q), peer_ref)
            and _exact(torch, peer_tick, peer_ref)
            and _exact(torch, dd.row_scores(rvals, bts, rvalid, peer_tick, c),
                       dd.row_scores_plain(rvals, bts, rvalid, peer_tick, c)))
    e, w = rvals.shape
    log(f"K14 on the detection tick's inputs (E={e}, W={w}, peer anchor "
        f"{float(peer_ref[0])}): bit for bit with its plain versions: {same}")
    if not same:
        raise RuntimeError("K14 differs from its plain versions on the tick's inputs")
    if w != BROKER_WINDOWS or tuple(vals.shape) != (e, w):
        raise RuntimeError(f"the tick scored {tuple(vals.shape)}, not the broker "
                           f"aggregator's {BROKER_WINDOWS} windows")
    return dict(E=int(e), W=int(w))


def fleet_metadata(np, model):
    """The port's ``ClusterMetadata`` of a generated cluster: brokers on their
    racks, each partition with its replicas leader first, topics named by
    id and partitions numbered within their topic."""
    from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, ClusterMetadata,
                                                           PartitionInfo)
    rb = model.replica_broker.cpu().numpy()
    rp = model.replica_partition.cpu().numpy()
    lead = model.replica_is_leader.cpu().numpy()
    idx = np.nonzero(model.replica_valid.cpu().numpy())[0]
    order = idx[np.lexsort((idx, ~lead[idx], rp[idx]))]
    parts_sorted, brokers_sorted = rp[order], rb[order]
    bounds = np.searchsorted(parts_sorted, np.arange(model.num_partitions + 1))
    topic_of = model.partition_topic.cpu().numpy()
    racks = model.broker_rack.cpu().numpy()
    seen = np.zeros(model.num_topics, np.int64)
    parts = []
    for p in range(model.num_partitions):
        lo, hi = bounds[p], bounds[p + 1]
        if lo == hi:
            continue
        reps = tuple(int(b) for b in brokers_sorted[lo:hi])
        t = int(topic_of[p])
        parts.append(PartitionInfo(f"topic{t}", int(seen[t]), leader=reps[0], replicas=reps))
        seen[t] += 1
    brokers = tuple(BrokerInfo(b, rack=f"rack{int(racks[b])}", host=f"host{b}")
                    for b in range(model.num_brokers))
    return ClusterMetadata(brokers=brokers, partitions=tuple(parts))


class StandInContext:
    """The self-healing context the manager calls until the facade is
    ported: ``rebalance`` builds the monitor's model and solves it with
    ``solve``; every other call is recorded and answered True."""

    def __init__(self, lm, solve):
        self._lm, self._solve = lm, solve
        self.calls, self.heals = [], []

    def rebalance(self, goals=None, reason="", self_healing=False, **kw):
        self.calls.append(("rebalance", reason))
        model = self._lm.cluster_model()
        self.heals.append((model, self._solve(model)))
        return True

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self.calls.append((name, args))
            return True
        return call


def _anomaly_rows(mgr):
    return [(type(e.anomaly).__name__, e.anomaly.reason()[:120]) for e in sorted(mgr._queue)]


def check_detection(cx):
    """Phase 18: one tick of the monitor and the detectors at the xl250
    shape (``xl_rung``), one stand-in heal, and a tick with dead brokers
    (K14 against its plain versions runs with phase 4's kernels,
    ``check_k14``).  Returns (launch counts per tick, summary)."""
    torch, np, opt, cuda, log = cx.torch, cx.np, cx.opt, cx.cuda, cx.log
    dev, rehearse = cx.dev, cx.rehearse
    from cruise_control_tpu_torch.analyzer.balancedness import (
        BALANCEDNESS_SCORE_WITH_OFFLINE_REPLICAS)
    from cruise_control_tpu_torch.config import constants as C
    from cruise_control_tpu_torch.convert import model_to_numpy
    from cruise_control_tpu_torch.detector import anomalies as danom
    from cruise_control_tpu_torch.detector import detectors as ddet
    from cruise_control_tpu_torch.detector import device as dd
    from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
    from cruise_control_tpu_torch.executor.admin import InMemoryClusterAdmin
    from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import MetadataClient
    from cruise_control_tpu_torch.monitor.sampling import SyntheticWorkloadSampler

    summary, counts = {}, {}
    t0 = time.monotonic()
    md = fleet_metadata(np, cx.generate_cluster(cx.spec_of(cx.xl_rung), device="cpu"))
    summary["metadata_s"] = round(time.monotonic() - t0, 3)
    nb = len(md.brokers)
    slow = {b for b in SLOW_BROKERS if b < nb}
    dead = {b for b in DEAD_BROKERS if b < nb}
    mc = MetadataClient(md)
    kw = dict(num_partition_windows=DETECTION_WINDOWS - 1, partition_window_ms=WINDOW_MS,
              broker_window_ms=WINDOW_MS)
    lm = LoadMonitor(mc, StaticCapacityResolver(), device=dev, **kw)
    lm.start_up()
    t0 = time.monotonic()
    sampler = SyntheticWorkloadSampler()
    for w in range(BROKER_WINDOWS + 1 - DETECTION_WINDOWS, BROKER_WINDOWS + 1):
        lm.fetch_once(sampler, w * WINDOW_MS, w * WINDOW_MS + 1)
    # The synthetic broker samples carry a constant flush time and no
    # bytes-in: add both for every broker and each of the broker
    # aggregator's complete windows, the sampler's and the earlier ones
    # (seeded flush times near 5 ms), with the excursion on the slow
    # brokers in the latest.
    rng = np.random.default_rng(SEED)
    flush = rng.uniform(4.0, 6.0, size=(BROKER_WINDOWS, nb))
    flush[-1, sorted(slow)] = 5000.0
    lm.broker_aggregator.add_samples([
        (b, w * WINDOW_MS + 2, {FLUSH: float(flush[w, b]), "LEADER_BYTES_IN": 100.0})
        for w in range(BROKER_WINDOWS) for b in range(nb)])
    summary["sample_s"] = round(time.monotonic() - t0, 3)
    log(f"detection fleet: {nb} brokers, {md.partition_count()} partitions, "
        f"{md.replica_count()} replicas; metadata {summary['metadata_s']} s, "
        f"{DETECTION_WINDOWS} sampled windows and {BROKER_WINDOWS} broker windows "
        f"{summary['sample_s']} s")

    # The model the monitor builds on the card equals its CPU build.
    cpu_lm = LoadMonitor(mc, StaticCapacityResolver(), device="cpu", **kw)
    cpu_lm.partition_aggregator = lm.partition_aggregator
    cpu_lm.broker_aggregator = lm.broker_aggregator
    t0 = time.monotonic()
    model = lm.cluster_model()
    torch.cuda.synchronize()
    summary["card_build_s"] = round(time.monotonic() - t0, 3)
    t0 = time.monotonic()
    cpu_model = cpu_lm.cluster_model()
    summary["cpu_build_s"] = round(time.monotonic() - t0, 3)
    (f_card, s_card), (f_cpu, s_cpu) = model_to_numpy(model), model_to_numpy(cpu_model)
    same = s_card == s_cpu and all(np.array_equal(f_card[f], f_cpu[f]) for f in f_card)
    log(f"monitor model: {int(model.replica_valid.sum())} replicas, {model.num_brokers} "
        f"brokers; built on the card in {summary['card_build_s']} s, on the CPU in "
        f"{summary['cpu_build_s']} s; equal field for field: {same}")
    if not same or model.replica_broker.device.type != dev.type:
        raise RuntimeError("the monitor's card-built model differs from its CPU build")
    del model, cpu_model, cpu_lm

    def heal_solve(model):
        run = opt.optimize(model, STACK, fused=True, raise_on_hard_failure=False, device=dev)
        torch.cuda.synchronize()
        cx.check_run("heal", model, run, STACK)
        return run

    ctx = StandInContext(lm, heal_solve)
    notifier = SelfHealingNotifier(self_healing_enabled=dict.fromkeys(danom.AnomalyType, True))
    mgr = AnomalyDetectorManager(notifier, ctx)
    finders = dd.build_device_finders({C.SLOW_BROKER_DEMOTION_SCORE_CONFIG: 1}, device=dev)
    goal_detector = dd.DeviceGoalViolationDetector(lm, STACK)
    for det in (ddet.BrokerFailureDetector(mc),
                ddet.DiskFailureDetector(InMemoryClusterAdmin(mc), mc), goal_detector,
                ddet.MetricAnomalyDetector(lm, finders),
                ddet.TopicAnomalyDetector(mc, desired_rf=3, load_monitor=lm),
                ddet.MaintenanceEventDetector(ddet.MaintenanceEventReader())):
        mgr.register_detector(det, interval_ms=1)

    oracle = os.environ.get("CRUISE_DETECTOR_ORACLE")
    os.environ["CRUISE_DETECTOR_ORACLE"] = "1"  # device verdicts checked against the scalar ones
    try:
        # Tick 1: healthy fleet, the slow brokers' excursion; the heal.
        now = (BROKER_WINDOWS + 1) * WINDOW_MS
        dispatches, sweeps = dd.DEVICE_COUNTERS["dispatches"], opt.SWEEP_COUNTERS["dispatches"]
        cuda.reset_launch_counts()
        torch.cuda.synchronize()
        cuda.CAPTURE = {}
        t0 = time.monotonic()
        found = mgr.run_detectors_once(now)
        torch.cuda.synchronize()
        summary["detect_s"] = round(time.monotonic() - t0, 3)
        captured, cuda.CAPTURE = cuda.CAPTURE, None
        counts["detect"] = {n: f.launches for n, f in cuda.COUNTED.items() if f.launches}
        queued = _anomaly_rows(mgr)
        metric = [e.anomaly for e in mgr._queue if isinstance(e.anomaly, danom.SlowBrokers)]
        violations = [e.anomaly for e in mgr._queue
                      if isinstance(e.anomaly, danom.GoalViolations)]
        log(f"tick 1 ({summary['detect_s']} s): {found} anomalies {queued}; scoring "
            f"dispatches +{dd.DEVICE_COUNTERS['dispatches'] - dispatches}, goal sweeps "
            f"+{opt.SWEEP_COUNTERS['dispatches'] - sweeps}; launches {counts['detect']}")
        if len(metric) != 2 or any(set(a.slow_brokers) != slow for a in metric):
            raise RuntimeError(f"the finders did not flag exactly brokers {sorted(slow)}: "
                               f"{[a.slow_brokers for a in metric]}")
        if not violations or not violations[0].fixable_goals:
            raise RuntimeError("the goal-violation detector found no fixable goal")
        if dd.DEVICE_COUNTERS["dispatches"] - dispatches != 1 or \
                opt.SWEEP_COUNTERS["dispatches"] - sweeps != 1:
            raise RuntimeError("tick 1 did not score once and sweep once")
        if not rehearse and (counts["detect"].get("detector_peer") != 1
                             or counts["detect"].get("detector_rows") != 1
                             or not counts["detect"].get("stack_sweep")):
            raise RuntimeError(f"tick 1 launched K14 or K9's sweep otherwise than once: "
                               f"{counts['detect']}")
        t0 = time.monotonic()
        handled = mgr.handle_anomalies_once(now + 1)
        torch.cuda.synchronize()
        summary["handle_s"] = round(time.monotonic() - t0, 3)
        counts["tick"] = {n: f.launches for n, f in cuda.COUNTED.items()}
        state = mgr.state_dict()
        statuses = {t: [r["status"] for r in rows_]
                    for t, rows_ in state["recentAnomalies"].items() if rows_}
        log(f"tick 1 handled {handled} ({summary['handle_s']} s): context calls "
            f"{[c[0] for c in ctx.calls]}; statuses {statuses}; alerts "
            f"{[type(a).__name__ for a in notifier.alerts]}; balancedness "
            f"{state.get('balancednessScore')}")
        if len(ctx.heals) != 1 or "demote_brokers" not in [c[0] for c in ctx.calls]:
            raise RuntimeError(f"tick 1 did not heal once and demote: {ctx.calls}")
        heal_model, heal_run = ctx.heals[0]
        summary["heal"] = dict(
            goals_violated=violations[0].fixable_goals + violations[0].unfixable_goals,
            steps=sum(g.steps for g in heal_run.goal_results),
            actions=sum(g.actions_applied for g in heal_run.goal_results),
            pipelined=heal_run.pipelined,
            balancedness=(round(heal_run.balancedness_before, 3),
                          round(heal_run.balancedness_after, 3)))
        log(f"stand-in heal on the monitor's model: {summary['heal']}")
        cx.check_launched("detection tick", {n: counts["tick"][n] for n in KERNELS})
        del ctx.heals[:], heal_model, heal_run
        summary["k14_shape"] = check_k14_captured(cx, captured)
        del captured

        # The device's share of one detection pass as a deployment runs it
        # (the oracle off): fresh goal detector and finders, so the model is
        # built, swept and scored anew.
        os.environ["CRUISE_DETECTOR_ORACLE"] = "0"

        def detection_pass():
            for det in (dd.DeviceGoalViolationDetector(lm, STACK),
                        ddet.MetricAnomalyDetector(lm, dd.build_device_finders(
                            {C.SLOW_BROKER_DEMOTION_SCORE_CONFIG: 1}, device=dev))):
                det.detect(now)
        t0 = time.monotonic()
        detection_pass()
        torch.cuda.synchronize()
        summary["pass_s"] = round(time.monotonic() - t0, 3)
        if not rehearse:
            prof = profile_mid(torch, detection_pass, summary["pass_s"], 1, "detection pass",
                               log)
            summary["pass_busy"] = prof["busy"]
            summary["pass_device_ms"] = round(prof["device_ms"], 3)
        os.environ["CRUISE_DETECTOR_ORACLE"] = "1"

        # Tick 2: brokers 0, 10, ..., 90 die.
        cluster = mc.cluster()
        mc.refresh(dataclasses.replace(cluster, brokers=tuple(
            dataclasses.replace(b, is_alive=b.broker_id not in dead) for b in cluster.brokers)))
        cuda.reset_launch_counts()
        t0 = time.monotonic()
        found = mgr.run_detectors_once(now + WINDOW_MS)
        queued = _anomaly_rows(mgr)
        handled = mgr.handle_anomalies_once(now + WINDOW_MS + 1)
        torch.cuda.synchronize()
        summary["dead_tick_s"] = round(time.monotonic() - t0, 3)
        counts["dead"] = {n: f.launches for n, f in cuda.COUNTED.items() if f.launches}
        state = mgr.state_dict()
        failures = [a for a in mgr.state.recent(danom.AnomalyType.BROKER_FAILURE)]
        log(f"tick 2, brokers {sorted(dead)} dead ({summary['dead_tick_s']} s): {found} "
            f"anomalies {queued}; broker failures {[s.status for s in failures]}; "
            f"balancedness {goal_detector.balancedness_score}; launches {counts['dead']}")
        if not failures or set(failures[-1].anomaly.failed_brokers) != dead:
            raise RuntimeError("the broker-failure detector did not report the dead brokers")
        if any(name == "GoalViolations" for name, _ in queued):
            raise RuntimeError("the goal-violation detector did not defer to the failures")
        if goal_detector.balancedness_score != BALANCEDNESS_SCORE_WITH_OFFLINE_REPLICAS:
            raise RuntimeError("the balancedness score is not pinned while replicas are offline")
        if not rehearse and not counts["dead"].get("stack_sweep"):
            raise RuntimeError("tick 2's offline verdict did not come from K9's sweep")
    finally:
        cuda.CAPTURE = None
        if oracle is None:
            os.environ.pop("CRUISE_DETECTOR_ORACLE", None)
        else:
            os.environ["CRUISE_DETECTOR_ORACLE"] = oracle
    return counts, summary


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
