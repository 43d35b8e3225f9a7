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
   first launch are captured; then the mid fused and the large pipelined
   warm-ups (the step graphs of phases 5 and 9; K1's and the round sums'
   first inputs at large) and K8's gated-off replay at both, timed before
   any profiler session (``gated_off_replay``);
4. each hand-written kernel against its plain PyTorch version on the card,
   on seeded fixtures and on the captured inputs (K9's sweep, frontier mask
   and batch on the mid rung, the second mid snapshot with its dead broker
   and the large rung, each batch row against its goal's frontier mask;
   K9's device ms on the 7,000-broker fleet for phase 21; K11 and K11
   cross's gate on their case tables; K11
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
   replayed step against the same step run eagerly, its credited launches
   against the eager step's; gated off: no launch credited, the state
   unchanged, the gate kernel the only device op of a profiled replay,
   timed beside the eager gated-off step and the body replayed without its
   gate) and K12 (the fused driver with its step graphs against the same
   driver with its gated steps run eagerly) are timed and checked;
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
   kernel of the path launched (every call site of K6's argsort too:
   ``argsort_sites``), at least one chunk compacted and one speculative
   follow-up — per goal its chunks, buckets, replays (gated
   off), follow-ups (wasted), host fetches and wall; a repeat gives
   identical proposals; a profile gives the busy share and ops per step;
   every frontier mask the warm-up computed is held against the plain
   version;
9. large rung, the service's call: the full stack through
   ``optimize(fused=True, donate_model=True)`` with no ``pipeline``
   argument — the inter-goal pipeline: warm-up, then a timed run with the
   counters set to 0 just before — every hard goal satisfied,
   ``verify_run``, every kernel of the path launched (K9 batch and K11
   cross included; every argsort call site), at least one opener
   dispatched; per goal whether it
   adopted an opener, its boundary gap, openers dispatched and wasted,
   their replays (gated off), fused group, chunks, replays and wall; a
   repeat gives identical proposals; a profile, with the run's gated-off
   replays and device time; a distribution goal's step graph replayed gated
   off as in phase 5; the sequential and the
   pipelined walls timed in turns in this call (and the pipeline with the
   other ``OPENER_QUEUE``, 0 or 1, gated steps queued behind each opener),
   and whether their placements agree;
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
12b. multi-round selection (``check_multi_round``): the large rung's full
    stack at ``moves_per_broker_step`` = 256 (two selection rounds of 128
    lanes a broker) on the pipelined and on the sequential per-goal path, a
    warm-up that captures the step graphs and keeps K4's first inputs of
    rounds 2 on, then a timed run with the counters set to 0 just before:
    every hard goal held, ``verify_run`` under that constraint, each K4
    kernel launched (K4d's used sets too), the same placement and per-goal
    steps and actions as the eager driver; the mid rung's grouped solve at
    256 on the card and on the CPU plain path, placed alike;
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
    the xl250 solve (phase 15), and timed, with the row-index build alone
    (event and device ms) and the topic tables' kernel alone beside them;
    at mid and large the aggregates also against the plain version on CPU
    copies, and on C = 1, C = 5 and a blend with a fifth of the replicas
    moved to broker 0, and the row indexes built on the card against their
    plain build;
15. xl250 rung (1000 brokers, ~250k replicas, ``segment_steps`` 32 by the
    JAX package's rule) on the default pipelined path, the stack of
    ``XL_GOALS``, profiled (its gated-off replays and device time); then
    the mid fused solve again (the graph cache past its four shapes): the
    proposals of phase 5;
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
    and dead disks), large and xl250 with 4 disks a broker, timed with the
    disk index's build beside them, the disk loads at mid and large also on
    C = 1, C = 5 and a blend with a fifth of the replicas on broker 0's
    first disk;
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
19. the service front (``check_service``): the large rung's placement as
    cluster metadata, four sampled windows into a ``LoadMonitor`` on the
    card, ``CruiseControl(device="cuda")`` behind ``CruiseControlApi``;
    with ``CRUISE_FLIGHT_RECORDER=1``, ``GET /proposals`` from a cold cache
    with the counters set to 0 just before (the pipelined path: every
    kernel launched, ``cc_flight_row`` once per executed step),
    ``POST /rebalance`` dry run (the same proposals) and ``GET /flight`` of
    its task (each goal's rows summing to its actions, equal to the
    ``/proposals`` solve's timelines); the same solve run eagerly with the
    plain flight row in the kernel's place gives the same rows (integer
    slots and score bits) and placement; with the recorder off the same
    requests place alike and record nothing; ``cc_flight_row`` against its
    plain twin on its captured inputs (and, in phase 4, on seeded inputs at
    the service shape and on ``FLIGHT_EDGES``, active and gated off, and
    through its C entry into canary-guarded buffers), timed; the mid rung under
    ``_DBG_NO_BUDGETS`` (at most ``ABLATION_STEPS`` steps a goal):
    ``cc_band_accepts`` launched, bit for bit on its captured inputs, the
    card placed as the CPU, timed; the mid rung under
    ``CRUISE_REPAIR_ORACLE=1`` (gated steps eager on the card, the loop's
    host reads counted), placed as on the CPU;
20. the sharded search (``check_mesh``; its kernel K15,
    ``cc_shard_combine``, is held against its plain twin in phase 4,
    ``check_k15``: bit for bit on the card and against the CPU, on seeded
    partials of 2 ranks x 50 and 200 brokers and 8 ranks x 7,000 brokers,
    timed beside the twin and ``torch.sum``): the mid and large
    rungs (replicas padded to a multiple of 8) in bench.py's mesh flavour
    (``MESH_FLAVOUR``, dense floor 16) on one device, then replica-sharded
    over 2 ranks sharing the card (gloo, host-staged collectives, eager
    steps), with the counters set to 0 just before each rank's solve: both
    ranks verified and equal, every step kernel and K15 launched on each,
    mid placed exactly as one device with equal per-goal steps and actions,
    large the same or else equisatisfying past the first goal that differs
    (reported); the mid rung over a one-rank NCCL group, placed as one
    device bit for bit; walls, collectives and gathered bytes per rank;
21. K1, ``segment_sum``'s three modes and their row index
    (``check_family``) at the mid, large and xl250 rungs' shapes, on the
    inputs the mid warm-up (phase 3) and the large and xl250 warm-ups
    (phases 3 and 15) gave K1 and the round sums: bit for bit against
    their plain twins on CPU copies in five cases (the rung's inputs, a
    fifth of the rows on one segment, all masked, an empty segment, ids
    outside [0, S)), each case's launches also into buffers between canary
    bands (``guarded_writes``), identical over two launches and a graph
    replay, timed as one call and as many calls in a replayed CUDA graph
    beside ``index_add_`` (the index: ``torch.sort``) timed the same way.
    It runs after every profiler session: a session that replays the step
    graphs after this script's own graphs were captured and destroyed can
    end in a segmentation fault inside ``cudaGraphLaunch``, with or without
    CUPTI's teardown (``cupti_graph_check.py --smoke`` repeats that order
    with graphs of torch's own ops, on any checkout); then K3
    (``check_k3``) through ``prefix_cut_admit`` and ``prefix_admit_safe``
    on the inputs the mid, large and xl250 warm-ups and the goal kinds'
    first topic cut gave it and on seeded cases (``k3_cases``: positions on
    the running totals' level edges, tied scores with +0 and -0,
    non-dyadic deltas, one segment holding every row, empty segments, no
    kept row, segments out of band at their first position, a topic cut's
    shape, 4,096, 4,097 and 40,000 segments: both groupings): bit for bit
    against its plain twin on the card and on CPU copies, identical over
    two launches and a graph replay, into canary-guarded buffers, timed on
    the run inputs as one call (and its host time) and in a replayed graph
    beside one stable ``torch.sort`` of the order's composite key (K3's
    device ms a call, its sort and grouping included, comes from the
    profiler in phase 4 for mid and at the large and xl250 warm-ups); and
    the ordered sum (``check_ordered_sum``) on phase 4's fixtures the same
    way, timed at B = 50, 200 and 1,000 brokers, one column and four,
    beside ``torch.sum``; and K9 (``check_k9``) on the models the mid,
    large and xl250 warm-ups handed the sweep and on a 7,000-broker fleet
    (``FLEET``): the sweep of the stack, every band goal's frontier mask and
    the batch of the stack, the sweep of the stack and the replica- and
    topic-axis kinds beyond it on the large model with its last replica in
    a rack conflict, reported offline or led wrongly and with a dead broker,
    the frontier mask on seeded rows of 1 to 8,192 brokers (ties, +0 and
    -0, every broker over its band, none under it, no surplus, dead brokers
    hosting replicas; up to 1,024 brokers through both of its sorts) and the
    batch on stacks of them: bit for bit against their plain twins on CPU
    copies (the sweep also on the card), identical over two launches and a
    graph replay, into canary-guarded outputs, timed at each shape as one
    call and in a replayed graph beside the plain twin and the bound, with
    the device ms a launch and a call profiled at the warm-ups (phase 4 for
    mid and the fleet), and the frontier mask's two sorts timed against
    each other at 50 to 1,000 brokers; and K8's flight row at the service
    shape in a graph replay, active and gated off, against its plain twin
    (``check_flight_row_graph``); and K4a-K4d (``check_k4``) on the inputs
    of the large pipelined warm-ups at the default configuration (phase 3)
    and at 256 moves a step (phase 12b) and on seeded edges (no lane
    eligible or kept and every lane, every leg on key 0, every budget +inf,
    zero deltas as -0.0, every lane on one partition): bit for bit against
    their plain twins on the card and on CPU copies, identical over two
    launches and a graph replay, into canary-guarded buffers, timed beside
    the plain twin, the bound and, for K4b and K4d, one ``index_add_`` or
    ``scatter_reduce_``; and K4e, K6's top-k, group rank and argsorts
    (``check_new_kernels``: ``cc_argsort`` and ``cc_row_argsort`` on every
    form the mid and large warm-ups recorded, by call site, and on
    ``argsort_edges`` / ``row_argsort_edges``) the same way, beside
    ``torch.topk``, ``torch.sort`` with ``cummax`` and the stable
    ``torch.sort``;
22. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
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

# The row index's device kernels (K1's and segment_sum's first three
# launches; K3's grouping launches them too).
INDEX_KERNELS = ("index_scatter_kernel", "index_count_kernel", "index_scan_kernel")
# K3's own device kernels after its sort and grouping.
K3_KERNELS = ("prefix_flags_kernel", "prefix_rows_kernel", "prefix_scan_kernel",
              "prefix_admit_kernel", "sorted_offsets_kernel")
# Device kernel names of each wrapper, as the profiler reports them.
PROFILE_NAMES = {
    # K1 and segment_sum: the walk alone (a run's profile adds the row
    # index's time a launch to each, ``profile_mid``).
    "broker_aggregates": ("broker_aggregates_kernel",),
    "segment_sum": ("segment_sum_kernel",),
    "segment_row_index": INDEX_KERNELS,
    "best_per_segment": ("segment_max_key", "segment_winner"),
    # K3: the count of its flags pass, the time of its own four kernels
    # (its score sort and grouping run as torch's sort and the row index's
    # kernels).
    "prefix_cut": K3_KERNELS,
    "goal_masks": ("goal_masks_kernel",),
    "transport_rank": ("transport_rank_kernel",),
    "transport_lookup": ("transport_lookup_kernel",),
    "apply_actions": ("apply_actions_kernel",),
    "cluster_stats": ("cluster_stats_kernel",),
    "structural_accepts": ("structural_accepts_kernel",),
    # K9: the sweep's one kernel (its two memsets are not counted here; a
    # call's every device op is, where a row says "a call"), and the
    # frontier kernels, templated on the slots a thread holds
    # (frontier_active_kernel<1> ... <8>).
    "stack_sweep": ("stack_sweep_kernel",),
    "frontier_active": ("frontier_active_kernel",),
    "frontier_active_batch": ("frontier_active_batch_kernel",),
    "chunk_gate": ("chunk_gate_kernel",),
    "cross_gate": ("cross_gate_kernel",),
    "chunk_touched": ("chunk_touched_kernel",),
    "ordered_sum": ("ordered_sum_kernel",),
    "blend_aggregates": ("blend_aggregates_kernel", "blend_topic_counts_kernel"),
    "masks_by_partition": ("masks_by_partition_kernel",),
    "stack_sweep_batch": ("stack_sweep_batch_kernel",),
    # K4: the selection glue (its K4b a count and a key pass, its K4d a
    # scatter and, in a claim round, a drop pass).
    "select_mask": ("select_mask_kernel",),
    "topic_round_sums": ("topic_count_kernel", "topic_viol_kernel"),
    "net_viol": ("net_viol_kernel",),
    "partition_claims": ("claim_scatter_kernel", "claim_drop_kernel"),
    # K4e (one kernel each), K6's top-k (a call is one to thirteen of its
    # kernels, by its path: the count here is of its kernels, its device ms
    # a call comes from phase 4) and K6's group rank (four kernels a call).
    "select_legs": ("select_legs_kernel",),
    "frontier_budgets": ("frontier_budgets_kernel",),
    "top_k": ("topk_",),
    "group_rank": ("rank_count_kernel", "rank_scan_kernel", "rank_scatter_kernel",
                   "rank_count_above_kernel"),
    # K6's argsort (a call is one launch up to 2,048 entries, else a memset
    # and two launches a pass: the count here is of its kernels, its device
    # ms a call comes from phase 4) and its row sort (one launch a call).
    "argsort": ("argsort_",),
    "row_argsort": ("row_sort_kernel",),
}

KERNELS = {
    # name: (source, JAX function it replaces)
    "broker_aggregates": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                          "cruise_control_tpu/ops/segment.py:22"),
    "segment_sum": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                    "cruise_control_tpu/analyzer/optimizer.py:663"),
    # The per-segment row index K1 and segment_sum walk: part of their
    # replacement of the scatter-adds (no JAX function builds one).
    "segment_row_index": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                          "cruise_control_tpu/ops/segment.py:22"),
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
    # K4, the selection glue of select_batched (optimizer.py:410-871).
    "select_mask": ("cruise_control_tpu_torch/csrc/selection.cu",
                    "cruise_control_tpu/analyzer/optimizer.py:599"),
    "topic_round_sums": ("cruise_control_tpu_torch/csrc/selection.cu",
                         "cruise_control_tpu/analyzer/optimizer.py:671"),
    "net_viol": ("cruise_control_tpu_torch/csrc/selection.cu",
                 "cruise_control_tpu/analyzer/optimizer.py:739"),
    "partition_claims": ("cruise_control_tpu_torch/csrc/selection.cu",
                         "cruise_control_tpu/analyzer/optimizer.py:649"),
    # K4e, the leg build and the compaction's gathers (optimizer.py:514-580),
    # and K6's top-k (every jax.lax.top_k: the compaction at optimizer.py:512,
    # the builders at candidates.py:111-643) and group rank.
    "select_legs": ("cruise_control_tpu_torch/csrc/selection.cu",
                    "cruise_control_tpu/analyzer/optimizer.py:514"),
    "frontier_budgets": ("cruise_control_tpu_torch/csrc/selection.cu",
                         "cruise_control_tpu/analyzer/optimizer.py:521"),
    "top_k": ("cruise_control_tpu_torch/csrc/top_k.cu",
              "cruise_control_tpu/analyzer/candidates.py:111"),
    "group_rank": ("cruise_control_tpu_torch/csrc/group_rank.cu",
                   "cruise_control_tpu/analyzer/goals/kernels.py:791"),
    # K6's argsorts: the matched builders' [R] sorts (candidates.py:177, 297,
    # 319) with K3's score and regroup sorts (goals/kernels.py:1006-1007),
    # and the builders' [T, B] row orders (candidates.py:280, 330, 331).
    "argsort": ("cruise_control_tpu_torch/csrc/argsort.cu",
                "cruise_control_tpu/analyzer/candidates.py:177"),
    "row_argsort": ("cruise_control_tpu_torch/csrc/argsort.cu",
                    "cruise_control_tpu/analyzer/candidates.py:280"),
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
    # Keep CUPTI set up between the script's many profiler sessions, as
    # torch does for its own CUDA graphs (torch.profiler.profile's
    # start_trace): re-initialising it for a session that replays graphs
    # is a known CUPTI fault.
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")
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
    from cruise_control_tpu_torch.ops import cuda, order

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {n: cuda.COUNTED[n] for n in KERNELS}
    dev = torch.device("cpu" if rehearse else "cuda")
    mid_rung, large_rung, hundred_rung, xl_rung = MID, LARGE, HUNDRED, XL250
    two_racks_rung, fleet_rung = TWO_RACKS, FLEET
    timer = time_ms
    # The per-goal path as the service asks for it above 64 brokers.
    per_goal = dict(pipeline=False)
    if rehearse:
        mid_rung, large_rung, timer = (12, 4, 6, 20.0, 2), (16, 4, 8, 20.0, 3), host_time_ms
        hundred_rung, xl_rung = (16, 4, 5, 30.0, 2), (20, 4, 6, 20.0, 2)
        two_racks_rung, fleet_rung = (12, 2, 6, 20.0, 3), (40, 5, 6, 20.0, 3)
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
        counts = cuda.launch_counts()
        return {n: counts[n] for n in wrappers}

    def argsort_sites(label):
        """K6's argsort launches of the run just timed, by call site: the
        builders' broker, pair and topic sorts and [T, B] row sorts (the
        latter three from TopicReplicaDistributionGoal), K3's score sorts and
        its regroups above 4,096 segments; every site must have launched."""
        counts = cuda.launch_counts()
        sites = {m: counts[f"argsort[{m}]"] for m in order.ARGSORT_MODES}
        log(f"{label} argsort launches by site: {sites}")
        idle = [m for m, c in sites.items() if c == 0]
        if not rehearse and idle:
            raise RuntimeError(f"argsort sites not launched on the {label} run: {idle}")
        return sites

    def check_launched(label, counts, path=None):
        skip = NOT_ON.get(path, ()) + EXECUTION_ONLY + tuple(DETECTION_KERNELS)
        idle = [n for n, c in counts.items() if c == 0 and n not in skip]
        if not rehearse and idle:
            raise RuntimeError(f"kernels not launched on the {label} path: {idle}; {counts}")

    def check_run(label, initial, run, goals, con=None):
        for g in run.goal_results:
            log(f"  {label} {g.name:38s} steps={g.steps:3d} actions={g.actions_applied:5d} "
                f"satisfied {g.satisfied_before}->{g.satisfied_after} "
                f"{g.duration_s:.3f}s replays={g.replays} fetches={g.fetches} "
                f"captured={g.fresh_compile}")
        bad = [g.name for g in run.goal_results if g.is_hard and not g.satisfied_after]
        if bad:
            raise RuntimeError(f"{label}: hard goals unsatisfied: {bad}")
        proposals = props.diff(initial, run.model)
        verify_run(initial, run, goals, constraint=con, proposals=proposals)
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
    # K4e's, K6 top-k's and group rank's forms, for phases 4 and 21.
    new_inputs = {"mid": new_kernel_inputs(captured)}
    # (K1's plain path on the CPU builds no row index.)
    missing = [n for n in wrappers
               if n not in captured and n not in NOT_ON["unfused"] + EXECUTION_ONLY
               and not (rehearse and n == "segment_row_index")]
    if missing:
        raise RuntimeError(f"kernels never launched in the warm-up run: {missing}")
    warm_props = check_run("mid-warm", mid, run_warm, STACK)
    # The step graphs of the mid fused solve (phase 5's) and of the large
    # pipelined solve (phase 9's), captured here, and a gated-off replay of
    # each timed before any profiler session: a session leaves CUPTI set up
    # (TEARDOWN_CUPTI=0), which adds host time to every later graph launch.
    graphs.GRAPHS.clear()
    t0 = time.monotonic()
    run_capture = fused_run(mid)
    torch.cuda.synchronize()
    capture_s = time.monotonic() - t0
    large = generate_cluster(spec_of(large_rung), device=dev)
    cuda.CAPTURE = {}  # K1's and the round sums' first inputs at the large rung
    try:
        fused_run(large)
        torch.cuda.synchronize()
    finally:
        kept_large, cuda.CAPTURE = cuda.CAPTURE, None
    new_inputs["large"] = new_kernel_inputs(kept_large)
    k8_early = {}
    if not rehearse:
        k8_early = {label: gated_off_replay(torch, graphs, model, goal, log, label,
                                            profiled=False)
                    for label, model, goal in (
                        ("mid", mid, "TopicReplicaDistributionGoal"),
                        ("large", large, band_goal_graphed(graphs, large)))}

    # 4. kernels against their plain versions
    phase("kernels")
    second, second_opts = second_snapshot(torch, np, mid, SECOND_SEED)
    results = check_kernels(torch, np, dev, captured, wrappers, log, timer)
    # K1's, the round sums', K3's and K9's inputs at each rung, for phase 21;
    # K9's device ms at each, profiled here (see the docstring, phase 21).
    family_inputs_of, family, k3_inputs, k9_inputs, k9_device = {}, {}, {}, {}, {}
    k4_inputs = {}

    def keep_family_inputs(label, kept):
        if kept.get("segment_sum", (None,) * 5)[4] != "round":
            raise RuntimeError(f"the {label} run kept no round sums' inputs")
        if "prefix_cut" not in kept or "stack_sweep" not in kept:
            raise RuntimeError(f"the {label} run kept no K3 or K9 sweep inputs")
        family_inputs_of[label] = {n: kept[n] for n in ("broker_aggregates", "segment_sum")}
        if label == "large":  # K4's inputs at the default configuration, for phase 21
            k4_inputs["large"] = {n: kept[n] for n in K4_INPUTS["large"]}
        k3_inputs[label] = kept["prefix_cut"]
        k9_inputs[label] = _clone(torch, kept["stack_sweep"][1:3])  # (model, arrays)
        if not rehearse:
            k9_device[label] = k9_device_ms(torch, gk, *k9_inputs[label], log)
        if label != "mid" and not rehearse:  # K3's device ms a call (phase 4: mid's)
            family.setdefault("prefix_cut", {})[f"device_ms_call_{label}"] = device_ms_total(
                torch, lambda: gk.prefix_cut_admit(*kept["prefix_cut"]), log)

    def check_family_at(label):
        kept = family_inputs_of.pop(label)
        for name, r in check_family(torch, np, log, timer, label, kept["broker_aggregates"],
                                    kept["segment_sum"], rehearse).items():
            family.setdefault(name, {}).update(r)

    keep_family_inputs("mid", captured)
    results.update(check_frontier_kernels(torch, np, captured, wrappers, log, timer,
                                          {"mid": mid, "second": second, "large": large}))
    results.update(check_pipeline_kernels(torch, np, wrappers, log, timer,
                                          {"mid": mid, "second": second, "large": large}))
    # K9 at the detector fleet's 7,000 brokers, for phase 21.
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    fleet = generate_cluster(spec_of(fleet_rung), device=dev)
    k9_inputs["fleet"] = (fleet, BrokerArrays.from_model(fleet))
    log(f"fleet: {int(fleet.replica_valid.sum())} replicas, {fleet.num_brokers} brokers")
    if not rehearse:
        k9_device["fleet"] = k9_device_ms(torch, gk, *k9_inputs["fleet"], log)
    del fleet
    # K14 (phase 18's kernels) here, where the profiler reads device times
    # reliably: late in the script its sessions now and then record no op.
    import types
    k14_rows = check_k14(types.SimpleNamespace(torch=torch, np=np, log=log, dev=dev,
                                               rehearse=rehearse, timer=timer))
    # Phase 19's kernels likewise: K8's flight row and the band accepts.
    service_rows = check_service_kernels(types.SimpleNamespace(
        torch=torch, np=np, opt=opt, gk=gk, log=log, dev=dev, rehearse=rehearse,
        timer=timer))
    # And phase 20's K15.
    k15_rows = check_k15(types.SimpleNamespace(torch=torch, np=np, log=log, dev=dev,
                                               rehearse=rehearse, timer=timer))
    # K4e's, K6 top-k's and group rank's device ms a call on the warm-ups'
    # inputs, for phase 21 (profiled here, before any graph of this script).
    new_device = {} if rehearse else new_kernels_device_ms(torch, new_inputs, log)

    # 5. mid rung as the service runs it: fused, step graphs
    phase("mid fused")
    captures = sum(g.fresh_compile for g in run_capture.goal_results)
    log(f"mid fused warm-up run (phase 3; captured {captures} step graphs): {capture_s:.2f} s")
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
    keep_family_inputs("large", kept_large)  # phase 3's pipelined warm-up's
    del kept_large
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
    argsort_sites("large per-goal")
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
    pipe_sites = argsort_sites("large pipelined")
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
        large_off = gated_off_replay(torch, graphs, large, band_goal_graphed(graphs, large),
                                     log, "large")
    else:
        prof_pipe = {"ops": None, "ops_per_step": None, "busy": None,
                     "per_launch": {n: None for n in wrappers}}
        large_off = None
    log(f"large pipelined: {pipe_summary['gated_off']} of {pipe_summary['replays']} replays "
        f"gated off ({pipe_summary['opener_gated_off']} of the openers' "
        f"{pipe_summary['opener_replays']}), {pipe_steps} steps, device time "
        f"{prof_pipe.get('device_ms')} ms")
    # The sequential and the pipelined walls in turns, in this call, and the
    # pipeline with the other choice of opener steps queued behind each opener
    # (opt.OPENER_QUEUE 0 or 1) beside its default.
    queue = opt.OPENER_QUEUE
    other = f"OPENER_QUEUE={1 - queue}"
    walls = {"sequential": [], "pipelined": [], other: []}
    try:
        for label in ("sequential", "pipelined", other) * 2 + \
                (other, "pipelined", "sequential") * 2:
            opt.OPENER_QUEUE = 1 - queue if label == other else queue
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

    # 12b. multi-round selection: moves_per_broker_step=256 at large on the
    # pipelined and the per-goal path against the eager drivers, and mid
    # card against CPU; K4's inputs of rounds 2 on kept for phase 21
    phase("multi-round")
    import types
    multi_summary, multi_counts, k4_inputs["large-256"] = check_multi_round(
        types.SimpleNamespace(
            torch=torch, opt=opt, log=log, dev=dev, rehearse=rehearse, large=large,
            mid_rung=mid_rung, spec_of=spec_of, generate_cluster=generate_cluster,
            fused_run=fused_run, timed=timed, check_run=check_run,
            same_placement=same_placement, per_goal=per_goal,
            default_rows={"pipelined": run_pipe, "per-goal": run_large}))

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
    cuda.CAPTURE = {}
    try:
        fused_run(xl, XL_GOALS)
        torch.cuda.synchronize()
    finally:
        kept, cuda.CAPTURE = cuda.CAPTURE, None
    keep_family_inputs("xl250", kept)
    del kept
    xl_warm = time.monotonic() - t0
    run_xl, xl_wall, xl_counts = timed(lambda: fused_run(xl, XL_GOALS))
    check_run("xl250", xl, run_xl, XL_GOALS)
    xl_summary = pipeline_report(run_xl, log, "xl250")
    log(f"xl250 pipelined {run_xl.pipelined}: warm-up {xl_warm:.2f} s, timed {xl_wall:.3f} "
        f"s, {xl_summary}")
    check_launched("xl250", xl_counts)
    if not run_xl.pipelined:
        raise RuntimeError("the xl250 default solve did not pipeline")
    prof_xl = (profile_mid(torch, lambda: fused_run(xl, XL_GOALS), xl_wall,
                           xl_summary["steps"], "xl250", log) if not rehearse else {})
    log(f"xl250: {xl_summary['gated_off']} of {xl_summary['replays']} replays gated off "
        f"({xl_summary['opener_gated_off']} of the openers' {xl_summary['opener_replays']}), "
        f"{xl_summary['steps']} steps, device time {prof_xl.get('device_ms')} ms")
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
        rehearse=rehearse, k3_inputs=k3_inputs, timer=timer, fused_run=fused_run, mid=mid,
        mid_rung=mid_rung,
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

    # 19. the service front: /proposals, /rebalance and /flight with the
    # flight recorder (K8's flight rows), the budget ablation
    # (accepts_band_batch) and the repair oracle
    phase("service")
    cx.gk = gk
    t_service = time.monotonic()
    service_counts, service_summary = check_service(cx)
    service_summary["phase_s"] = round(time.monotonic() - t_service, 1)
    log(f"service summary: {service_summary}")

    # 20. the sharded search: mid and large replica-sharded over 2 ranks
    # sharing the card (gloo), mid over a one-rank NCCL group, each against
    # the one-device solve (K15 against its twin ran in phase 4)
    phase("mesh")
    cx.timed = timed
    t_mesh = time.monotonic()
    mesh_counts, mesh_summary = check_mesh(cx)
    mesh_summary["phase_s"] = round(time.monotonic() - t_mesh, 1)
    log(f"mesh summary: {mesh_summary}")

    # 21. K1, segment_sum's modes and their row index at each rung's shapes,
    # K3 and the ordered sum on every case, after every profiler session
    # (see the docstring)
    phase("K1 family, K3, ordered sum, K9, K8's flight row, K4, K4e, K6 top-k, group rank "
          "and argsorts")
    for label in ("mid", "large", "xl250"):
        check_family_at(label)
    for name, r in check_k3(torch, np, log, timer, k3_inputs, rehearse).items():
        family.setdefault(name, {}).update(r)
    family.update(check_ordered_sum(torch, np, log, timer, captured["ordered_sum"][0],
                                    rehearse))
    for name, r in check_k9(torch, np, log, timer, k9_inputs, k9_device, rehearse).items():
        family.setdefault(name, {}).update(r)
    del k9_inputs
    if not rehearse:
        check_flight_row_graph(torch, np, opt, dev, log)
    k4_rows = check_k4(torch, np, log, timer, k4_inputs, rehearse)
    del k4_inputs
    for name, r in k4_rows.items():
        results[name] = {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                            "max_abs_err")}
        family.setdefault(name, {}).update(
            {k: v for k, v in r.items() if k not in results[name]},
            launches_large_pipelined_256=multi_counts["pipelined"][name],
            launches_large_per_goal_256=multi_counts["per-goal"][name])
    new_rows = check_new_kernels(torch, np, log, timer, new_inputs, new_device, dev, rehearse)
    del new_inputs
    new_rows["argsort"]["launches_by_site_large_pipelined"] = pipe_sites
    for name, r in new_rows.items():
        results[name] = {k: r.get(k) for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                "max_abs_err", "device_ms", "shape")}
        family.setdefault(name, {}).update(
            {k: v for k, v in r.items() if k not in results[name]},
            launches_large_pipelined_256=multi_counts["pipelined"][name],
            launches_large_per_goal_256=multi_counts["per-goal"][name])

    # 22. results
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
        f"{detect_summary}; service {service_summary}; mesh {mesh_summary}; multi-round "
        f"{multi_summary}; card {smi}")
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
                 or k.startswith("device_ms_call")
                 or k in ("shape", "index_ms", "index_device_ms", "topic_device_ms",
                          "index_library_ms", "index_bound_ms")}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches, **extra,
                     **family.get(name, {}),
                     "launches_per_large_step": pipe_counts[name] / max(pipe_steps, 1),
                     "launches_large_sequential": large_counts[name],
                     "launches_fused_mid": fused_counts[name],
                     "launches_unfused_mid": mid_counts[name],
                     "launches_xl250": xl_counts[name],
                     "launches_execution": exec_counts[name],
                     "launches_detection_tick": detect_counts["tick"][name],
                     "launches_detectors": detect_counts["detect"].get(name, 0),
                     "launches_service": service_counts["service proposals"][name],
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
                 or k in ("shape", "device_ms_call")}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": kind_counts[run_label].get(name, 0),
                     "launches_run": run_label, **extra, **family.get(name, {}),
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
                 or k in ("shape", "index_ms", "index_device_ms", "index_library_ms",
                          "index_bound_ms")}
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": r["launches"],
                     "launches_run": run_label, **extra, **family.get(name, {}),
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
    # K8's flight rows (launched in the service's recorder-on solve) and
    # accepts_band_batch (the mid ablation), timed on seeded inputs at the
    # shapes of SERVICE_SHAPES and held on their captured inputs too.
    for name, (source, replaces, run_label) in SERVICE_KERNELS.items():
        r = service_rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": service_counts[run_label][name],
                     "launches_run": run_label, "shape": r["shape"],
                     "launches_shape": service_summary[f"{name}_captured"],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": r["device_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # K15: timed at the large mesh's shape (2 ranks, 200 brokers), the mid
    # and the 7,000-broker fleet's shapes beside; launched by rank 0 of the
    # large solve over 2 ranks, the mid solves' counts beside.
    for name, (source, replaces) in MESH_KERNELS.items():
        r = k15_rows[K15_SHAPES[1]]
        extra = {}
        for suffix, shape in (("mid", K15_SHAPES[0]), ("fleet", K15_SHAPES[2])):
            extra.update({f"{k}_{suffix}": v for k, v in k15_rows[shape].items()
                          if k in ("shape", "ms", "device_ms", "plain_ms", "bound_ms",
                                   "library_ms")})
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": mesh_counts["large 2 ranks"][name],
                     "launches_run": "large over 2 ranks (rank 0)", "shape": r["shape"],
                     "launches_mid_2_ranks": mesh_counts["mid 2 ranks"][name],
                     "launches_mid_nccl": mesh_counts["mid nccl"][name], **extra,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": r["device_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    # K12's device time is the whole fused solve's (its eager per-goal
    # set-up included), from the fused profile.
    graph_results["goal_chain"]["device_ms_per_launch"] = prof_fused.get("device_ms")
    # K8 at large (a distribution goal's dense graph gated off), and the
    # gated-off replays and device time of the large pipelined and xl250 runs.
    # "ms": the event ms of phase 3, before any profiler session; the same
    # replay timed later, with CUPTI left set up, beside it.
    step_row = graph_results["step_graph"]
    if large_off is not None:
        step_row.update({f"{k}_large": large_off[k] for k in ("goal", "device_ms", "device_ops",
                                                             "body_replay_ms")})
        step_row["ms_large_after_profiler"] = large_off["ms"]
    if k8_early:
        step_row["ms_after_profiler"] = step_row["ms"]
        step_row["ms"] = k8_early["mid"]["ms"]
        step_row["ms_large"] = k8_early["large"]["ms"]
        step_row["counter_read_ms"] = k8_early["mid"]["counter_read_ms"]
    step_row.update(
        replays_large_pipelined=pipe_summary["replays"],
        gated_off_large_pipelined=pipe_summary["gated_off"],
        device_ms_large_pipelined=prof_pipe.get("device_ms"),
        replays_xl250=xl_summary["replays"], gated_off_xl250=xl_summary["gated_off"],
        device_ms_xl250=prof_xl.get("device_ms"))
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


def device_ms_total(torch, fn, log, runs: int = 5):
    """Device time per call of ``fn`` under ``torch.profiler``: every device
    op it runs (K10's row-index build is torch's sort, search and elementwise
    kernels), over ``runs`` calls; None when three sessions saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if ops:
            return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / runs
        log(f"  profiler, attempt {attempt + 1}: no device op")
    return None


def k10_index_build(gk, before, after, masks, disk):
    """What K10's wrapper does before a blend kernel's launch: the masks
    transposed to [P, C], the per-broker (``disk``: per-disk) row index and
    for the aggregates the per-topic row index."""
    return lambda: gk.blend_indexes(before, after, masks, disks=disk, topics=not disk)


def k10_index_keys(torch, before, after, disk):
    """The keys ``blend_row_index`` sorts for K10's index build, as its plain
    version forms them: segment * R + row, a row outside every segment past
    the last; the per-broker (per-disk) index over the before and the moved
    after rows, and for the aggregates the per-topic index."""
    R = before.replica_broker.shape[0]
    rows = torch.arange(R, dtype=torch.int64, device=before.replica_broker.device)
    f, S = ("replica_disk", before.num_disks) if disk else ("replica_broker",
                                                            before.num_brokers)
    b, a = getattr(before, f).long(), getattr(after, f).long()
    v = before.replica_valid
    held_b = v & (b >= 0) & (b < S)
    held_a = v & (a >= 0) & (a < S) & (a != b)
    keys = [torch.cat([torch.where(held_b, b, S) * R + rows,
                       torch.where(held_a, a, S) * R + rows])]
    if not disk:
        t = before.replica_topic.long()
        keys.append(torch.where(v, t, before.num_topics) * R + rows)
    return [k.to(torch.int32) if int(k.max()) < 2 ** 31 else k for k in keys]


def _k10_index_bytes(keys, masks, segments):
    """Bytes K10's index build must move: the masks read and written
    transposed, and for each index its keys and its rows written and the
    offsets of its ``segments``."""
    return 2 * masks.numel() + sum(k.numel() * (k.element_size() + 4) for k in keys) + \
        sum((s + 1) * 4 for s in segments)


def skewed_placement(torch, np, model, seed, share=0.2):
    """``model`` with a seeded ``share`` of its valid replicas moved to
    broker 0's first disk: one broker's and one disk's index list holds a
    fifth of the rows (K10's longest serial walk)."""
    rng = np.random.default_rng(seed)
    rb = model.replica_broker.cpu().numpy().copy()
    rd = model.replica_disk.cpu().numpy().copy()
    valid = np.nonzero(model.replica_valid.cpu().numpy())[0]
    pick = rng.choice(valid, int(share * valid.shape[0]), replace=False)
    rb[pick] = 0
    rd[pick] = int(model.broker_disks[0, 0])
    return model.with_placement(torch.from_numpy(rb).to(model.device), model.replica_is_leader,
                                torch.from_numpy(rd).to(model.device))


def check_k10_cases(torch, np, gk, log, before, after, label, disk):
    """K10's blend kernels bit for bit against their plain twins on the
    blends that stress the row index: C = 1 (the all-landed row) and C = 5
    of ``before`` and ``after``, and K10_BATCH blends of a skewed
    after-placement (``skewed_placement``).  ``disk``: the disk loads,
    against the plain version on CPU copies; else the aggregates with both
    topic tables, against the plain twin on the card."""
    masks, _ = k10_masks(torch, np, before, after, K10_BATCH, SEED)
    skewed = skewed_placement(torch, np, before, SEED)
    skew_masks, _ = k10_masks(torch, np, before, skewed, K10_BATCH, SEED + 1)
    pick = torch.tensor([0, 63, 127, 191, K10_BATCH - 1], device=masks.device)
    seg = "replica_disk" if disk else "replica_broker"
    num = before.num_disks if disk else before.num_brokers
    offsets, _ = gk.blend_row_index(getattr(before, seg), getattr(skewed, seg),
                                    before.replica_valid, num)
    longest = int((offsets[1:] - offsets[:-1]).max())
    # The row indexes built on the card against the plain build on the CPU.
    for b_seg, a_seg, n_seg in ((getattr(before, seg), getattr(skewed, seg), num),
                                (before.replica_topic, None, before.num_topics)):
        got_index = gk.blend_row_index(b_seg, a_seg, before.replica_valid, n_seg)
        want = gk.blend_row_index(b_seg.cpu(), None if a_seg is None else a_seg.cpu(),
                                  before.replica_valid.cpu(), n_seg)
        if not _exact(torch, got_index, want):
            raise RuntimeError(f"K10 ({label}): the row index built on the card differs from "
                               "the plain build")
    for m in (masks, masks[pick]):  # C = 256 and C = 5 (padded to 8 columns)
        if not _exact(torch, gk.masks_by_partition(m), gk.masks_by_partition(m.cpu())):
            raise RuntimeError(f"K10 ({label}): the masks by partition differ from the plain "
                               "transpose")
    for case, a, m in (("C=1", after, masks[-1:]), ("C=5", after, masks[pick]),
                       ("skewed", skewed, skew_masks)):
        if disk:  # the plain version on the card adds with index_add_'s atomics
            same = _exact(torch, gk.blend_disk_load(before, a, m),
                          gk.blend_disk_load_plain(before.to("cpu"), a.to("cpu"), m.cpu()))
        else:
            same = _exact(torch, tuple(gk.blend_aggregates(before, a, m, True,
                                                           with_topic_leaders=True)[:7]),
                          tuple(gk.blend_aggregates_plain(before, a, m, True, True)[:7]))
        if not same:
            raise RuntimeError(f"K10 {'disk loads' if disk else 'aggregates'} ({label}, "
                               f"{case}) differ from the plain twin")
    log(f"K10 {label} {'disk loads' if disk else 'aggregates'}: C=1, C=5 and the skewed "
        f"blends (longest index list {longest} of {int(before.replica_valid.sum())} rows) "
        f"bit-equal to the plain twin")


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
    if label in ("mid", "large"):
        cpu_ref = gk.blend_aggregates_plain(before.to("cpu"), after.to("cpu"), masks.cpu(),
                                            True, True)
        if not _exact(torch, tuple(got[:7]), tuple(cpu_ref[:7])):
            raise RuntimeError(f"K10 aggregates ({label}) differ from the plain version on "
                               "the CPU")
        del cpu_ref
        check_k10_cases(torch, np, gk, log, before, after, label, disk=False)
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
    build = k10_index_build(gk, before, after, masks, disk=False)
    keys = k10_index_keys(torch, before, after, disk=False)
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
                PROFILE_NAMES["blend_aggregates"], log),
            index_ms=time_ms(torch, build, fast),
            index_device_ms=None if rehearse else device_ms_total(torch, build, log),
            index_library_ms=time_ms(torch, lambda: [k.sort() for k in keys], fast),
            index_bound_ms=bound_ms(_k10_index_bytes(keys, masks, (B, T))),
            # The topic tables' share of the device time: their kernel alone.
            topic_device_ms=None if rehearse else device_ms(
                torch, lambda: ka(before, after, masks, True, with_topic_leaders=True),
                ("blend_topic_counts_kernel",), log)),
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
    del rows, seg, acc, rmask, keys
    log(f"K10 {label}: C={C} P={before.num_partitions} R={R} B={B} G={len(specs)} T={T}, "
        f"{moved} partitions moved; aggregates bit-equal to the plain twin (all-false "
        f"blend = K1), flags exact, {int((~sat).sum())} of {sat.numel()} flags violated")
    for name, r in out.items():
        log(f"  K10 {label} {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']}), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.6f} ms")
    log_index_build(log, label, out["blend_aggregates"])
    log(f"  K10 {label} topic tables: device {out['blend_aggregates']['topic_device_ms']} ms "
        f"of the aggregates' {out['blend_aggregates']['device_ms']} ms (written once, no "
        f"zeroing)")
    return out


def log_index_build(log, label, r):
    """The row-index build's event and device ms beside its kernel's, and
    whether the two together stay under the ``index_add_`` call."""
    both = None if r["device_ms"] is None or r["index_device_ms"] is None else \
        r["device_ms"] + r["index_device_ms"]
    log(f"  K10 {label} index build: event {r['index_ms']:.4f} ms, device "
        f"{r['index_device_ms']}, bound {r['index_bound_ms']:.6f} ms, torch.sort of its "
        f"keys {r['index_library_ms']:.4f} ms; kernel and index build on the device {both} "
        f"ms against index_add_ {r['library_ms']:.4f} ms: below "
        f"{None if both is None else both < r['library_ms']}")


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


def profile_mid(torch, run, wall, steps, label, log, names=None):
    """One more run of ``run`` under ``torch.profiler``: device ops per step,
    the device's busy share of the unprofiled ``wall``, the device ops that
    take the most time, and each port kernel's device time per launch (of
    ``names``, by default ``PROFILE_NAMES``)."""
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
    per_launch, totals = {}, {}
    for wrapper, kernels in (names or PROFILE_NAMES).items():
        hits = {k: [(n, t) for name, (n, t) in by_name.items() if k in name]
                for k in kernels}
        launches = sum(n for n, _ in hits[kernels[0]])
        total = sum(t for h in hits.values() for _, t in h)
        per_launch[wrapper] = total / launches if launches else None
        totals[wrapper] = total
        log(f"  {label} {wrapper}: device ms per launch {per_launch[wrapper]} ({launches} "
            f"launches, {total:.3f} ms)")
    # Each K1 or segment_sum call builds one row index: its walk's time a
    # launch plus the index build's (averaged over both walks' shapes).
    index_ms = per_launch.get("segment_row_index")
    for wrapper in ("broker_aggregates", "segment_sum"):
        if per_launch.get(wrapper) is not None and index_ms is not None:
            per_launch[wrapper] += index_ms
            log(f"  {label} {wrapper}: device ms per launch with its row index "
                f"{per_launch[wrapper]}")
    return {"per_launch": per_launch, "totals": totals, "ops": len(kernels),
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


def drive_per_goal(opt, model, goals, options, cache, kw, constraint=None):
    """``optimize(fused=True, **kw)``'s sequential per-goal driver at the
    defaults the runs use (default widths, step budget and chunk lengths),
    without the before/after statistics: with ``cache`` the goals' step
    graphs replay, with None the same gated steps run eagerly.  ``constraint``:
    the default when None."""
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
            model, options, specs, constraint or BalancingConstraint.default(),
            cgen.default_num_sources(model), cgen.default_num_dests(model), max_steps,
            32 if b >= 500 else None, b > opt._FRONTIER_DENSE_MIN, False,
            lambda *a: 0, cache)
    return types.SimpleNamespace(model=final, goal_results=results)


def drive_pipelined(opt, model, goals, options, cache, constraint=None):
    """``optimize(fused=True)``'s pipelined driver at the defaults the runs
    use above the dense floor (default widths, step budget and chunk
    lengths, auto-fusion as the environment says), without the before/after
    statistics: with ``cache`` the goals' step graphs replay, with None the
    same gated steps run eagerly.  ``constraint``: the default when None."""
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
            model, options, specs, constraint or BalancingConstraint.default(),
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


# The bytes a gated-off replay moves: its gate reads three counters
# (csrc/step_graph.cu; the executed count moves only when the step runs).
GATE_BYTES = 3 * 4


def gated_off_replay(torch, graphs, model, goal, log, label, strict=True, profiled=True):
    """K8 gated off: the cached dense, recorder-off step graph of ``goal``
    at ``model``'s shape, its counters set to last_n = 0 (converged).  A
    replay leaves the state (placement, counters) unchanged; its event ms
    (median of TIMED_RUNS single replays); the device ops a profiled replay
    runs (of 10), their names and device ms a replay; and, where the graph
    keeps the body torch captured, that body replayed without its gate (the
    step graph before its conditional node: every kernel of the step).
    With ``strict`` a changed state raises, and so does a profile that runs
    more than the gate kernel or that records no device op in any of its
    sessions: an empty profile shows nothing.  Without ``profiled`` only the
    state and the event ms (and the counter read).  The counters are
    restored after."""
    from torch.profiler import ProfilerActivity, profile
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N, CTR_STEPS,
                                                         OptimizationOptions)
    cache = graphs.GRAPHS
    shape = cache.shape_key(model, OptimizationOptions.none(model))
    found = [(k, g) for k, g in cache._graphs.items()
             if k[-1] == shape and k[0].name == goal and k[5] is None and not k[6]]
    if not found:
        raise RuntimeError(f"{label}: no cached dense step graph of {goal}")
    key, g = found[0]
    st = cache._states[shape]
    with cache.lock:
        saved = st.counters.clone()
        st.counters[CTR_LAST_N] = 0
        before = [getattr(st.model, f).clone() for f in PLACEMENT] + [st.counters.clone()]
        g.replay(3)
        torch.cuda.synchronize()
        after = [getattr(st.model, f).clone() for f in PLACEMENT] + [st.counters.clone()]
        unchanged = all(torch.equal(a, b) for a, b in zip(before, after))
        ms = time_ms(torch, lambda: g.replay(1))
        n_prof, ops = 10, []
        for _ in range(5 if profiled else 0):  # a session now and then records no op
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                g.replay(n_prof)
                torch.cuda.synchronize()
            ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
            if ops:
                break
        body = getattr(g, "body", None) if profiled else None
        body_ms = time_ms(torch, body.replay) if body is not None else None
        # One counter read of the per-goal driver's sub-chunks (``_run_rest``)
        # on an idle stream: host ms, median of TIMED_RUNS.
        reads = []
        for _ in range(TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st.counters[[CTR_STEPS, CTR_LAST_N, CTR_BUDGET]].tolist()
            reads.append((time.perf_counter() - t0) * 1e3)
        st.counters.copy_(saved)
    names = sorted({e.name[:60] for e in ops})
    out = dict(goal=goal, unchanged=unchanged, ms=ms,
               device_ms=(sum(e.time_range.elapsed_us() for e in ops) / 1e3 / n_prof
                          if ops else None),
               device_ops=len(ops) / n_prof if ops else None, op_names=names,
               body_replay_ms=body_ms, counter_read_ms=statistics.median(reads))
    log(f"K8 gated-off replay at {label} ({goal}): state unchanged {unchanged}; "
        f"{ms:.4f} ms event, device {out['device_ms']} ms, {out['device_ops']} device "
        f"ops a replay {names}; its body replayed without the gate {body_ms} ms; one "
        f"counter read {out['counter_read_ms']:.4f} ms host")
    if strict and not unchanged:
        raise RuntimeError(f"{label}: a gated-off replay changed the state")
    if strict and profiled and not ops:
        raise RuntimeError(f"{label}: no profiler session recorded the gated-off replays")
    if strict and any("step_gate_kernel" not in e.name for e in ops):
        raise RuntimeError(f"{label}: a gated-off replay ran more than its gate: {names}")
    return out


def band_goal_graphed(graphs, model):
    """The first distribution goal of STACK with a dense, recorder-off step
    graph cached at ``model``'s shape."""
    from cruise_control_tpu_torch.analyzer.state import OptimizationOptions
    shape = graphs.GRAPHS.shape_key(model, OptimizationOptions.none(model))
    dense = {k[0].name for k in graphs.GRAPHS._graphs
             if k[-1] == shape and k[5] is None and not k[6]}
    for goal in STACK:
        if "Distribution" in goal and goal in dense:
            return goal
    raise RuntimeError(f"no dense step graph of a distribution goal at {shape[1][:1]}")


def check_graphs(torch, opt, graphs, dev, mid, run_fused, chain_wall, eager_wall,
                 replays, time_ms, log, rehearse):
    """K8: one replay of a cached step graph against the same gated step run
    eagerly on a copy of the same state (placement and counters equal, the
    body's launches credited once, as the eager step launches them), and
    gated off: no launch credited, the state unchanged, timed (event ms
    against the eager gated-off step, which runs every kernel), the device
    ops a profiled replay runs (the gate kernel alone) and its device ms,
    and the body replayed without its gate beside it.  K12: the fused mid
    driver with its step graphs (``chain_wall``) against the same driver
    with eager gated steps (``eager_wall``).  Bounds: a gated-off replay's,
    the gate's bytes; an executed step's, the bytes a step must move (read
    the model's replica and broker rows once, write the new placement) over
    the memory rate; the chain's, that times its executed steps."""
    from cruise_control_tpu_torch.analyzer.goals.specs import goals_by_priority
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N,
                                                         BrokerArrays, OptimizationOptions,
                                                         StepState)
    from cruise_control_tpu_torch.analyzer import candidates as cgen
    from cruise_control_tpu_torch.ops import cuda
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
    counts = {}
    for label, state in (("graph", st), ("eager", eager)):
        cuda.reset_launch_counts()
        if label == "graph" and cache is not None:
            g.replay(1)
        else:
            step(state)
        torch.cuda.synchronize()
        counts[label] = {n: c for n, c in cuda.launch_counts().items() if c}
    same = all(torch.equal(getattr(st.model, f), getattr(eager.model, f)) for f in PLACEMENT)
    same = same and torch.equal(st.counters, eager.counters)
    log(f"K8 step graph ({spec.name}): one replay equals the eager gated step: {same}; "
        f"launches credited equal the eager step's: {counts['graph'] == counts['eager']}")
    if not same:
        raise RuntimeError("a replayed step graph disagrees with the eager gated step")
    if not rehearse and counts["graph"] != counts["eager"]:
        raise RuntimeError(f"a replay credited {counts['graph']}, the eager step launched "
                           f"{counts['eager']}")
    # An executed step timed from the same entry state each time (its three
    # placement fields and the counters copied back first, in both).
    for state in (st, eager):
        state.counters.zero_()
        state.counters[CTR_LAST_N] = 1
        state.counters[CTR_BUDGET] = 256
    entry = [getattr(eager.model, f).clone() for f in PLACEMENT] + [eager.counters.clone()]

    def from_entry(state, run):
        def fn():
            for f, src in zip(PLACEMENT, entry):
                getattr(state.model, f).copy_(src)
            state.counters.copy_(entry[-1])
            run()
        return fn
    executed_ms = time_ms(torch, from_entry(st, (lambda: g.replay(1)) if cache is not None
                                            else (lambda: step(st))))
    plain_executed_ms = time_ms(torch, from_entry(eager, lambda: step(eager)))
    for state in (st, eager):
        state.counters[CTR_LAST_N] = 0
    cuda.reset_launch_counts()
    if cache is not None:
        g.replay(5)
    credited = {n: c for n, c in cuda.launch_counts().items() if c}
    log(f"K8 five gated-off replays: launches credited {credited}")
    if credited:
        raise RuntimeError(f"gated-off replays credited launches: {credited}")
    off = (gated_off_replay(torch, graphs, mid, spec.name, log, "mid") if cache is not None
           else dict(ms=time_ms(torch, lambda: step(st)), device_ms=None, device_ops=None,
                     body_replay_ms=None))
    plain_step_ms = time_ms(torch, lambda: step(eager))
    R, B = mid.num_replicas_padded, mid.num_brokers
    step_bytes = R * (4 + 4 + 4 + 1 + 32 + 1 + 4 + 1 + 4) + B * 60 + R * 9
    steps = sum(r.steps for r in run_fused.goal_results)
    out = {
        "step_graph": dict(launches=replays, max_abs_err=0.0, ms=off["ms"],
                           device_ms_per_launch=off["device_ms"],
                           device_ops_gated_off=off["device_ops"],
                           body_replay_ms=off["body_replay_ms"],
                           ms_executed=executed_ms, plain_ms_executed=plain_executed_ms,
                           bound_ms_executed=bound_ms(step_bytes),
                           plain_ms=plain_step_ms, bound_ms=bound_ms(GATE_BYTES)),
        "goal_chain": dict(launches=1, max_abs_err=0.0, ms=chain_wall * 1e3,
                           plain_ms=eager_wall * 1e3,
                           bound_ms=bound_ms(step_bytes * max(steps, 1))),
    }
    log(f"K8 gated-off replay {off['ms']:.4f} ms (device {off['device_ms']} ms, "
        f"{off['device_ops']} device ops) vs eager gated-off step {plain_step_ms:.4f} ms and "
        f"the body without its gate {off['body_replay_ms']} ms; executed replay "
        f"{executed_ms:.4f} ms vs eager {plain_executed_ms:.4f} ms; K12 fused mid driver "
        f"{chain_wall:.3f} s with graphs vs {eager_wall:.3f} s eager")
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


def enqueue_ms(torch, fn, runs: int = 100) -> float:
    """Host ms a call of ``fn`` issued back to back without a sync: the
    wrapper's Python and the launches' host cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / runs
    torch.cuda.synchronize()
    return host


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


# ---------------------------------------------------------------------------
# K1 and segment_sum over the hand-built row index, at each rung's shapes
# ---------------------------------------------------------------------------

GRAPH_CALLS = 20   # calls captured in one graph for the many-launch timings
GRAPH_REPLAYS = 10


def graph_ms(torch, fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two events, over the count.
    Many launches between two events, as inside the step graphs where K1 and
    ``segment_sum`` run: the host's Python and ctypes time stays out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _index_bytes(mask, S):
    """Bytes the row index must move: each row's flag and each kept row's
    id read, the offsets and the rows written."""
    n = mask.numel()
    return n + int(mask.sum()) * 4 + (S + 1 + n) * 4


def _segsum_bytes(values, mask, S):
    """Bytes ``segment_sum``'s function must move: each row's flag, a kept
    row's id and values read, the sums written (the rule of ``_k1_bytes``
    and ``check_kernels``)."""
    c = values.shape[1]
    return mask.numel() + int(mask.sum()) * (4 + 4 * c) + S * 4 * c


GUARD_WORDS = 4096  # canary words around each buffer of a guarded launch
CANARY = 0x7FA5A5A5


def canary_views(torch, dev, sizes):
    """(buffer, guard mask, views): int32 views of ``sizes`` words, each
    between bands of ``GUARD_WORDS`` canary words of one buffer."""
    buf = torch.full((sum(sizes) + GUARD_WORDS * (len(sizes) + 1),), CANARY,
                     dtype=torch.int32, device=dev)
    guard = torch.ones_like(buf, dtype=torch.bool)
    views, at = [], GUARD_WORDS
    for size in sizes:
        views.append(buf[at:at + size])
        guard[at:at + size] = False
        at += size + GUARD_WORDS
    return buf, guard, views


def guarded_writes(torch, sg, cuda, name, args):
    """One launch of ``name``'s row index and walk through their C entries
    into buffers that each lie between bands of ``GUARD_WORDS`` canary
    words (the index's offsets, rows and scratch, the walk's outputs).
    Raises if a band changed or the outputs differ from the wrapper's: the
    kernels' writes stay inside what they were given."""
    dev = args[0].device
    if name == "segment_row_index":
        seg, mask, S = args
    elif name == "broker_aggregates":
        seg, mask, lead, ll, lf, S = args
    else:
        values, seg, mask, S = args[:4]
    n = seg.shape[0]
    warps, warp_rows, blocks = sg.index_tiling(n, S)
    sizes = [S + 1, n, S * blocks + S]
    if name == "broker_aggregates":
        sizes += [4 * S, S, S, S, S]
    elif name != "segment_row_index":
        sizes += [S * values.shape[1]]
    buf, guard, views = canary_views(torch, dev, sizes)
    offsets, rows, scratch = views[:3]
    f32 = [v.view(torch.float32) for v in views[3:]]
    cuda.launch("segment_row_index", seg, mask, None, n, S, warps, warp_rows, offsets, rows,
                scratch)
    if name == "broker_aggregates":
        cuda.launch("broker_aggregates", offsets, rows, lead, ll, lf, f32[0], views[4],
                    views[5], f32[3], f32[4], S)
        got = (f32[0].view(S, 4), views[4], views[5], f32[3], f32[4])
    elif name == "segment_sum":
        cuda.launch("segment_sum", values, offsets, rows, values.shape[1], S, f32[0])
        got = f32[0].view(S, values.shape[1])
    else:
        got = (offsets, rows)
    torch.cuda.synchronize()
    if not bool((buf[guard] == CANARY).all()):
        raise RuntimeError(f"{name}: a launch wrote outside its buffers")
    wrapper = {"segment_row_index": sg.segment_row_index,
               "broker_aggregates": sg.broker_aggregates,
               "segment_sum": sg.segment_sum}[name]
    if not _exact(torch, got, wrapper(*args)):
        raise RuntimeError(f"{name}: the guarded launch differs from the wrapper's")


def family_inputs(torch, np, k1_args, round_args, seed):
    """The inputs of K1, each ``segment_sum`` mode and the row index at one
    rung's shapes: K1's and the round sums' as the rung's solve gave them;
    the disk modes at the JBOD rungs' shapes built from K1's rows (4 disks a
    broker, replica r on disk r mod 4 of its broker, its DISK load; the
    disks' per-broker sums over 4 B seeded loads with a twentieth of the
    disks masked); the index over K1's brokers."""
    rb, valid, lead, ll, lf, B = k1_args
    dev = rb.device
    gen = np.random.default_rng(seed)
    r = torch.arange(rb.shape[0], dtype=torch.int32, device=dev)
    disk = torch.where(lead[:, None], ll, lf)[:, 3:4].contiguous()
    disk_ids = (rb * 4 + r % 4).to(torch.int32)
    D = 4 * B
    per_disk = torch.from_numpy(gen.exponential(100.0, (D, 1)).astype(np.float32)).to(dev)
    disk_broker = torch.arange(D, dtype=torch.int32, device=dev) // 4
    alive = torch.from_numpy(gen.random(D) >= 0.05).to(dev)
    return {"broker_aggregates": tuple(k1_args),
            "segment_sum": tuple(round_args[:4]) + ("round",),
            "segment_sum[disk]": (disk, disk_ids, valid, D, "disk"),
            "segment_sum[disk_broker]": (per_disk, disk_broker, alive, B, "disk_broker"),
            "segment_row_index": (rb, valid, B)}


def family_cases(torch, np, seg, mask, S, seed):
    """(case, segment ids, mask): the rung's own inputs; a fifth of the kept
    rows moved to segment 0; every row masked; segment 1 emptied into
    segment 2 (0 when S <= 2); a twentieth of the ids past S and another
    twentieth at -1, their rows unmasked."""
    u = torch.from_numpy(np.random.default_rng(seed).random(seg.shape[0])).to(seg.device)
    i32 = torch.int32
    return [("main path", seg, mask),
            ("skewed", torch.where(mask & (u < 0.2), 0, seg).to(i32), mask),
            ("all masked", seg, torch.zeros_like(mask)),
            ("empty segment", torch.where(seg == 1, 2 if S > 2 else 0, seg).to(i32), mask),
            ("out of range", torch.where(u < 0.05, S + 3, torch.where(u < 0.1, -1, seg)).to(i32),
             mask)]


def check_family(torch, np, log, timer, label, k1_args, round_args, rehearse):
    """K1, ``segment_sum`` in its three modes and the row index at one
    rung's shapes (``family_inputs``): each bit for bit against its plain
    twin on CPU copies in every case of ``family_cases``, identical over two
    launches and, on the rung's own inputs, after a graph replay; timed as
    one call between two events (``ms``) and as many launches in a replayed
    graph (``graph_ms``: the device time a call takes inside the step
    graphs), beside ``index_add_`` (``library_graph_ms``; the index: a
    stable ``torch.sort`` of its keys) timed the same way, and the skewed
    case (``skewed_graph_ms``); on the card every case also through
    ``guarded_writes``.  Returns {kernel: {metric_<label>: value}}."""
    from cruise_control_tpu_torch.ops import cuda
    from cruise_control_tpu_torch.ops import segment as sg

    def plain_sum(values, ids, mask, n, _segments):
        return sg.masked_segment_sum(values, ids, n, mask)

    def cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)

    # kernel, plain twin, positions of (ids, mask, S) in its arguments
    calls = {"broker_aggregates": (sg.broker_aggregates, sg.broker_aggregates_plain, (0, 1, 5)),
             "segment_sum": (sg.segment_sum, plain_sum, (1, 2, 3)),
             "segment_row_index": (sg.segment_row_index, sg.segment_row_index_plain, (0, 1, 2))}
    out = {}
    for name, args in family_inputs(torch, np, k1_args, round_args, SEED).items():
        base = name.split("[")[0]
        kernel, plain, (si, mi, ni) = calls[base]
        S = args[ni]
        longest, skewed = {}, None
        for case, seg, mask in family_cases(torch, np, args[si], args[mi], S, SEED):
            a = list(args)
            a[si], a[mi] = seg, mask
            a = tuple(a)
            if case == "skewed":
                skewed = a
            got, again = kernel(*a), kernel(*a)
            if not rehearse:
                guarded_writes(torch, sg, cuda, base, a)
            if not _exact(torch, got, again):
                raise RuntimeError(f"{name} at {label} ({case}) differs between two launches")
            if not _exact(torch, got, plain(*cpu(a))):
                raise RuntimeError(f"{name} at {label} ({case}) differs from its plain twin "
                                   "on the CPU")
            o = sg.segment_row_index_plain(*cpu((seg, mask, S)))[0]
            longest[case] = int((o[1:] - o[:-1]).max())
        fn = lambda: kernel(*args)  # noqa: E731
        if not rehearse and not _graph_replay_equal(torch, fn):
            raise RuntimeError(f"{name} at {label}: a graph replay differs from the eager "
                               "launch")
        seg, mask = args[si], args[mi]
        if base == "segment_row_index":
            keys = torch.where(mask & (seg >= 0) & (seg < S), seg, S)
            library = lambda: torch.sort(keys, stable=True)  # noqa: E731
            nbytes = _index_bytes(mask, S)
            shape = dict(N=seg.shape[0], S=S)
        else:
            if base == "broker_aggregates":
                rb, valid, lead, ll, lf, _ = args
                values = torch.cat([torch.where(lead[:, None], ll, lf), ll[:, 2:3],
                                    torch.where(lead, ll[:, 1], 0.0)[:, None],
                                    torch.ones_like(ll[:, :1]), lead[:, None].float()], 1)
                nbytes = _k1_bytes(valid, lead, S)
                shape = dict(R=seg.shape[0], B=S)
            else:
                values = args[0]
                nbytes = _segsum_bytes(values, mask, S)
                shape = dict(N=seg.shape[0], C=values.shape[1], S=S)
            rows_v = torch.where(mask[:, None], values, 0.0)
            ids = torch.where(mask, seg, 0).long()
            acc = torch.zeros((S, values.shape[1]), device=values.device)
            library = lambda: acc.zero_().index_add_(0, ids, rows_v)  # noqa: E731
        r = {"shape": shape, "ms": timer(torch, fn), "bound_ms": bound_ms(nbytes),
             "longest_segment": longest["main path"],
             "longest_segment_skewed": longest["skewed"]}
        if rehearse:
            r.update(graph_ms=None, library_graph_ms=None, skewed_graph_ms=None)
        else:
            r.update(graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, library),
                     skewed_graph_ms=graph_ms(torch, lambda: kernel(*skewed)))
        out[name] = {f"{k}_{label}": v for k, v in r.items()}
        log(f"{name} at {label} {shape}: bit for bit with its plain twin on the CPU in "
            f"{len(longest)} cases (longest segment {longest}), identical over two "
            f"launches{'' if rehearse else ' and a graph replay'}; graph {r['graph_ms']} ms "
            f"a call (skewed {r['skewed_graph_ms']}), one call {r['ms']:.4f} ms; "
            f"{'torch.sort' if base == 'segment_row_index' else 'index_add_'}"
            f" {r['library_graph_ms']} ms; bound {r['bound_ms']:.6f} ms")
    return out


# ---------------------------------------------------------------------------
# K3 and the ordered sum on every case, into canary-guarded buffers
# ---------------------------------------------------------------------------

K3_EDGES = (16, 17, 256, 257, 4096, 4097, 65537)  # the running totals' level edges
K3_CASES = ("ties", "one segment", "empty segments", "none kept", "out of band first")
# Segment counts on both sides of K3's grouping choice (the counting pass
# up to gk.COUNTING_MAX_SEGMENTS, a second sort above) and far above it.
K3_GROUPING_SEGMENTS = (4096, 4097, 40000)


def k3_fixture(torch, np, dev, k, s, c, seed, case="mixed", segments="broker"):
    """K3's arguments (score, seg, deltas, kept, cum_before, lo, hi, S,
    segments) of one seeded case on ``dev``: integer scores (ties, +0 and
    -0, a few +inf), non-dyadic deltas (normal draws over four decades, so
    the rounding order of the running totals matters), and a share of the
    channels bounded at the highest or lowest float64 running total of
    their segment up to a random position, exactly or a little inside it.
    ``case``: three scores only ("ties"), every row on segment 0 ("one
    segment"), odd segments empty, no kept row, or a third of the segments
    out of band before their first position ("out of band first")."""
    rng = np.random.default_rng(seed)
    score = rng.integers(-6, 7, k).astype(np.float32)
    score[(score == 0) & (rng.random(k) < 0.5)] = -0.0
    score[rng.random(k) < 0.02] = np.inf
    if case == "ties":
        score = rng.choice(np.array([1.0, 0.0, -0.0], np.float32), k)
    seg = rng.integers(0, s, k)
    if case == "one segment":
        seg[:] = 0
    elif case == "empty segments":
        seg = 2 * rng.integers(0, (s + 1) // 2, k)
    seg = seg.astype(np.int32)
    deltas = (rng.normal(0.0, 1.0, (k, c)) * 10.0 ** rng.integers(-2, 2, (k, c))).astype(
        np.float32)
    kept = rng.random(k) < 0.8
    if case == "none kept":
        kept[:] = False
    cum = rng.normal(0.0, 1.0, (s, c)).astype(np.float32)
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    o = np.lexsort((-score + np.float32(0.0), seg))        # the JAX order
    cs = np.cumsum(np.where(kept[o][:, None], deltas[o], 0.0), axis=0)
    so = seg[o]
    starts = np.searchsorted(so, np.arange(s))
    ends = np.searchsorted(so, np.arange(s), side="right")
    base = np.where((starts > 0)[:, None], cs[np.maximum(starts - 1, 0)], 0.0)
    run = np.vstack([cum[so] + cs - base[so], np.zeros((1, c))])
    g = np.nonzero(starts < ends)[0]
    at = starts[g] + (rng.random(g.size) * (ends[g] - starts[g])).astype(np.int64)
    cuts = np.empty(2 * g.size, np.int64)
    cuts[0::2], cuts[1::2] = starts[g], at + 1
    top = np.maximum.reduceat(run, cuts, axis=0)[0::2]     # highest total up to at
    bottom = np.minimum.reduceat(run, cuts, axis=0)[0::2]
    u = rng.random((g.size, c))
    hi[g] = np.where(u < 0.3, top - (u < 0.15) * 1e-3 * np.abs(top), hi[g])
    lo[g] = np.where((u >= 0.3) & (u < 0.6), bottom + (u < 0.45) * 1e-3 * np.abs(bottom),
                     lo[g])
    wide = (u >= 0.6) & (u < 0.8)
    hi[g] = np.where(wide, np.abs(run[:-1]).max() + 1.0, hi[g])
    lo[g] = np.where(wide, -np.abs(run[:-1]).max() - 1.0, lo[g])
    if case == "out of band first":
        cum[rng.random(s) < 0.33] = 1e4
        hi[:, 0] = np.where(np.isinf(hi[:, 0]), 1e3, hi[:, 0])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(score), t(seg), t(deltas), t(kept), t(cum), t(lo), t(hi), s, segments)


def k3_cases(torch, np, dev):
    """(label, K3 arguments) of every seeded K3 case: the level edges at the
    main path's 8 channels, the cases of ``K3_CASES`` at 4,097 positions, a
    topic cut's shape (7,000 positions, 2 channels, 2,000 segments) and the
    segment counts of ``K3_GROUPING_SEGMENTS`` at 65,537 positions."""
    cases = [(f"K={k}", k3_fixture(torch, np, dev, k, max(3, k // 48), 8, k + 2))
             for k in K3_EDGES]
    cases += [(case, k3_fixture(torch, np, dev, 4097, 64, 8, 7, case)) for case in K3_CASES]
    cases.append(("topic shape", k3_fixture(torch, np, dev, 7000, 2000, 2, 11,
                                            segments="topic")))
    cases += [(f"S={s}", k3_fixture(torch, np, dev, 65537, s, 2, 13 + s))
              for s in K3_GROUPING_SEGMENTS]
    return cases


def k3_safe_args(torch, args):
    """The arguments ``prefix_admit_safe`` hands K3: the split channels."""
    score, seg, deltas, kept, cum, lo, hi, S = args[:8]
    inf = torch.full_like(hi, float("inf"))
    return (score, seg, torch.cat([deltas.clamp(min=0.0), deltas.clamp(max=0.0)], 1).contiguous(),
            kept, torch.cat([cum, cum], 1).contiguous(), torch.cat([-inf, lo], 1).contiguous(),
            torch.cat([hi, inf], 1).contiguous(), S)


def guarded_k3(torch, gk, args):
    """K3's launches (``prefix_cut_launch``) into scratch and an output that
    each lie between canary bands; raises if a band changed or the output
    differs from the wrapper's."""
    score, seg, deltas, kept, cum, lo, hi, S = args[:8]
    K, C = deltas.shape
    sizes = gk.prefix_cut_scratch(K, S, C) + [-(-K // 4)]
    buf, guard, views = canary_views(torch, score.device, sizes)
    out = views[-1].view(torch.uint8)[:K].view(torch.bool)
    gk.prefix_cut_launch(score, seg, deltas, kept, cum, lo, hi, S, views[:-1], out)
    torch.cuda.synchronize()
    if not bool((buf[guard] == CANARY).all()):
        raise RuntimeError("K3: a launch wrote outside its buffers")
    if not torch.equal(out, gk.prefix_cut_admit(*args[:8])):
        raise RuntimeError("K3: the guarded launch differs from the wrapper's")


def _graph_replay_equal(torch, fn):
    """Whether one replay of a graph capturing ``fn()`` gives its eager result."""
    eager = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn()
    graph.replay()
    torch.cuda.synchronize()
    return _exact(torch, static, eager)


def check_k3(torch, np, log, timer, inputs, rehearse):
    """K3 through ``prefix_cut_admit`` and ``prefix_admit_safe`` on every
    case of ``k3_cases`` and on the inputs the mid, large and xl250 warm-ups
    and the goal kinds' first topic cut gave it (``inputs``): bit for bit
    against ``prefix_cut_admit_plain`` on the card (the safe entry: on its
    split channels) and against the entry point on CPU copies, identical
    over two launches and a graph replay, and launched into canary-guarded
    buffers (``guarded_k3``).  On the run inputs, timed as one call
    (``ms``) and as many calls in a replayed graph (``graph_ms``), beside
    one stable ``torch.sort`` of the order's composite key (segment, then
    the score's total-order key descending) timed the same way.  Returns
    {kernel: {metric_<label>: value}}."""
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.ops import order

    def cpu(args):
        return tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)

    dev = next(iter(inputs.values()))[0].device
    cases = list(inputs.items()) + k3_cases(torch, np, dev)
    admitted = {}
    for label, a in cases:
        for entry in ("prefix_cut_admit", "prefix_admit_safe"):
            if entry == "prefix_admit_safe" and 2 * a[2].shape[1] > 16:
                continue
            fn = getattr(gk, entry)
            plain_args = a[:8] if entry == "prefix_cut_admit" else k3_safe_args(torch, a)
            got, again = fn(*a), fn(*a)
            if not torch.equal(got, again):
                raise RuntimeError(f"K3 {entry} ({label}) differs between two launches")
            if not torch.equal(got, gk.prefix_cut_admit_plain(*plain_args)):
                raise RuntimeError(f"K3 {entry} ({label}) differs from the plain twin at "
                                   f"{int((got != gk.prefix_cut_admit_plain(*plain_args)).sum())}"
                                   " positions")
            if not torch.equal(got.cpu(), fn(*cpu(a))):
                raise RuntimeError(f"K3 {entry} ({label}) differs from the CPU")
            if not rehearse:
                if not _graph_replay_equal(torch, lambda: fn(*a)):
                    raise RuntimeError(f"K3 {entry} ({label}): a graph replay differs")
                guarded_k3(torch, gk, plain_args)
            admitted[f"{label} {entry}"] = (int(got.sum()), int(a[3].sum()))
    log(f"K3: {len(admitted)} (case, entry) pairs bit for bit against the plain twin on the "
        f"card and on the CPU, identical over two launches"
        f"{'' if rehearse else ', a graph replay and into canary-guarded buffers'}; "
        f"admitted / kept {admitted}")
    out = {}
    for label, a in inputs.items():
        score, seg, deltas, kept, cum, lo, hi, S = a[:8]
        K, C = deltas.shape
        key = order._total_order_key(-score + 0.0).to(torch.int64) + 2 ** 31
        composite = (seg.to(torch.int64) << 32) | key
        fn = lambda: gk.prefix_cut_admit(*a)  # noqa: E731, B023
        library = lambda: torch.sort(composite, stable=True)  # noqa: E731, B023
        r = {"shape": dict(K=K, C=C, S=S), "ms": timer(torch, fn),
             "library_ms": timer(torch, library),
             "bound_ms": bound_ms(K * 10 + int(kept.sum()) * 4 * C + S * 12 * C),
             "host_ms": enqueue_ms(torch, fn),
             "sort_host_ms": enqueue_ms(torch, lambda: order.argsort(-score))}  # noqa: B023
        if rehearse:
            r.update(graph_ms=None, library_graph_ms=None)
        else:
            r.update(graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, library))
        name = "prefix_cut[topic]" if label == "topic" else "prefix_cut"
        out.setdefault(name, {}).update({f"{k}_{label}": v for k, v in r.items()})
        log(f"K3 at {label} {r['shape']}: one call {r['ms']:.4f} ms (host {r['host_ms']:.4f} "
            f"ms, its score sort's {r['sort_host_ms']:.4f}), graph {r['graph_ms']} ms a call; "
            f"torch.sort of the composite key {r['library_ms']:.4f} ms, graph "
            f"{r['library_graph_ms']} ms; bound {r['bound_ms']:.6f} ms")
    return out


ORDERED_SUM_SHAPES = [(b, c) for b in (50, 200, 1000) for c in (1, 4)]


def ordered_sum_fixtures(torch, np, dev, x_cap):
    """The captured input of the band averages' ordered sum, and seeded
    vectors and [n, 4] tables around the window edges (magnitudes over
    eight decades, both signs)."""
    rng = np.random.default_rng(SEED)
    fixtures = [x_cap]
    for n in (1, 31, 32, 33, 200, 1000, 1025, 16384):
        for shape in ((n,), (n, 4)):
            mag = rng.exponential(1.0, shape) * 10.0 ** rng.integers(-3, 5, shape)
            fixtures.append(torch.from_numpy(
                (mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32)).to(dev))
    return fixtures


def check_ordered_sum(torch, np, log, timer, x_cap, rehearse):
    """The ordered sum on every fixture of ``ordered_sum_fixtures``: bit for
    bit against its plain twin on the card and on a CPU copy, identical over
    two launches and a graph replay, and launched into an output between
    canary bands; then at the band averages' shapes (``ORDERED_SUM_SHAPES``:
    B brokers, one column or four) timed as one call and as many calls in a
    replayed graph beside ``torch.sum(x, dim=0)`` timed the same way.
    Returns {"ordered_sum": {metric_B<b>x<c>: value}}."""
    from cruise_control_tpu_torch.ops import cuda, order
    dev = x_cap.device
    fixtures = ordered_sum_fixtures(torch, np, dev, x_cap)
    for x in fixtures:
        got, again = order.ordered_sum(x), order.ordered_sum(x)
        if not (_exact(torch, got, again) and _exact(torch, got, order.ordered_sum_plain(x))
                and _exact(torch, got, order.ordered_sum_plain(x.cpu()))):
            raise RuntimeError(f"ordered_sum on {tuple(x.shape)} differs from its plain twin "
                               "or between two launches")
        if not rehearse:
            if not _graph_replay_equal(torch, lambda: order.ordered_sum(x)):  # noqa: B023
                raise RuntimeError(f"ordered_sum on {tuple(x.shape)}: a graph replay differs")
            c = max(got.numel(), 1)
            buf, guard, (out,) = canary_views(torch, dev, [c])
            cuda.launch("ordered_sum", x.contiguous(), out, x.shape[0], c)
            torch.cuda.synchronize()
            if not bool((buf[guard] == CANARY).all()):
                raise RuntimeError("ordered_sum: a launch wrote outside its output")
            if not _exact(torch, out.view(torch.float32).view(got.shape), got):
                raise RuntimeError("ordered_sum: the guarded launch differs from the wrapper's")
    rng = np.random.default_rng(SEED + 1)
    out = {}
    for b, c in ORDERED_SUM_SHAPES:
        shape = (b,) if c == 1 else (b, c)
        x = torch.from_numpy(rng.exponential(100.0, shape).astype(np.float32)).to(dev)
        fn = lambda: order.ordered_sum(x)  # noqa: E731, B023
        library = lambda: torch.sum(x, dim=0)  # noqa: E731, B023
        r = {"ms": timer(torch, fn), "library_ms": timer(torch, library),
             "bound_ms": bound_ms(b * c * 4 + c * 4), "host_ms": enqueue_ms(torch, fn),
             "library_host_ms": enqueue_ms(torch, library)}
        if rehearse:
            r.update(graph_ms=None, library_graph_ms=None)
        else:
            r.update(graph_ms=graph_ms(torch, fn), library_graph_ms=graph_ms(torch, library))
        out.update({f"{k}_B{b}x{c}": v for k, v in r.items()})
        log(f"ordered_sum at B={b} x {c}: one call {r['ms']:.4f} ms (torch.sum "
            f"{r['library_ms']:.4f}; host {r['host_ms']:.4f} and {r['library_host_ms']:.4f}), "
            f"graph {r['graph_ms']} ms a call (torch.sum {r['library_graph_ms']}); bound "
            f"{r['bound_ms']:.8f} ms")
    log(f"ordered_sum: {len(fixtures)} inputs bit for bit against the plain twin on the card "
        f"and on the CPU, identical over two launches"
        f"{'' if rehearse else ', a graph replay and into a canary-guarded output'}")
    return {"ordered_sum": out}


# ---------------------------------------------------------------------------
# K9's sweep, frontier mask and batch at each rung's shapes (phase 21)
# ---------------------------------------------------------------------------

K9_KERNELS = ("stack_sweep", "frontier_active", "frontier_active_batch")
K9_BAND_GOAL = "ReplicaDistributionGoal"  # the frontier row timed at each shape
# The sweep's goals for the seeded cases: the stack and the replica- and
# topic-axis kinds beyond it.
K9_SWEEP_GOALS = STACK + ["RackAwareDistributionGoal", "PreferredLeaderElectionGoal",
                          "MinTopicLeadersPerBrokerGoal"]
# Seeded frontier rows: sizes on both sorts' edges and every count of slots
# a thread (1, 2, 4, 8); the cases beyond "mixed" at three of them.
K9_FRONTIER_SIZES = (1, 17, 33, 200, 256, 257, 512, 513, 1000, 1024, 1025, 2049, 4097, 7000,
                     8192)
K9_FRONTIER_CASES = ("all_over", "no_under", "zero_surplus", "dead")
K9_ROUTE_SIZES = (50, 100, 200, 256, 512, 1000)  # the rank pass against the bitonic sort
FLEET = (7000, 70, 500, 100.0, 3)  # the detector fleet's brokers: K9 at B = 7,000


def k9_args(gk, model, arrays):
    """K9's three calls on one model as the main path makes them: the sweep
    of ``STACK``, the frontier mask of ``K9_BAND_GOAL``'s rows and the batch
    of ``STACK``."""
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS, goals_by_priority
    con = BalancingConstraint.default()
    specs = tuple(goals_by_priority(STACK))
    return {"stack_sweep": (specs, model, arrays, con),
            "frontier_active": gk.frontier_inputs(GOAL_SPECS[K9_BAND_GOAL], model, arrays, con),
            "frontier_active_batch": gk.frontier_inputs_batch(specs, model, arrays, con)}


def k9_calls(gk, args):
    """{kernel: (the wrapper's call, its plain twin's call)} on ``args``."""
    return {"stack_sweep": (lambda: gk.stack_satisfied(*args["stack_sweep"]),
                            lambda: gk.stack_satisfied_plain(*args["stack_sweep"])),
            "frontier_active": (lambda: gk.frontier_mask(*args["frontier_active"]),
                                lambda: gk.frontier_mask_plain(*args["frontier_active"])),
            "frontier_active_batch": (
                lambda: gk.frontier_active_batch(*args["frontier_active_batch"]),
                lambda: gk.frontier_active_batch_plain(*args["frontier_active_batch"]))}


def k9_device_ms(torch, gk, model, arrays, log):
    """Device ms of K9's three kernels on one model's calls (``k9_args``):
    per launch by kernel name, and per call with every device op (the
    sweep's two memsets too)."""
    out = {}
    for name, (fn, _) in k9_calls(gk, k9_args(gk, model, arrays)).items():
        out[name] = {"device_ms": device_ms(torch, fn, PROFILE_NAMES[name], log),
                     "device_ms_call": device_ms_total(torch, fn, log)}
    return out


def _k9_bound(name, args):
    """Bytes over the memory rate of one K9 call (``k9_args``)."""
    if name == "stack_sweep":
        specs, model = args[name][:2]
        return bound_ms(_k9_bytes(specs, model))
    if name == "frontier_active":
        b = args[name][0].shape[0]
        return bound_ms(b * 18 + b + 4)
    metric, band = args[name][0], args[name][3]
    g, b = metric.shape
    return bound_ms(int(band.sum()) * b * 12 + b * 6 + g * 5 + g * b + g * 4)


def k9_frontier_rows(torch, np, dev, b, case, seed):
    """(metric, lower, upper, alive, valid, replica_count, eps) of one seeded
    band goal at ``b`` brokers: non-dyadic lognormal loads, a fifth of the
    metrics copied onto others (equal-value ties), in "mixed" a twentieth
    -0.0, a tenth of the bands unbounded above and a twentieth of the
    brokers dead; "all_over" every broker a donor over its band,
    "no_under" none under it, "zero_surplus" every broker inside it,
    "dead" a sixth dead (light ones) still hosting replicas."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    cap = rng.lognormal(3.0, 0.3, b).astype(f32)
    metric = (cap * rng.uniform(0.42, 0.93, b)).astype(f32)
    ties = rng.random(b) < 0.2
    metric[ties] = metric[rng.integers(0, b, int(ties.sum()))]
    lower, upper = (cap * f32(0.45)).astype(f32), (cap * f32(0.9)).astype(f32)
    alive, valid = np.ones(b, bool), np.ones(b, bool)
    rc = rng.integers(0, 40, b).astype(np.int32)
    if case == "mixed":
        metric[rng.random(b) < 0.05] = f32(-0.0)
        upper[rng.random(b) < 0.1] = f32(1e30)
        alive[rng.random(b) < 0.05] = False
    elif case == "all_over":
        metric = (upper * f32(1.7) + f32(0.3)).astype(f32)
    elif case == "no_under":
        metric = np.maximum(metric, lower * f32(1.01)).astype(f32)
    elif case == "zero_surplus":
        metric = (lower + (upper - lower) * f32(0.37)).astype(f32)
    elif case == "dead":
        alive[rng.random(b) < 0.15] = False
        rc[~alive] = np.maximum(rc[~alive], 1)
        metric[~alive] = (metric[~alive] * f32(0.01)).astype(f32)
    tensors = [torch.from_numpy(x).to(dev) for x in (metric, lower, upper, alive, valid, rc)]
    return tuple(tensors) + (float(f32(1e-6)),)


def k9_sweep_variants(torch, model):
    """``model`` with its last valid replica (in the sweep's last tile) moved
    onto its lowest sibling's broker (a rack conflict), reported offline on
    its original broker, or led by its partition's last replica; and with
    broker 3 dead."""
    from cruise_control_tpu_torch.model.tensor_model import BrokerState
    r = int(torch.nonzero(model.replica_valid).max())
    sib = model.partition_replicas[int(model.replica_partition[r])]
    sib = sib[sib >= 0].long()
    rb = model.replica_broker.clone()
    rb[r] = rb[int(sib.min())]
    off = model.replica_offline.clone()
    off[r] = True
    original = model.replica_original_broker.clone()
    original[r] = model.replica_broker[r]
    lead = model.replica_is_leader.clone()
    lead[sib[0]], lead[sib[-1]] = False, True
    return {"rack_last": model.replace(replica_broker=rb),
            "offline_last": model.replace(replica_offline=off, replica_original_broker=original),
            "preferred_last": model.replace(replica_is_leader=lead),
            "dead_broker": model.set_broker_state(3, BrokerState.DEAD)}


def _other_sort(torch, gk, rows):
    """The frontier mask of ``rows`` (at most 1,024 brokers) through the sort
    the wrapper does not take at their size."""
    b = rows[0].shape[0]
    active = torch.empty((b,), dtype=torch.bool, device=rows[0].device)
    count = torch.empty((1,), dtype=torch.int32, device=rows[0].device)
    rank_max = 0 if b <= gk.FRONTIER_RANK_MAX_BROKERS else 1024
    gk.frontier_mask_launch(*rows, active, count, rank_max=rank_max)
    return active, count


def guarded_k9(torch, gk, name, args):
    """One launch of a K9 kernel through its launch function into outputs
    that each lie between canary bands; raises if a band changed or the
    outputs differ from the wrapper's."""
    dev = args[0].device if name != "stack_sweep" else args[2].load.device
    if name == "stack_sweep":
        g = len(args[0])
        sizes = [-(-g // 4), 1]
    elif name == "frontier_active":
        b = args[0].shape[0]
        sizes = [-(-b // 4), 1]
    else:
        g, b = args[0].shape
        sizes = [-(-(g * b) // 4), g]
    buf, guard, views = canary_views(torch, dev, sizes)
    flags = views[0].view(torch.uint8)
    if name == "stack_sweep":
        got = (flags[:g].view(torch.bool), views[1].view(torch.uint8)[:1].view(torch.bool))
        gk.stack_sweep_launch(*args, *got)
        ref = gk.stack_satisfied(*args)
    elif name == "frontier_active":
        got = (flags[:b].view(torch.bool), views[1])
        gk.frontier_mask_launch(*args, *got)
        ref = gk.frontier_mask(*args)
    else:
        got = (flags[:g * b].view(torch.bool).view(g, b), views[1])
        gk.frontier_batch_launch(*args, *got)
        ref = gk.frontier_active_batch(*args)
    torch.cuda.synchronize()
    if not bool((buf[guard] == CANARY).all()):
        raise RuntimeError(f"{name}: a launch wrote outside its outputs")
    if not _exact(torch, got, ref):
        raise RuntimeError(f"{name}: the guarded launch differs from the wrapper's")


def check_k9(torch, np, log, timer, inputs, device, rehearse):
    """K9's sweep, frontier mask and batch on the models the mid, large and
    xl250 warm-ups handed the sweep and on the 7,000-broker fleet
    (``inputs``: label -> (model, arrays)): the sweep of ``STACK``, every
    band goal's frontier mask and the batch of ``STACK``; the sweep of
    ``K9_SWEEP_GOALS`` (a designated topic a broker must lead) on the large
    model's ``k9_sweep_variants``; the frontier mask on seeded rows
    (``k9_frontier_rows`` at ``K9_FRONTIER_SIZES``, through the rank pass
    and the bitonic sort alike) and the batch on stacks of them.  Each is
    bit for bit against its plain twin on CPU copies (the sweep also on the
    card), identical over two launches and a graph replay, and launched into
    canary-guarded outputs (``guarded_k9``).  At each label, timed as one
    call (``ms``, and its host time), in a replayed graph (``graph_ms``)
    beside the plain twin and the bound, with the device ms a launch and a
    call from ``device`` (profiled where the profiler is reliable); at
    large the sweep of each of ``K9_SWEEP_GOALS`` alone in a graph; the two
    sorts against each other at ``K9_ROUTE_SIZES``.  Returns {kernel:
    {metric_<label>: value}}."""
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays

    checked = {name: 0 for name in K9_KERNELS}

    def check(name, label, args, wrapper, plain, launch=None):
        got, again = wrapper(*args), wrapper(*args)
        if not _exact(torch, got, again):
            raise RuntimeError(f"K9 {name} ({label}) differs between two launches")
        if not _exact(torch, got, plain(*_clone(torch, args, device="cpu"))):
            raise RuntimeError(f"K9 {name} ({label}) differs from its plain twin on the CPU")
        if name == "stack_sweep" and not _exact(torch, got, plain(*args)):
            raise RuntimeError(f"K9 {name} ({label}) differs from its plain twin on the card")
        if launch is not None and not _exact(torch, got, launch()):
            raise RuntimeError(f"K9 {name} ({label}) differs between its two sorts")
        if not rehearse:
            if not _graph_replay_equal(torch, lambda: wrapper(*args)):
                raise RuntimeError(f"K9 {name} ({label}): a graph replay differs")
            guarded_k9(torch, gk, name, args)
        checked[name] += 1

    out = {}
    dev = None
    for label, (model, arrays) in inputs.items():
        dev = model.device
        args = k9_args(gk, model, arrays)
        specs, _, _, con = args["stack_sweep"]
        check("stack_sweep", label, args["stack_sweep"], gk.stack_satisfied,
              gk.stack_satisfied_plain)
        for spec in specs:
            if gk.is_band_kind(spec):
                check("frontier_active", f"{label} {spec.name}",
                      gk.frontier_inputs(spec, model, arrays, con), gk.frontier_mask,
                      gk.frontier_mask_plain)
        check("frontier_active_batch", label, args["frontier_active_batch"],
              gk.frontier_active_batch, gk.frontier_active_batch_plain)
        if label == "large":
            goals = tuple(GOAL_SPECS[g] for g in K9_SWEEP_GOALS)
            for variant, m in k9_sweep_variants(torch, model).items():
                con_v, _ = designated_constraint(torch, m)
                a = (goals, m, BrokerArrays.from_model(m, with_topic_counts=True), con_v)
                check("stack_sweep", f"large {variant}", a, gk.stack_satisfied,
                      gk.stack_satisfied_plain)
                sat, off = gk.stack_satisfied(*a)
                log(f"K9 sweep on large {variant}: violated "
                    f"{[g for g, s in zip(K9_SWEEP_GOALS, sat.tolist()) if not s]}, offline "
                    f"{bool(off[0])}")
            if not rehearse:  # the sweep of each goal alone (G = 1), a call in a graph
                con_d, _ = designated_constraint(torch, model)
                by_goal = {f"graph_ms_large_{g}": graph_ms(
                    torch, lambda g=g: gk.stack_satisfied((GOAL_SPECS[g],), model, arrays, con_d))
                    for g in K9_SWEEP_GOALS}
                out.setdefault("stack_sweep", {}).update(by_goal)
                log(f"K9 sweep of one goal at large, device ms a call in a graph: {by_goal}")
        for name, (fn, plain) in k9_calls(gk, args).items():
            r = {"ms": timer(torch, fn), "plain_ms": timer(torch, plain),
                 "bound_ms": _k9_bound(name, args), "host_ms": enqueue_ms(torch, fn),
                 "graph_ms": None if rehearse else graph_ms(torch, fn),
                 **device.get(label, {}).get(name, {})}
            out.setdefault(name, {}).update({f"{k}_{label}": v for k, v in r.items()})
            log(f"K9 {name} at {label}: one call {r['ms']:.4f} ms (host {r['host_ms']:.4f}), "
                f"graph {r['graph_ms']} ms a call, device {r.get('device_ms')} ms a launch "
                f"({r.get('device_ms_call')} a call); plain {r['plain_ms']:.4f} ms; bound "
                f"{r['bound_ms']:.6f} ms")
    # Seeded rows, through both sorts where the rank pass reaches.
    for b in K9_FRONTIER_SIZES:
        cases = ("mixed",) + (K9_FRONTIER_CASES if b in (33, 257, 4097) else ())
        rows_of = {}
        for case in cases:
            rows = rows_of[case] = k9_frontier_rows(torch, np, dev, b, case, seed=b)
            other = (functools.partial(_other_sort, torch, gk, rows)
                     if not rehearse and b <= 1024 else None)
            check("frontier_active", f"seeded B={b} {case}", rows, gk.frontier_mask,
                  gk.frontier_mask_plain, other)
        if b in (33, 257, 4097, 8192):  # a batch of the rows, one not of a band kind
            rows = [rows_of.get(c, rows_of["mixed"]) for c in ("mixed",) + K9_FRONTIER_CASES]
            stacked = [torch.stack([x[i] for x in rows]) for i in range(3)]
            band = torch.tensor([True, True, False, True, True], device=dev)
            eps = torch.full((5,), rows[0][6], dtype=torch.float32, device=dev)
            check("frontier_active_batch", f"seeded B={b}",
                  (*stacked, band, eps, *rows[0][3:6]), gk.frontier_active_batch,
                  gk.frontier_active_batch_plain)
    log(f"K9: {checked} cases bit for bit against the plain twins on CPU copies (the sweep "
        f"also on the card), identical over two launches"
        f"{'' if rehearse else ', a graph replay and into canary-guarded outputs'}; "
        f"seeded frontier rows up to 1,024 brokers through both sorts, from 1,025 through "
        f"the bitonic sort alone")
    if not rehearse:  # the two sorts of the frontier mask, a call in a replayed graph
        routes = {}
        for b in K9_ROUTE_SIZES:
            rows = k9_frontier_rows(torch, np, dev, b, "mixed", seed=b)
            active = torch.empty((b,), dtype=torch.bool, device=dev)
            count = torch.empty((1,), dtype=torch.int32, device=dev)
            for route, rank_max in (("rank", 1024), ("bitonic", 0)):
                routes[f"{route}_graph_ms_B{b}"] = graph_ms(
                    torch, lambda: gk.frontier_mask_launch(*rows, active, count,  # noqa: B023
                                                           rank_max=rank_max))  # noqa: B023
        out["frontier_active"].update(routes)
        log(f"K9 frontier mask, the rank pass against the bitonic sort (device ms a call in "
            f"a replayed graph): {routes}")
    return out


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
    # Device ms a call, every device op of it (its sort and grouping too):
    # here for the mid input, at the large and xl250 warm-ups for theirs.
    on_card = dev.type == "cuda"
    out["prefix_cut"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: k3(*cap)),
        plain_ms=time_ms(torch, lambda: gk.prefix_cut_admit_plain(*cap)),
        library_ms=None, bound_ms=bound_ms(K * 10 + int(cap[3].sum()) * 4 * C + S * 12 * C),
        device_ms_call_mid=device_ms_total(torch, lambda: k3(*cap), log) if on_card else None)
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

    # ---- The per-segment row index K1 and segment_sum walk (three
    # launches): exact against its plain twin on CPU copies, on K1's captured
    # inputs and on the fixture's; its library time is one stable torch.sort
    # of the same segment keys.
    from cruise_control_tpu_torch.ops.segment import segment_row_index_plain
    kx = wrappers["segment_row_index"]
    rb, valid, B = captured["broker_aggregates"][0], captured["broker_aggregates"][1], \
        captured["broker_aggregates"][5]
    for args in ((rb, valid, B), (fix[1], fix[2], fix[3])):
        if not _exact(torch, kx(*args), segment_row_index_plain(*cpu(args))):
            raise RuntimeError("segment_row_index differs from its plain twin on the CPU")
    keys = torch.where(valid & (rb >= 0) & (rb < B), rb, B)
    out["segment_row_index"] = dict(
        max_abs_err=0.0, ms=time_ms(torch, lambda: kx(rb, valid, B)),
        plain_ms=time_ms(torch, lambda: segment_row_index_plain(rb, valid, B)),
        library_ms=time_ms(torch, lambda: torch.sort(keys, stable=True)),
        bound_ms=bound_ms(_index_bytes(valid, B)))
    log(f"segment_row_index: N={rb.shape[0]} S={B} equal to its plain twin on the CPU (exact)")

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
    the CPU cumsum is the order the kernel reproduces) and K9's batch of the
    stack on them (each row the goal's mask), K11 on its case table, the
    ordered sum of the band averages on the captured input and on seeded
    fixtures.  All exact."""
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
    # K9 batch on the same clusters: each band goal's row is that goal's
    # mask, every other row all false.
    kb = wrappers["frontier_active_batch"]
    for label, m in models.items():
        arr = BrokerArrays.from_model(m)
        rows, counts = kb(*gk.frontier_inputs_batch(specs, m, arr, con))
        for g, spec in enumerate(specs):
            want, want_n = (kf(*gk.frontier_inputs(spec, m, arr, con)) if gk.is_band_kind(spec)
                            else (torch.zeros_like(rows[g]), torch.zeros_like(counts[:1])))
            if not (torch.equal(rows[g], want) and torch.equal(counts[g:g + 1], want_n)):
                raise RuntimeError(f"K9 batch row {spec.name} differs from the frontier mask "
                                   f"on {label}")
    log(f"K9 frontier_active_batch: every row equals its goal's frontier mask on "
        f"{list(models)} (exact)")

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
    fixtures = ordered_sum_fixtures(torch, np, dev, x_cap)
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
    replica partitions and sibling rows and the broker racks (and the
    replication factors), the preferred-leader goal's leader flags and
    preferred column, the topic goal's [T, B] counts, the min-leaders goal's
    [T, B] leader counts and designated flags, the disk goals' disk rows,
    and the offline test's replica brokers, disks, reported-offline flags,
    original brokers and valid flags, broker states and disk capacities,
    each read once; G + 1 flags written."""
    R, B, T = model.num_replicas_padded, model.num_brokers, model.num_topics
    D = model.num_disks
    read = {"replica_broker": R * 4, "replica_disk": R * 4, "replica_offline": R,
            "replica_original_broker": R * 4, "replica_valid": R, "broker_state": B,
            "disk_capacity": D * 4}
    cols = set()
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
        elif s.kind in ("rack", "rack_distribution"):
            read.update(replica_partition=R * 4, broker_rack=B * 4,
                        partition_replicas=model.partition_replicas.numel() * 4)
            if s.kind == "rack_distribution":
                read["partition_rf"] = model.num_partitions * 4
        elif s.kind == "topic_replica_distribution":
            read["topic_counts"] = T * B * 4
        elif s.kind == "preferred_leader":
            read.update(replica_partition=R * 4, replica_is_leader=R,
                        preferred_column=model.num_partitions * 4)
        elif s.kind == "min_topic_leaders":
            read.update(topic_leaders=T * B * 4, designated=T)
        elif s.kind in INTRA_KINDS:
            read.update(disk_rows=D * 5 + model.broker_disks.numel() * 4)
    if "partition_replicas" in read:  # the preferred column is in the sibling rows
        read.pop("preferred_column", None)
    return 2 * B + 4 * B * len(cols) + sum(read.values()) + len(specs) + 1


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


def _clone(torch, x, device=None):
    """A deep copy of a kernel argument: tensors cloned (or, with
    ``device``, copied there), dataclasses of tensors (models, arrays,
    candidates) field by field."""
    if isinstance(x, torch.Tensor):
        return x.clone() if device is None else x.to(device, copy=True)
    if isinstance(x, tuple):
        return tuple(_clone(torch, a, device) for a in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(torch, getattr(x, f.name), device)
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
    rows = check_mode_kernels(torch, np, gk, cuda, capture.inputs, log, cx.timer, rehearse,
                              cx.k3_inputs)
    for name, (_, _, run_label) in MODE_KERNELS.items():
        if name in rows:
            rows[name]["launches"] = counts[run_label].get(name, 0)
            rows[name]["launches_run"] = run_label
    return rows, counts, summary


def check_mode_kernels(torch, np, gk, cuda, inputs, log, time_ms, rehearse, k3_inputs):
    """K5's, K5b's and K9's new modes on the inputs ``ModeCapture`` kept,
    and on the same inputs with broker 2 dead: the kernel against its plain
    twin, exactly (score bits, flags).  Each timed (CUDA events, median;
    device time under the profiler) beside its plain twin and its bound.
    K3's first topic cut goes to ``k3_inputs`` for phase 21's K3 checks."""
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
                torch, lambda: gk.prefix_cut_admit(*topic_cut), K3_KERNELS, log),
            device_ms_call=None if rehearse else device_ms_total(
                torch, lambda: gk.prefix_cut_admit(*topic_cut), log),
            shape=dict(K=K, C=C, S=S))
        k3_inputs["topic"] = topic_cut
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
             "stack_sweep": ("stack_sweep_kernel",),
             "segment_sum": PROFILE_NAMES["segment_sum"] + INDEX_KERNELS}  # with its index
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
    if label in ("mid JBOD", "large JBOD"):
        check_k10_cases(torch, np, gk, log, before, after, label, disk=True)
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
    # version in torch ops, its bound and one index_add_; the row index's
    # build alone beside it.
    dl_out = torch.empty_like(got[7])
    build = k10_index_build(gk, before, after, masks, disk=True)
    keys = k10_index_keys(torch, before, after, disk=True)
    out = {"blend_aggregates[disk]": dict(
        max_abs_err=0.0, shape=shape,
        ms=cx.timer(torch, lambda: gk.blend_disk_load(before, after, masks, dl_out), fast),
        plain_ms=cx.timer(torch, lambda: gk.blend_disk_load_plain(before, after, masks), 3),
        library_ms=cx.timer(torch, lambda: acc.zero_().index_add_(0, seg, vals), fast),
        bound_ms=bound_ms(_k10_disk_bytes(before, C)),
        device_ms=None if rehearse else device_ms(
            torch, lambda: gk.blend_disk_load(before, after, masks, dl_out),
            ("blend_disk_load_kernel",), log),
        index_ms=cx.timer(torch, build, fast),
        index_device_ms=None if rehearse else device_ms_total(torch, build, log),
        index_library_ms=cx.timer(torch, lambda: [k.sort() for k in keys], fast),
        index_bound_ms=bound_ms(_k10_index_bytes(keys, masks, (D,))))}
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
    del rmask, rd, lead, seg, vals, acc, dl_out, keys
    log(f"K10 {label}: C={C} R={R} D={D}, {moved} partitions moved; disk loads bit-equal "
        f"to the plain twin and to the plain version on the CPU (all-false blend = "
        f"segment_sum[disk]), flags exact")
    for name, r in out.items():
        log(f"  K10 {label} {name}: kernel {r['ms']:.4f} ms (device {r['device_ms']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
    log_index_build(log, label, out["blend_aggregates[disk]"])
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
    """A self-healing context for the detection phase, which times the
    detectors and one heal without the facade's request path: ``rebalance``
    builds the monitor's model and solves it with ``solve``; every other
    call is recorded and answered True (the facade itself is driven in the
    service phase)."""

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
        counts["detect"] = {n: c for n, c in cuda.launch_counts().items() if c}
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
        counts["tick"] = cuda.launch_counts()
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
        counts["dead"] = {n: c for n, c in cuda.launch_counts().items() if c}
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


# ---------------------------------------------------------------------------
# Phase 19: the service front, with the flight recorder, the budget ablation
# and the repair oracle
# ---------------------------------------------------------------------------

SERVICE_KERNELS = {
    # name: (source, JAX function it replaces, the run whose launches count)
    "flight_row": ("cruise_control_tpu_torch/csrc/flight_row.cu",
                   "cruise_control_tpu/analyzer/optimizer.py:1213", "service proposals"),
    "band_accepts": ("cruise_control_tpu_torch/csrc/band_accepts.cu",
                     "cruise_control_tpu/analyzer/goals/kernels.py:931", "mid ablation"),
}
# The timed shapes: the flight row over the large service solve's widest
# step (RackAwareGoal's, 102,400 lanes) cut as a distribution goal's
# batches (move, leadership, swap) with the frontier count over 200 brokers;
# the band accepts of the mid stack's last goal (its 12 band goals before
# it) over a mid step's 32,768 lanes.
SERVICE_SHAPES = {"flight_row": dict(K=102400, B=200, offsets=(0, 65536, 69632, 102400),
                                     kinds=(0, 1, 3)),
                  "band_accepts": dict(S=12, B=50, K=32768)}
SERVICE_WINDOWS = 4  # sampler windows fed to the service's monitor (3 complete, 1 open)
SERVICE_WAIT = {"max_wait_s": "900"}
# Steps a goal the ablation's mid solve may take: without the budgets a
# step lands few actions and the goals run long (the card's and the CPU's
# solves both stop there).
ABLATION_STEPS = 16


def service_stack(cx, md):
    """The port's service on ``cx.dev``: a ``LoadMonitor`` fed
    SERVICE_WINDOWS windows of the synthetic sampler over the metadata
    ``md``, an in-memory admin and executor, ``CruiseControl`` with the
    15-goal stack and ``CruiseControlApi`` (tests/test_api.py's recipe)."""
    from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
    from cruise_control_tpu_torch.api.facade import CruiseControl
    from cruise_control_tpu_torch.api.server import CruiseControlApi
    from cruise_control_tpu_torch.detector.manager import AnomalyDetectorManager
    from cruise_control_tpu_torch.detector.notifier import SelfHealingNotifier
    from cruise_control_tpu_torch.executor.admin import InMemoryClusterAdmin
    from cruise_control_tpu_torch.executor.executor import Executor
    from cruise_control_tpu_torch.monitor.capacity import StaticCapacityResolver
    from cruise_control_tpu_torch.monitor.load_monitor import LoadMonitor
    from cruise_control_tpu_torch.monitor.metadata import MetadataClient
    from cruise_control_tpu_torch.monitor.sampling import SyntheticWorkloadSampler
    mc = MetadataClient(md)
    lm = LoadMonitor(mc, StaticCapacityResolver(), num_partition_windows=SERVICE_WINDOWS - 1,
                     partition_window_ms=WINDOW_MS, device=cx.dev)
    lm.start_up()
    sampler = SyntheticWorkloadSampler()
    for w in range(SERVICE_WINDOWS):
        lm.fetch_once(sampler, w * WINDOW_MS, w * WINDOW_MS + 1)
    admin = InMemoryClusterAdmin(mc, latency_polls=1)
    ex = Executor(admin, mc)
    cc = CruiseControl(lm, ex, admin, goals=STACK,
                       hard_goals=[g for g in STACK if GOAL_SPECS[g].is_hard], device=cx.dev)
    mgr = AnomalyDetectorManager(SelfHealingNotifier(), cc,
                                 executor_busy=lambda: ex.has_ongoing_execution)
    return CruiseControlApi(cc, detector_manager=mgr, sampler=sampler), cc


def _request(api, method, endpoint, params, label):
    status, body, headers = api.handle(method, endpoint, dict(params))
    if status != 200:
        raise RuntimeError(f"{label}: {method} /{endpoint} answered {status}: "
                           f"{str(body)[:400]}")
    return body, headers


def _flight_steps(run):
    return {g.name: g.flight["steps"] for g in run.goal_results if g.flight is not None}


def check_service_kernels(cx):
    """Phase 19's kernels against their plain twins on seeded inputs at
    ``SERVICE_SHAPES``, bit for bit (the flight row with the step active and
    gated off, with and without a frontier mask), each timed beside its
    plain twin and the profiler's device time.  Returns the kernel rows."""
    torch, np, opt, gk, log, dev = cx.torch, cx.np, cx.opt, cx.gk, cx.log, cx.dev
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N,
                                                         CTR_STEPS, CTR_WIDTH, FLIGHT_WIDTH)
    rng = np.random.default_rng(SEED)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fs = SERVICE_SHAPES["flight_row"]
    k, b = fs["K"], fs["B"]
    keep, score, elig, fmask = flight_fixture(torch, np, dev, k, 0.01, 0.3, b, (0, 0, 0), rng)
    rep = torch.tensor(1, dtype=torch.int32, device=dev)
    lanes = torch.tensor(4096, dtype=torch.int32, device=dev)
    ctr = torch.zeros((CTR_WIDTH,), dtype=torch.int32, device=dev)
    ctr[CTR_STEPS], ctr[CTR_LAST_N], ctr[CTR_BUDGET] = 5, 1, 32
    off = ctr.clone()
    off[CTR_LAST_N] = 0
    got = torch.zeros((32, FLIGHT_WIDTH), dtype=torch.int32, device=dev)
    ref = got.clone()
    for counters, mask in ((ctr, fmask), (ctr, None), (off, fmask)):
        args = (counters, keep, fs["offsets"], fs["kinds"], score, elig, mask, rep, lanes, 12)
        opt.flight_row(*args, got)
        opt.flight_row_plain(*args, ref)
    if not _exact(torch, got, ref):
        raise RuntimeError("cc_flight_row differs from its plain twin on seeded inputs")
    edges = check_flight_edges(torch, np, opt, dev, rng, rep, lanes, ctr, off)
    log(f"  flight_row: bit for bit with its plain twin on the edges {edges}, active and "
        "gated off")
    if not cx.rehearse:
        guarded_flight_row(torch, opt, (ctr, keep, fs["offsets"], fs["kinds"], score, elig,
                                        fmask, rep, lanes, 12))
        cut = k - 9
        guarded_flight_row(torch, opt, (ctr, keep[:cut], (0, 40_000, cut), (0, 3), score[:cut],
                                        elig[:cut], None, rep, lanes, 12))
        log("  flight_row through its C entry into canary-guarded buffers: no write outside "
            "them, equal to the wrapper's")
    args = (ctr, keep, fs["offsets"], fs["kinds"], score, elig, fmask, rep, lanes, 12)
    timer = cx.timer
    rows = {"flight_row": dict(
        shape=dict(K=k, B=b, batches=len(fs["kinds"]),
                   blocks=opt.flight_tiling(k, b)), max_abs_err=0.0,
        ms=timer(torch, lambda: opt.flight_row(*args, got)),
        plain_ms=timer(torch, lambda: opt.flight_row_plain(*args, ref)),
        device_ms=None if cx.rehearse else device_ms(
            torch, lambda: opt.flight_row(*args, got), FLIGHT_ROW_KERNELS, log),
        nbytes=k * 6 + b + 4 * (len(fs["offsets"]) + len(fs["kinds"])) + 4 * CTR_WIDTH + 8
        + 4 * FLIGHT_WIDTH, library_ms=None)}

    bs = SERVICE_SHAPES["band_accepts"]
    s_, b_, k_ = bs["S"], bs["B"], bs["K"]
    metric = rng.normal(size=(s_, b_)).astype(np.float32) * 100
    lower = metric - rng.random((s_, b_)).astype(np.float32) * 30
    upper = metric + rng.random((s_, b_)).astype(np.float32) * 30
    d_src = -np.abs(rng.normal(size=(s_, k_)).astype(np.float32)) * 2
    tables = tuple(on_dev(a) for a in (
        metric, lower, upper, d_src, -d_src, rng.random(s_) < 0.5, rng.random(b_) < 0.9,
        rng.integers(0, b_, k_).astype(np.int32), rng.integers(0, b_, k_).astype(np.int32)))
    mask = gk.band_accepts(*tables)
    if not _exact(torch, mask, gk.accepts_band_batch_plain(*tables)):
        raise RuntimeError("cc_band_accepts differs from its plain twin on seeded inputs")
    rows["band_accepts"] = dict(
        shape=dict(S=s_, B=b_, K=k_), max_abs_err=0.0,
        ms=timer(torch, lambda: gk.band_accepts(*tables)),
        plain_ms=timer(torch, lambda: gk.accepts_band_batch_plain(*tables)),
        device_ms=None if cx.rehearse else device_ms(
            torch, lambda: gk.band_accepts(*tables), ("band_accepts_kernel",), log),
        nbytes=s_ * b_ * 12 + s_ * k_ * 8 + s_ + b_ + k_ * 8 + k_, library_ms=None)
    for name, r in rows.items():
        r["bound_ms"] = bound_ms(r.pop("nbytes"))
        r["bound_by"] = "bytes"
        log(f"  {name} at {r['shape']}: bit for bit with its plain twin; kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']}), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.7f} ms (bytes)")
    log(f"  band accepts: {int(mask.sum())} of {k_} lanes accepted")
    return rows


# K8's flight row's device kernels, the row's (one a call) first.
FLIGHT_ROW_KERNELS = ("flight_row_kernel", "flight_partials_kernel")
# Its edge cases: K, the batch offsets, the shares of kept and eligible
# lanes, B (None: no frontier mask) and how many lanes past a 16-byte-aligned
# base keep, eligible and score start (views into larger buffers): the
# partials launch reads 16-lane groups from the first lane where all three
# are aligned, one lane at a time before it and after the last full group,
# or every lane when they are not aligned alike.
FLIGHT_EDGES = {
    "ragged": (1007, (0, 400, 1007), 0.3, 0.5, 12, (0, 0, 0)),
    "boundary_in_group": (96, (0, 37, 70, 96), 0.5, 0.5, 4, (0, 0, 0)),
    "empty_batches": (160, (0, 0, 50, 50, 160, 160), 0.4, 0.3, 3, (0, 0, 0)),
    "one_batch": (333, (0, 333), 0.2, 0.4, None, (0, 0, 0)),
    "eight_batches": (512, (0, 1, 17, 64, 65, 200, 300, 301, 512), 0.5, 0.5, 30, (0, 0, 0)),
    "no_eligible": (200, (0, 100, 200), 0.3, 0.0, 7, (0, 0, 0)),
    "nothing_kept": (64, (0, 20, 64), 0.0, 0.5, 5, (0, 0, 0)),
    "below_a_group": (11, (0, 5, 11), 0.5, 0.5, 2, (0, 0, 0)),
    "head": (5000, (0, 3001, 5000), 0.3, 0.5, 50, (3, 3, 3)),
    "unaligned": (5000, (0, 2500, 5000), 0.3, 0.5, 50, (5, 1, 2)),
    "frontier_wider": (100, (0, 60, 100), 0.3, 0.5, 5000, (0, 0, 0)),
    "grid_stride": (2_200_001, (0, 1_000_000, 2_200_001), 0.01, 0.3, 1000, (0, 0, 0)),
    "signed_zero_tie": (5000, (0, 2500, 5000), 0.3, 0.5, 50, (0, 0, 0)),
    "nan": (5000, (0, 2500, 5000), 0.3, 0.5, 50, (0, 0, 0)),
}


def flight_special_scores(np, name, score, eligible):
    """The scores of FLIGHT_EDGES' ties.  ``signed_zero_tie``: every score
    negative but the eligible lanes' maximum, -0 and +0 on alternate eligible
    lanes, -0 first (+0 must win, in whichever block); ``nan``: a NaN of
    each sign among the eligible lanes (the positive one ranks above every
    number, the negative one below)."""
    score = score.copy()
    lanes = np.flatnonzero(eligible)
    if name == "signed_zero_tie":
        score[:] = -np.abs(score) - np.float32(1.0)
        for j, i in enumerate(lanes[::7]):
            score[i] = np.float32(-0.0) if j % 2 == 0 else np.float32(0.0)
    elif name == "nan":
        score[lanes[3]] = -np.float32(np.nan)
        score[lanes[-4]] = np.float32(np.nan)
    return score


def flight_fixture(torch, np, dev, k, kept, eligible, b, past, rng, name=None):
    """Seeded (keep, score, eligible, fmask or None) of ``k`` lanes, keep,
    eligible and score starting ``past`` lanes into larger buffers; the
    scores of case ``name`` as ``flight_special_scores`` sets them."""
    def view(a, at):
        buf = np.zeros(a.shape[0] + 16, a.dtype)
        buf[at:at + a.shape[0]] = a
        return torch.from_numpy(buf).to(dev)[at:at + a.shape[0]]
    keep = view(rng.random(k) < kept, past[0])
    score = rng.normal(size=k).astype(np.float32)
    el = rng.random(k) < eligible
    score = view(flight_special_scores(np, name, score, el), past[2])
    elig = view(el, past[1])
    fmask = None if b is None else torch.from_numpy(rng.random(b) < 0.5).to(dev)
    return keep, score, elig, fmask


def check_flight_edges(torch, np, opt, dev, rng, rep, lanes, ctr, off):
    """K8's flight row on every case of ``FLIGHT_EDGES``, its step active
    and gated off, bit for bit against its plain twin (a row written, or
    none); returns the cases' names."""
    from cruise_control_tpu_torch.analyzer.state import FLIGHT_WIDTH
    for name, (k, offsets, kept, el, b, past) in FLIGHT_EDGES.items():
        keep, score, elig, fmask = flight_fixture(torch, np, dev, k, kept, el, b, past, rng,
                                                  name)
        kinds = tuple((3 * s + 1) % 5 for s in range(len(offsets) - 1))
        got = torch.full((8, FLIGHT_WIDTH), 99, dtype=torch.int32, device=dev)
        ref = got.clone()
        for counters in (ctr, off):
            args = (counters, keep, offsets, kinds, score, elig, fmask, rep, lanes, 3)
            opt.flight_row(*args, got)
            opt.flight_row_plain(*args, ref)
        if not _exact(torch, got, ref):
            raise RuntimeError(f"cc_flight_row differs from its plain twin on {name}: "
                               f"{got[5].tolist()} vs {ref[5].tolist()}")
        want = {"signed_zero_tie": 0, "nan": int(np.float32(np.nan).view(np.int32))}
        if name in want and int(ref[5, 5]) != want[name]:
            raise RuntimeError(f"flight row {name}: score bits {int(ref[5, 5])}, "
                               f"expected {want[name]}")
    return sorted(FLIGHT_EDGES)


def guarded_flight_row(torch, opt, args):
    """One ``cc_flight_row`` through its C entry, its row buffer and its
    partials between canary bands: raises if a band changed or the row
    differs from the plain twin's."""
    from cruise_control_tpu_torch.analyzer.state import FLIGHT_WIDTH
    from cruise_control_tpu_torch.ops import cuda
    counters, keep, offsets, kinds, score, elig, fmask, rep, lanes, depth = args
    dev, k = keep.device, keep.shape[0]
    b = 0 if fmask is None else fmask.shape[0]
    blocks, cap = opt.flight_tiling(k, b), 32
    buf, guard, (rows, partials) = canary_views(
        torch, dev, [cap * FLIGHT_WIDTH, blocks * opt.FLIGHT_PARTIAL])
    off_t, kind_t = opt._flight_consts(tuple(offsets), tuple(kinds), dev)
    rows.zero_()
    cuda.launch("flight_row", counters, keep, k, off_t, kind_t, len(kinds), score, elig, fmask,
                b, rep, lanes, depth, rows, cap, partials, blocks)
    torch.cuda.synchronize()
    if not bool((buf[guard] == CANARY).all()):
        raise RuntimeError("cc_flight_row: a launch wrote outside its buffers")
    ref = torch.zeros((cap, FLIGHT_WIDTH), dtype=torch.int32, device=dev)
    opt.flight_row_plain(counters, keep, offsets, kinds, score, elig, fmask, rep, lanes, depth,
                         ref)
    if not _exact(torch, rows.view(cap, FLIGHT_WIDTH), ref):
        raise RuntimeError("cc_flight_row: the guarded launch differs from the plain twin")


def check_flight_row_graph(torch, np, opt, dev, log):
    """Phase 21: K8's flight row captured in a CUDA graph of this script's
    own (after every profiler session) at the service shape, its step
    active and gated off: one replay equals the plain twin's row, and the
    gated-off replay writes nothing."""
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N, CTR_STEPS,
                                                         CTR_WIDTH, FLIGHT_WIDTH)
    rng = np.random.default_rng(SEED + 1)
    fs = SERVICE_SHAPES["flight_row"]
    keep, score, elig, fmask = flight_fixture(torch, np, dev, fs["K"], 0.01, 0.3, fs["B"],
                                              (0, 0, 0), rng)
    rep = torch.tensor(0, dtype=torch.int32, device=dev)
    lanes = torch.tensor(2048, dtype=torch.int32, device=dev)
    same = []
    for last_n in (1, 0):
        ctr = torch.zeros((CTR_WIDTH,), dtype=torch.int32, device=dev)
        ctr[CTR_STEPS], ctr[CTR_LAST_N], ctr[CTR_BUDGET] = 3, last_n, 8
        buf = torch.full((8, FLIGHT_WIDTH), 99, dtype=torch.int32, device=dev)
        args = (ctr, keep, fs["offsets"], fs["kinds"], score, elig, fmask, rep, lanes, 4)

        def fn():
            buf.fill_(99)
            opt.flight_row(*args, buf)
            return buf.clone()
        ref = torch.full((8, FLIGHT_WIDTH), 99, dtype=torch.int32, device=dev)
        opt.flight_row_plain(*args, ref)
        same.append(_graph_replay_equal(torch, fn) and _exact(torch, fn(), ref))
    log(f"  flight_row in a graph replay (active, gated off): equal to the plain twin {same}")
    if not all(same):
        raise RuntimeError("cc_flight_row in a graph replay differs from its plain twin")


def check_service(cx):
    """Phase 19: the large rung's cluster as metadata behind the port's
    service on the card; with the flight recorder on, ``GET /proposals``
    (the main path, counters set to 0 just before), ``POST /rebalance`` dry
    run and ``GET /flight`` of its task; the recorder off places the same;
    ``cc_flight_row``'s rows against the plain twin's from an eager run of
    the same solve; a mid solve under ``_DBG_NO_BUDGETS`` (``cc_band_accepts``
    launched, bit for bit on its captured inputs, placed as on the CPU); a
    mid solve under ``CRUISE_REPAIR_ORACLE=1`` placed as on the CPU; the
    service solve timed with the recorder on and off in turns (the two new
    kernels are timed in phase 4, ``check_service_kernels``).  Returns
    (launch counts, summary)."""
    torch, np, opt, cuda, gk, log = cx.torch, cx.np, cx.opt, cx.cuda, cx.gk, cx.log
    dev, rehearse = cx.dev, cx.rehearse
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N,
                                                         CTR_STEPS)
    summary, counts = {}, {}
    saved = {k: os.environ.get(k) for k in ("CRUISE_FLIGHT_RECORDER", "CRUISE_REPAIR_ORACLE")}
    try:
        t0 = time.monotonic()
        md = fleet_metadata(np, cx.generate_cluster(cx.spec_of(cx.large_rung), device="cpu"))
        api, cc = service_stack(cx, md)
        summary["stack_s"] = round(time.monotonic() - t0, 3)
        log(f"service: {len(md.brokers)} brokers, {md.partition_count()} partitions, "
            f"{md.replica_count()} replicas; monitor and facade on {cc.device} in "
            f"{summary['stack_s']} s")

        # The main path: recorder on, GET /proposals from a cold cache.
        os.environ["CRUISE_FLIGHT_RECORDER"] = "1"
        state, _ = _request(api, "GET", "state", {"substates": "analyzer"}, "state")
        if state["AnalyzerState"]["flightRecorder"] is not True:
            raise RuntimeError(f"the facade does not report the recorder: {state}")
        cuda.CAPTURE = {}
        cuda.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        on, _ = _request(api, "GET", "proposals", SERVICE_WAIT, "recorder-on proposals")
        torch.cuda.synchronize()
        summary["proposals_s"] = round(time.monotonic() - t0, 3)
        counts["service proposals"] = cuda.launch_counts()
        captured, cuda.CAPTURE = cuda.CAPTURE, None
        _, _, pre_model, run_on, _ = cc._cached
        if not on["ok"] or on["numProposals"] == 0 or not (run_on.pipelined or rehearse):
            raise RuntimeError(f"recorder-on proposals: ok {on['ok']}, "
                               f"{on['numProposals']} proposals, pipelined {run_on.pipelined}")
        cx.check_launched("service", {n: counts["service proposals"][n] for n in KERNELS})
        if not rehearse and counts["service proposals"]["flight_row"] == 0:
            raise RuntimeError("the recorder-on solve launched no cc_flight_row")
        summary["proposals"] = on["numProposals"]
        summary["steps"] = sum(g.steps for g in run_on.goal_results)
        log(f"GET /proposals, recorder on ({summary['proposals_s']} s): "
            f"{on['numProposals']} proposals, {summary['steps']} steps, reason "
            f"{on['reason']!r}; launches "
            f"{ {n: c for n, c in counts['service proposals'].items() if c} }")

        t0 = time.monotonic()
        reb, headers = _request(api, "POST", "rebalance", {"dryrun": "true", **SERVICE_WAIT},
                                "recorder-on rebalance")
        torch.cuda.synchronize()
        summary["rebalance_s"] = round(time.monotonic() - t0, 3)
        if reb["numProposals"] != on["numProposals"] or reb["proposals"] != on["proposals"]:
            raise RuntimeError("POST /rebalance proposed otherwise than GET /proposals")
        flight, _ = _request(api, "GET", "flight", {"task_id": headers["User-Task-ID"]},
                             "flight")
        recorded = _flight_steps(run_on)
        if {g["goal"]: g["flight"]["steps"] for g in flight["goals"]} != recorded:
            raise RuntimeError(f"GET /flight's timelines ({len(flight['goals'])} goals) "
                               f"differ from the /proposals solve's ({len(recorded)})")
        for g in flight["goals"]:
            steps = g["flight"]["steps"]
            if len(steps) != g["steps"] or sum(s["actions"] for s in steps) != g["actions"]:
                raise RuntimeError(f"GET /flight {g['goal']}: {len(steps)} rows for "
                                   f"{g['steps']} steps")
        summary["flight_goals"] = len(flight["goals"])
        summary["flight_rows"] = sum(len(g["flight"]["steps"]) for g in flight["goals"])
        log(f"POST /rebalance dry run ({summary['rebalance_s']} s), GET /flight: "
            f"{summary['flight_goals']} goals, {summary['flight_rows']} rows, each "
            f"goal's rows summing to its actions, equal to the /proposals solve's")

        # cc_flight_row's rows against the plain twin's: the same solve, its
        # gated steps run eagerly, the plain flight row in the kernel's place.
        kernel_row = opt.flight_row
        opt.flight_row = opt.flight_row_plain
        try:
            t0 = time.monotonic()
            drive = drive_pipelined if run_on.pipelined else drive_fused
            eager = drive(opt, pre_model, STACK, None, None)
            torch.cuda.synchronize()
        finally:
            opt.flight_row = kernel_row
        summary["eager_twin_s"] = round(time.monotonic() - t0, 3)
        same_rows = _flight_steps(eager) == _flight_steps(run_on)
        same = cx.same_placement(eager, run_on)
        log(f"eager twin with the plain flight row ({summary['eager_twin_s']} s): rows "
            f"equal {same_rows} (integer slots and score bits), placement equal {same}")
        if not (same_rows and same):
            raise RuntimeError("cc_flight_row's rows differ from the plain twin's")

        # The recorder off: the same requests place alike and record nothing.
        os.environ.pop("CRUISE_FLIGHT_RECORDER")
        cc.invalidate_proposal_cache()
        t0 = time.monotonic()
        off, _ = _request(api, "GET", "proposals", SERVICE_WAIT, "recorder-off proposals")
        reb_off, _ = _request(api, "POST", "rebalance", {"dryrun": "true", **SERVICE_WAIT},
                              "recorder-off rebalance")
        torch.cuda.synchronize()
        summary["off_s"] = round(time.monotonic() - t0, 3)
        run_off = cc._cached[3]
        if not (cx.same_placement(run_off, run_on) and off["proposals"] == on["proposals"]
                and reb_off["numProposals"] == reb["numProposals"]
                and all(g.flight is None for g in run_off.goal_results)):
            raise RuntimeError("the recorder-off service solve differs from the recorder-on")
        log(f"recorder off ({summary['off_s']} s for both requests): the same placement "
            f"and proposals, no timeline")

        # The recorder's cost: the same solve timed on and off, in turns.
        walls = {"on": [], "off": []}
        for mode in ("on", "off", "off", "on"):
            if mode == "on":
                os.environ["CRUISE_FLIGHT_RECORDER"] = "1"
            else:
                os.environ.pop("CRUISE_FLIGHT_RECORDER", None)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            opt.optimize(opt.donation_copy(pre_model), STACK, fused=True, donate_model=True,
                         raise_on_hard_failure=False, device=dev)
            torch.cuda.synchronize()
            walls[mode].append(round(time.monotonic() - t0, 4))
        os.environ.pop("CRUISE_FLIGHT_RECORDER", None)
        summary["recorder_walls_s"] = walls
        log(f"large service solve timed in turns (on, off, off, on): {walls}")

        # K8's flight row on its captured inputs, the step made active.
        if "flight_row" not in captured:
            raise RuntimeError(f"no flight row captured: {sorted(captured)}")
        c0, keep, offs, kinds, score, elig, fmask, rep, lanes, depth, buf = \
            captured.pop("flight_row")
        del captured
        ctr = c0.clone()
        ctr[CTR_STEPS], ctr[CTR_LAST_N], ctr[CTR_BUDGET] = 0, 1, buf.shape[0]
        got, ref = buf.clone(), buf.clone()
        opt.flight_row(ctr, keep, offs, kinds, score, elig, fmask, rep, lanes, depth, got)
        opt.flight_row_plain(ctr, keep, offs, kinds, score, elig, fmask, rep, lanes, depth, ref)
        if not _exact(torch, got, ref):
            raise RuntimeError("cc_flight_row differs from its plain twin on its inputs")
        summary["flight_row_captured"] = dict(K=keep.shape[0], batches=len(kinds))
        log(f"cc_flight_row on the solve's captured inputs (K={keep.shape[0]}, "
            f"{len(kinds)} batch): bit for bit with its plain twin")

        # The budget ablation: a mid solve, its steps vetoed by the band
        # goals' accepts (cc_band_accepts) instead of the budgets.
        mid = cx.mid
        opt._DBG_NO_BUDGETS = True
        try:
            cuda.CAPTURE = {}
            cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            abl = opt.optimize(mid, STACK, fused=True, raise_on_hard_failure=False, device=dev,
                               max_steps_per_goal=ABLATION_STEPS)
            torch.cuda.synchronize()
            summary["ablation_s"] = round(time.monotonic() - t0, 3)
            counts["mid ablation"] = cuda.launch_counts()
            captured, cuda.CAPTURE = cuda.CAPTURE, None
            t0 = time.monotonic()
            abl_cpu = opt.optimize(mid.to("cpu"), STACK, fused=True,
                                   raise_on_hard_failure=False, device="cpu",
                                   max_steps_per_goal=ABLATION_STEPS)
            summary["ablation_cpu_s"] = round(time.monotonic() - t0, 3)
        finally:
            opt._DBG_NO_BUDGETS = False
        same = cx.same_placement(abl, abl_cpu)
        n_band = counts["mid ablation"]["band_accepts"]
        log(f"mid ablation ({summary['ablation_s']} s on the card, "
            f"{summary['ablation_cpu_s']} s on the CPU): {sum(g.steps for g in abl.goal_results)} "
            f"steps, cc_band_accepts launched {n_band} times; card equals CPU: {same}")
        if not same or (not rehearse and n_band == 0):
            raise RuntimeError("the ablation's card solve differs from the CPU's, or "
                               "launched no cc_band_accepts")
        if "band_accepts" not in captured:
            raise RuntimeError(f"no band accepts captured: {sorted(captured)}")
        tables = captured.pop("band_accepts")
        del captured
        if not _exact(torch, gk.band_accepts(*tables), gk.accepts_band_batch_plain(*tables)):
            raise RuntimeError("cc_band_accepts differs from its plain twin on its inputs")
        summary["band_accepts_captured"] = dict(S=tables[0].shape[0], B=tables[0].shape[1],
                                                K=tables[7].shape[0])
        log(f"cc_band_accepts on the ablation's captured inputs "
            f"{summary['band_accepts_captured']}: bit for bit with its plain twin")

        # The repair oracle: a mid solve, its steps eager on the card.
        os.environ["CRUISE_REPAIR_ORACLE"] = "1"
        reads = opt.REPAIR_ORACLE_COUNTERS["host_reads"]
        t0 = time.monotonic()
        orc = opt.optimize(mid, STACK, fused=True, raise_on_hard_failure=False, device=dev)
        torch.cuda.synchronize()
        summary["oracle_s"] = round(time.monotonic() - t0, 3)
        reads = opt.REPAIR_ORACLE_COUNTERS["host_reads"] - reads
        t0 = time.monotonic()
        orc_cpu = opt.optimize(mid.to("cpu"), STACK, fused=True, raise_on_hard_failure=False,
                               device="cpu")
        summary["oracle_cpu_s"] = round(time.monotonic() - t0, 3)
        same = cx.same_placement(orc, orc_cpu)
        log(f"mid repair oracle ({summary['oracle_s']} s on the card, "
            f"{summary['oracle_cpu_s']} s on the CPU, {reads} host reads on the card): "
            f"card equals CPU: {same}")
        if not same or reads == 0:
            raise RuntimeError("the oracle's card solve differs from the CPU's")
    finally:
        cuda.CAPTURE = None
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 20: the sharded search (parallel/mesh.py) and K15
# ---------------------------------------------------------------------------

_PM = "cruise_control_tpu/parallel/mesh.py"
MESH_KERNELS = {
    # name: (source, what it replaces)
    "shard_combine": ("cruise_control_tpu_torch/csrc/shard_combine.cu",
                      f"{_PM}:69 (the psum of the replica-sharded reductions, {_PM}:16-20)"),
}
# (ranks n, brokers B) of K15's seeded checks: mid and large over 2 ranks,
# and the fleet of tools/sharded_1m.py (7,000 brokers) over 8.
K15_SHAPES = ((2, 50), (2, 200), (8, 7000))
K15_CF, K15_CI = 6, 2  # K1's float aggregates and its counts
# bench.py's mesh rung (bench.py:380-398): the dense floor lowered to 16,
# short segments, the pipeline, widths that are multiples of the mesh size.
MESH_DENSE_MIN = 16
MESH_FLAVOUR = dict(fused=True, fuse_group_size=1, segment_steps=8, pipeline=True,
                    num_sources=32, num_dests=8, raise_on_hard_failure=False)
MESH_PAD = 8  # replicas padded to a multiple of 8
# The step's kernels that every sharded solve must launch on each rank.
MESH_PATH_KERNELS = ("broker_aggregates", "segment_row_index", "best_per_segment",
                     "prefix_cut", "goal_masks", "structural_accepts", "apply_actions",
                     "stack_sweep", "chunk_gate", "shard_combine", "select_mask",
                     "topic_round_sums", "net_viol", "partition_claims")
MESH_TIMEOUT_S = 600


def mesh_spec(rung):
    from cruise_control_tpu_torch.model.generator import ClusterSpec
    b, r, t, ppt, rf = rung
    return ClusterSpec(num_brokers=b, num_racks=r, num_topics=t,
                       mean_partitions_per_topic=ppt, replication_factor=rf,
                       distribution="exponential", seed=SEED)


def mesh_rank(mesh, rungs):
    """One rank of phase 20's meshes: for each (label, rung) the rung's
    model, replica-sharded over ``mesh``, through ``optimize(mesh=mesh)``
    in bench.py's mesh flavour, with the launch counters set to 0 just
    before; ``verify_run`` on every rank.
    Returns per rung the placement, per-goal rows, wall, collectives,
    gathered bytes, launches and the verification's outcome."""
    import numpy as np
    import torch

    from cruise_control_tpu_torch.analyzer import optimizer as opt
    from cruise_control_tpu_torch.analyzer import proposals as props
    from cruise_control_tpu_torch.analyzer.verifier import verify_run
    from cruise_control_tpu_torch.model.generator import generate_cluster
    from cruise_control_tpu_torch.ops import cuda
    from cruise_control_tpu_torch.parallel import collectives
    from cruise_control_tpu_torch.parallel import mesh as pmesh

    opt._FRONTIER_DENSE_MIN = MESH_DENSE_MIN
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    out = {}
    for label, rung in rungs:
        model = generate_cluster(mesh_spec(rung), pad_replicas_to_multiple=MESH_PAD,
                                 device=mesh.device)
        sharded = pmesh.shard_model_replica_axis(model, mesh)
        c0 = dict(collectives.COUNTERS)
        cuda.reset_launch_counts()
        sync()
        t0 = time.monotonic()
        run = opt.optimize(sharded, STACK, mesh=mesh, device=mesh.device, **MESH_FLAVOUR)
        sync()
        wall = time.monotonic() - t0
        counts = cuda.launch_counts()
        try:
            verify_run(sharded, run, STACK, proposals=props.diff(model, run.model))
            verified = "ok"
        except Exception as e:  # reported to the parent, which decides
            verified = f"{type(e).__name__}: {e}"
        out[label] = {
            "wall_s": wall, "verified": verified,
            "collectives": collectives.COUNTERS["collectives"] - c0["collectives"],
            "gathered_bytes": collectives.COUNTERS["bytes"] - c0["bytes"],
            "launches": {n: counts[n] for n in MESH_PATH_KERNELS},
            "rows": [(g.name, g.steps, g.actions_applied, g.satisfied_after)
                     for g in run.goal_results],
            "placement": {f: getattr(run.model, f).cpu().numpy() for f in PLACEMENT},
            "input": {f: getattr(model, f).cpu().numpy() for f in PLACEMENT},
            "replicas": int(model.replica_valid.sum()), "padded": model.num_replicas_padded,
            "device": str(mesh.device), "backend": mesh.backend, "world": mesh.size,
        }
        del model, sharded, run
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def check_k15(cx):
    """Phase 4's K15 (phase 20's kernel, timed early, where the profiler
    reads device times reliably) against its plain twin on the card, bit
    for bit, on seeded
    partials at ``K15_SHAPES`` (spread magnitudes, negative counts), timed
    beside the plain twin, the profiler's device time and ``torch.sum``
    over the ranks (the library call: f32 and i32 parts)."""
    torch, np, log, dev = cx.torch, cx.np, cx.log, cx.dev
    from cruise_control_tpu_torch.ops import segment
    rng = np.random.default_rng(SEED)
    rows = {}
    for n, b in K15_SHAPES:
        f = (rng.standard_normal((n, b, K15_CF)) * 10.0 ** rng.integers(-3, 7, (n, b, K15_CF))
             ).astype(np.float32)
        i = rng.integers(-(1 << 20), 1 << 20, (n, b, K15_CI)).astype(np.int32)
        fp, ip = (torch.from_numpy(a).to(dev) for a in (f, i))
        got_f, got_i = segment.shard_combine(fp, ip)
        ref_f, ref_i = segment.shard_combine_plain(fp, ip)
        cpu_f, cpu_i = segment.shard_combine_plain(fp.cpu(), ip.cpu())
        exact = (_exact(torch, got_f, ref_f) and _exact(torch, got_i, ref_i)
                 and _exact(torch, got_f.cpu(), cpu_f) and _exact(torch, got_i.cpu(), cpu_i))
        if not exact:
            raise RuntimeError(f"cc_shard_combine differs from its plain twin at n={n}, B={b}")
        nbytes = (n + 1) * b * (K15_CF + K15_CI) * 4
        r = dict(shape=dict(n=n, B=b, Cf=K15_CF, Ci=K15_CI), max_abs_err=0.0,
                 ms=cx.timer(torch, lambda: segment.shard_combine(fp, ip)),
                 plain_ms=cx.timer(torch, lambda: segment.shard_combine_plain(fp, ip)),
                 library_ms=cx.timer(torch, lambda: (torch.sum(fp, 0), torch.sum(ip, 0))),
                 device_ms=None if cx.rehearse else device_ms(
                     torch, lambda: segment.shard_combine(fp, ip), ("shard_combine_kernel",),
                     log),
                 bound_ms=bound_ms(nbytes), bound_by="bytes")
        rows[(n, b)] = r
        log(f"  shard_combine n={n} B={b}: bit for bit with its plain twin (card and CPU); "
            f"kernel {r['ms']:.4f} ms (device {r['device_ms']}), plain {r['plain_ms']:.4f} "
            f"ms, torch.sum {r['library_ms']:.4f} ms, bound {r['bound_ms']:.7f} ms (bytes)")
    return rows


def _same_rows_and_placement(a, b):
    import numpy as np
    same_pl = all(np.array_equal(a["placement"][f], b["placement"][f]) for f in PLACEMENT)
    return same_pl, [r[:3] for r in a["rows"]] == [r[:3] for r in b["rows"]]


def check_mesh(cx):
    """Phase 20: the one-device port solves of the mid and large rungs in bench.py's mesh flavour on the card; the same
    rungs replica-sharded over 2 ranks sharing the card (gloo); the mid
    rung over a one-rank NCCL group.  The 2-rank mid run and the NCCL run
    must place as the one-device run with equal per-goal steps and actions;
    the large run too, or else differ only past a documented near-tie with
    both runs verified and equisatisfying.  Returns (the launches of the
    rank runs, a summary)."""
    torch, np, opt, log, dev = cx.torch, cx.np, cx.opt, cx.log, cx.dev
    from cruise_control_tpu_torch.analyzer import proposals as props
    from cruise_control_tpu_torch.analyzer.verifier import verify_run
    from cruise_control_tpu_torch.model.generator import generate_cluster
    from cruise_control_tpu_torch.parallel import mesh as pmesh
    rungs = (("mid", cx.mid_rung), ("large", cx.large_rung))
    refs = {}
    dense = opt._FRONTIER_DENSE_MIN
    opt._FRONTIER_DENSE_MIN = MESH_DENSE_MIN
    try:
        for label, rung in rungs:
            model = generate_cluster(mesh_spec(rung), pad_replicas_to_multiple=MESH_PAD,
                                     device=dev)
            opt.optimize(model, STACK, device=dev, **MESH_FLAVOUR)  # captures its graphs
            run, wall, _ = cx.timed(lambda: opt.optimize(model, STACK, device=dev,
                                                         **MESH_FLAVOUR))
            verify_run(model, run, STACK, proposals=props.diff(model, run.model))
            refs[label] = {"wall_s": wall, "rows": [
                (g.name, g.steps, g.actions_applied, g.satisfied_after)
                for g in run.goal_results],
                "placement": {f: getattr(run.model, f).cpu().numpy() for f in PLACEMENT},
                "input": {f: getattr(model, f).cpu().numpy() for f in PLACEMENT}}
            log(f"  {label} one device ({model.num_replicas_padded} padded replicas): "
                f"{wall:.3f} s, {sum(r[1] for r in refs[label]['rows'])} steps")
            del model, run
    finally:
        opt._FRONTIER_DENSE_MIN = dense
    device = "cpu" if cx.rehearse else "cuda"
    t0 = time.monotonic()
    two = pmesh.Ranks(mesh_rank, 2, device, "gloo", (rungs,)).join(MESH_TIMEOUT_S)
    two_s = time.monotonic() - t0
    t0 = time.monotonic()
    one = pmesh.Ranks(mesh_rank, 1, device, "gloo" if cx.rehearse else "nccl",
                            ((("mid", cx.mid_rung),),)).join(MESH_TIMEOUT_S)[0]
    one_s = time.monotonic() - t0
    summary = {"spawn_and_run_2_ranks_s": round(two_s, 1),
               "spawn_and_run_nccl_s": round(one_s, 1)}
    counts = {}
    for label, _ in rungs:
        ref = refs[label]
        for rank, res in enumerate(two):
            r = res[label]
            if not all(np.array_equal(r["input"][f], ref["input"][f]) for f in PLACEMENT):
                raise RuntimeError(f"rank {rank} built another {label} model")
            if r["verified"] != "ok":
                raise RuntimeError(f"{label} rank {rank}: verify_run failed: {r['verified']}")
            missing = [n for n, c in r["launches"].items() if c == 0]
            if not cx.rehearse and missing:
                raise RuntimeError(f"{label} rank {rank}: kernels not launched: {missing}")
        a, b = two[0][label], two[1][label]
        if not _same_rows_and_placement(a, b) == (True, True):
            raise RuntimeError(f"the two ranks of the {label} mesh ended apart")
        same_pl, same_rows = _same_rows_and_placement(a, ref)
        first = next((x[0] for x, y in zip(a["rows"], ref["rows"]) if x[:3] != y[:3]), None)
        equisat = [x[3] for x in a["rows"]] == [y[3] for y in ref["rows"]]
        summary[label] = {
            "identical_placement": same_pl, "identical_rows": same_rows,
            "first_goal_apart": first, "equisatisfying": equisat,
            "one_device_s": round(ref["wall_s"], 4),
            "ranks_s": [round(x[label]["wall_s"], 4) for x in two],
            "collectives": [x[label]["collectives"] for x in two],
            "gathered_bytes": [x[label]["gathered_bytes"] for x in two],
            "steps": sum(x[1] for x in a["rows"]), "replicas": a["replicas"]}
        counts[f"{label} 2 ranks"] = a["launches"]
        log(f"  {label} over 2 ranks sharing {a['device']} (gloo): {summary[label]}; "
            f"rank 0 launches {a['launches']}")
        if label == "mid" or cx.rehearse:
            if not (same_pl and same_rows):
                raise RuntimeError(f"the {label} mesh placed apart from one device "
                                   f"(first goal apart: {first})")
        elif not (same_pl and same_rows) and not equisat:
            raise RuntimeError(f"the large mesh is not equisatisfying with one device "
                               f"(first goal apart: {first})")
    nccl = one["mid"]
    same_pl, same_rows = _same_rows_and_placement(nccl, refs["mid"])
    summary["mid_nccl"] = {"backend": nccl["backend"], "identical_placement": same_pl,
                           "identical_rows": same_rows, "rank_s": round(nccl["wall_s"], 4),
                           "collectives": nccl["collectives"],
                           "gathered_bytes": nccl["gathered_bytes"]}
    counts["mid nccl"] = nccl["launches"]
    log(f"  mid over a one-rank {nccl['backend']} group: {summary['mid_nccl']}; launches "
        f"{nccl['launches']}")
    if nccl["verified"] != "ok" or not (same_pl and same_rows):
        raise RuntimeError("the one-rank mid mesh differs from the one-device run")
    if not cx.rehearse and not nccl["launches"]["shard_combine"]:
        raise RuntimeError("the one-rank mid mesh never launched cc_shard_combine")
    return counts, summary


# ---------------------------------------------------------------------------
# Phase 12b: multi-round selection (moves_per_broker_step above 128)
# ---------------------------------------------------------------------------

MULTI_ROUND_MOVES = 256  # two selection rounds of 128 lanes a broker
K4_KERNELS = ("select_mask", "topic_round_sums", "net_viol", "partition_claims")
# The captured inputs of K4 phase 21 holds against the plain twins: the
# default large pipelined warm-up's (round 1; a swap round's claim) and the
# 256 warm-up's (the forms of rounds 2 on, the used sets).
K4_INPUTS = {"large": ("select_mask", "select_mask[topic]", "topic_round_sums", "net_viol",
                       "net_viol[topic]", "partition_claims"),
             "large-256": ("select_mask[cum]", "select_mask[cum,topic]", "topic_round_sums[cum]",
                           "net_viol[cum]", "net_viol[cum,topic]", "partition_claims[used]")}
# The suffix of each form's numbers in the kernels line.
K4_SUFFIX = {"": "", "[topic]": "_topic", "[cum]": "_256", "[cum,topic]": "_256_topic",
             "[used]": "_256"}


def check_multi_round(mx):
    """Phase 12b: the large rung's full stack at ``moves_per_broker_step`` =
    MULTI_ROUND_MOVES on the pipelined and on the sequential per-goal path
    (a warm-up that captures the step graphs and keeps K4's first inputs of
    rounds 2 on, then a timed run with the counters set to 0 just before):
    every hard goal held, ``verify_run`` under that constraint, every K4
    kernel launched (the used sets too), the same placement and per-goal
    steps and actions as the eager driver; then the mid rung's grouped
    solve at the same constraint on the card and on the CPU plain path,
    placed alike.  Returns (summary, counts by path, K4's kept inputs)."""
    torch, opt, log = mx.torch, mx.opt, mx.log
    from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
    from cruise_control_tpu_torch.ops import cuda
    con = dataclasses.replace(BalancingConstraint.default(),
                              moves_per_broker_step=MULTI_ROUND_MOVES)
    summary, counts = {}, {}
    cuda.CAPTURE = {}
    try:
        t0 = time.monotonic()
        mx.fused_run(mx.large, constraint=con)  # captures the pipelined path's graphs
        torch.cuda.synchronize()
        summary["warm_up_s"] = round(time.monotonic() - t0, 2)
    finally:
        kept, cuda.CAPTURE = cuda.CAPTURE, None
    missing = [n for n in K4_INPUTS["large-256"] if n not in kept]
    if missing:
        raise RuntimeError(f"the {MULTI_ROUND_MOVES}-move warm-up kept no inputs of {missing}")
    kept = {n: kept[n] for n in K4_INPUTS["large-256"]}
    rows = lambda run: [(g.steps, g.actions_applied) for g in run.goal_results]  # noqa: E731
    for label, kw, eager in (
            ("pipelined", {}, lambda: drive_pipelined(opt, mx.large, STACK, None, None, con)),
            ("per-goal", mx.per_goal,
             lambda: drive_per_goal(opt, mx.large, STACK, None, None, mx.per_goal, con))):
        if kw:
            mx.fused_run(mx.large, constraint=con, **kw)  # captures what the first did not
        run, wall, _ = mx.timed(lambda: mx.fused_run(mx.large, constraint=con, **kw))
        c = cuda.launch_counts()  # every counter, the modes' too
        mx.check_run(f"large-{MULTI_ROUND_MOVES}-{label}", mx.large, run, STACK, con)
        ref = eager()
        same = mx.same_placement(run, ref) and rows(run) == rows(ref)
        default = mx.default_rows[label]
        summary[label] = dict(
            wall_s=round(wall, 4), steps=sum(g.steps for g in run.goal_results),
            actions=sum(g.actions_applied for g in run.goal_results),
            steps_128=sum(g.steps for g in default.goal_results),
            actions_128=sum(g.actions_applied for g in default.goal_results),
            equal_to_eager=same)
        counts[label] = c
        log(f"large {label} at moves_per_broker_step={MULTI_ROUND_MOVES}: {summary[label]}; "
            f"K4 launches {[(n, c[n]) for n in K4_KERNELS + ('partition_claims[used]',)]}")
        if not same:
            raise RuntimeError(f"the large {label} solve at {MULTI_ROUND_MOVES} moves a step "
                               "placed apart from its eager driver")
        idle = [n for n in K4_KERNELS + ("partition_claims[used]",) if c.get(n, 0) == 0]
        if idle and not mx.rehearse:
            raise RuntimeError(f"the large {label} solve at {MULTI_ROUND_MOVES} moves a step "
                               f"launched no {idle}")
    mid_card = mx.generate_cluster(mx.spec_of(mx.mid_rung), device=mx.dev)
    run_card = mx.fused_run(mid_card, constraint=con)
    t0 = time.monotonic()
    run_cpu = opt.optimize(mx.generate_cluster(mx.spec_of(mx.mid_rung), device="cpu"), STACK,
                           constraint=con, fused=True, raise_on_hard_failure=False,
                           device="cpu")
    cpu_s = time.monotonic() - t0
    mx.check_run(f"mid-{MULTI_ROUND_MOVES}", mid_card, run_card, STACK, con)
    same = mx.same_placement(run_card, run_cpu) and rows(run_card) == rows(run_cpu)
    summary["mid_card_vs_cpu"] = dict(equal=same, cpu_s=round(cpu_s, 1),
                                      steps=sum(g.steps for g in run_card.goal_results))
    log(f"mid at moves_per_broker_step={MULTI_ROUND_MOVES}, card vs CPU plain path: "
        f"{summary['mid_card_vs_cpu']}")
    if not same:
        raise RuntimeError(f"mid at {MULTI_ROUND_MOVES} moves a step: the card and the CPU "
                           "plain path disagree")
    return summary, counts, kept


# ---------------------------------------------------------------------------
# Phase 21: K4 against its plain twins, into canary-guarded buffers
# ---------------------------------------------------------------------------

def _k4_base(name):
    return name.split("[")[0]


def _k4_clone_used(args):
    """partition_claims' arguments with its in-place used sets cloned."""
    keep, p1, p2, P, used, disks = args
    if used is None:
        return args
    return (keep, p1, p2, P, used.clone(),
            None if disks is None else disks[:2] + tuple(d.clone() for d in disks[2:]))


def k4_call(fn, name, args):
    """One call of ``fn`` (a K4 wrapper or its plain twin) on ``args``, as a
    tuple of output tensors: K4b with its cumulative sums written, K4d's used
    sets updated on clones."""
    base = _k4_base(name)
    if base == "topic_round_sums":
        keep, topic, nb, _ = args
        return tuple(fn(keep, topic, nb, True))
    if base == "partition_claims":
        a = _k4_clone_used(args)
        out = fn(*a)
        if a[4] is None:
            return (out,)
        return (a[4],) + (() if a[5] is None else a[5][2:])
    return (fn(*args),)


def k4_cases(torch, name, args):
    """(case, arguments): the captured inputs and seeded edges — no lane
    eligible or kept and every lane, every leg on key 0, every budget +inf,
    every zero delta as -0.0, and for a claim every lane on partition 0."""
    base = _k4_base(name)
    cases = [("main path", args)]

    def negzero(t):
        return torch.where(t == 0, torch.full_like(t, -0.0), t)

    def used_disks(p1, p2):
        """Seeded disk sets of 4 disks a broker: a third of the lanes land
        on a disk, a fifth and a seventh of the disks used."""
        d = 800
        at = torch.arange(d, device=p1.device)
        dest = torch.where(p2 % 3 == 0, (p2 * 7) % d, -1).to(torch.int32)
        return ((p1 % d).to(torch.int32), dest, at % 5 == 0, at % 7 == 0)

    def inf_like(t):
        return torch.full_like(t, float("inf"))

    if base == "select_mask":
        elig, d_src, d_dest, sb, db, room, slack, cum, topic, used, disks = args
        rest = (sb, db, room, slack, cum, topic, used, disks)
        cases.append(("none eligible", (torch.zeros_like(elig), d_src, d_dest) + rest))
        cases.append(("all eligible", (torch.ones_like(elig), d_src, d_dest) + rest))
        cases.append(("-0.0 deltas", (elig, negzero(d_src), negzero(d_dest)) + rest))
        t_inf = None if topic is None else topic[:3] + tuple(inf_like(b) for b in topic[3:6]) \
            + topic[6:]
        cases.append(("+inf budgets", (elig, d_src, d_dest, sb, db, inf_like(room),
                                       inf_like(slack), cum, t_inf, used, disks)))
        if topic is not None:
            t0 = (torch.zeros_like(topic[0]),) + topic[1:]
            cases.append(("legs on key 0", (elig, d_src, d_dest, sb, db, room, slack, cum, t0,
                                            used, disks)))
        if used is not None and disks is None:
            cases.append(("used disks", (elig, d_src, d_dest) + rest[:-1]
                          + (used_disks(used[2], used[3]),)))
    elif base == "topic_round_sums":
        keep, topic, nb, w = args
        cases.append(("none kept", (torch.zeros_like(keep), topic, nb, w)))
        cases.append(("all kept", (torch.ones_like(keep), topic, nb, w)))
        cases.append(("legs on key 0", (keep, (torch.zeros_like(topic[0]),) + topic[1:], nb, w)))
        cases.append(("+inf budgets", (keep, topic[:3] + tuple(inf_like(b) for b in topic[3:6])
                                       + topic[6:], nb, w)))
        cases.append(("-0.0 deltas", (keep, topic[:1] + (negzero(topic[1]), negzero(topic[2]))
                                      + topic[3:], nb, w)))
    elif base == "net_viol":
        cum, rn, room, slack, bad = args
        cases.append(("+inf budgets", (cum, rn, inf_like(room), inf_like(slack), bad)))
        cases.append(("-0.0 sums", (cum, negzero(rn), room, slack, bad)))
        if bad is not None:
            cases.append(("every broker bad", (cum, rn, room, slack, torch.ones_like(bad))))
    else:
        keep, p1, p2, P, used, disks = args
        cases.append(("none kept", (torch.zeros_like(keep), p1, p2, P, used, disks)))
        cases.append(("all kept", (torch.ones_like(keep), p1, p2, P, used, disks)))
        cases.append(("partition 0", (keep, torch.zeros_like(p1), p2, P, used, disks)))
        if used is not None and disks is None:
            cases.append(("used disks", (keep, p1, p2, P, used,
                                         used_disks(p1, p2))))
    return cases


def guarded_k4(torch, cuda, name, args):
    """One launch of a K4 kernel through its C entry into outputs (and K4b's
    counts, K4d's claim flags) that each lie between canary bands, the used
    sets copied in first; raises if a band changed or the outputs differ from
    the wrapper's."""
    from cruise_control_tpu_torch.ops import selection as sel
    base = _k4_base(name)
    dev = args[0].device if args[0] is not None else args[1].device

    def u8(view, n):
        return view.view(torch.uint8)[:n]

    if base == "select_mask":
        elig, d_src, d_dest, sb, db, room, slack, cum, topic, used, disks = args
        k, nb = elig.shape[0], room.shape[0]
        buf, guard, views = canary_views(torch, dev, [-(-k // 4)])
        legs = n_tb = parts = nd = 0
        if topic is not None:
            legs, n_tb = topic[0].shape[0], topic[3].shape[0]
        if used is not None:
            parts = used[1].shape[0]
        if disks is not None:
            nd = disks[2].shape[0]
        out = u8(views[0], k)
        cuda.launch("select_mask", k, nb, legs, n_tb, parts, nd, elig, d_src, d_dest, sb, db,
                    room, slack, cum, *(topic or (None,) * 8), *(used or (None,) * 4),
                    *(disks or (None,) * 4), out)
        got = (out.view(torch.bool),)
    elif base == "topic_round_sums":
        keep, topic, nb, _ = args
        k, legs, n_tb = keep.shape[0], topic[0].shape[0], topic[3].shape[0]
        buf, guard, views = canary_views(torch, dev, [2 * n_tb, -(-n_tb // 4), -(-nb // 4),
                                                      n_tb, n_tb])
        vt, bad = u8(views[1], n_tb), u8(views[2], nb)
        rep, lead = views[3].view(torch.float32), views[4].view(torch.float32)
        cuda.launch("topic_round_sums", k, legs, n_tb, nb, keep, *topic, views[0], vt, bad,
                    rep, lead)
        got = (vt.view(torch.bool), bad.view(torch.bool), rep, lead)
    elif base == "net_viol":
        cum, rn, room, slack, bad = args
        nb = rn.shape[0]
        buf, guard, views = canary_views(torch, dev, [-(-nb // 4)])
        out = u8(views[0], nb)
        cuda.launch("net_viol", nb, cum, rn, room, slack, bad, out)
        got = (out.view(torch.bool),)
    else:
        keep, p1, p2, P, used, disks = args
        k = keep.shape[0]
        nd = 0 if disks is None else disks[2].shape[0]
        sizes = [-(-P // 4)] + ([-(-k // 4)] if used is None else []) + \
            ([-(-nd // 4)] * 2 if disks is not None else [])
        buf, guard, views = canary_views(torch, dev, sizes)
        claims = u8(views[0], P)
        if used is None:
            out = u8(views[1], k)
            cuda.launch("partition_claims", k, P, 0, keep, p1, p2, claims, out,
                        None, None, None, None)
            got = (out.view(torch.bool),)
        else:
            claims.copy_(used.view(torch.uint8))
            dsets = ()
            if disks is not None:
                dsets = (u8(views[1], nd), u8(views[2], nd))
                dsets[0].copy_(disks[2].view(torch.uint8))
                dsets[1].copy_(disks[3].view(torch.uint8))
            cuda.launch("partition_claims", k, P, nd, keep, p1, p2, claims, None,
                        *(disks[:2] if disks is not None else (None, None)),
                        *(dsets or (None, None)))
            got = (claims.view(torch.bool),) + tuple(d.view(torch.bool) for d in dsets)
    torch.cuda.synchronize()
    if not bool((buf[guard] == CANARY).all()):
        raise RuntimeError(f"{name}: a launch wrote outside its buffers")
    wrapper = getattr(sel, base)
    if not _exact(torch, got, k4_call(wrapper, name, args)):
        raise RuntimeError(f"{name}: the guarded launch differs from the wrapper's")


def _k4_bytes(name, args):
    """Bytes K4's function must move on these inputs: each input read once
    where this run's lanes need it (a lane's deltas and indices when it is
    eligible, a leg's key and deltas when its lane is kept), each output
    written once."""
    base = _k4_base(name)
    if base == "select_mask":
        elig, d_src, d_dest, sb, db, room, slack, cum, topic, used, disks = args
        k, nb, n = elig.shape[0], room.shape[0], int(elig.sum())
        total = k + n * 72 + nb * 64 + (0 if cum is None else nb * 32) + k
        if topic is not None:
            legs, n_tb = topic[0].shape[0], topic[3].shape[0]
            total += n * legs * 12 + n_tb * (12 + (8 if topic[6] is not None else 0))
        if used is not None:
            total += k + used[1].shape[0] + n * 8
        if disks is not None:
            total += n * 8 + 2 * disks[2].shape[0]
        return total
    if base == "topic_round_sums":
        keep, topic, nb, _ = args
        n_tb, legs, kept = topic[3].shape[0], topic[0].shape[0], int(keep.sum())
        cum = topic[6] is not None
        return (keep.shape[0] + kept * legs * 12 + n_tb * (12 + (8 if cum else 0))
                + n_tb + nb + 8 * n_tb)
    if base == "net_viol":
        cum, rn, room, slack, bad = args
        nb = rn.shape[0]
        return nb * (96 + (32 if cum is not None else 0) + (1 if bad is not None else 0)) + nb
    keep, p1, p2, P, used, disks = args
    k, kept = keep.shape[0], int(keep.sum())
    if used is None:
        return k + kept * 8 + k
    total = k + kept * 8 + P
    if disks is not None:
        total += kept * 8 + 2 * disks[2].shape[0]
    return total


def _k4_library(torch, name, args):
    """One PyTorch call computing (a part of) the same function, or None:
    K4b's (topic, broker) sums as one ``index_add_`` of both columns (what
    the kernel replaced); K4d's scatter as one ``scatter_reduce_``."""
    base = _k4_base(name)
    if base == "topic_round_sums":
        keep, topic, _, _ = args
        keys = torch.where(keep[None, :], topic[0], 0).reshape(-1)
        vals = torch.where(keep[None, :, None], torch.stack([topic[1], topic[2]], -1),
                           0.0).reshape(-1, 2)
        acc = torch.zeros((topic[3].shape[0], 2), device=keep.device)
        return lambda: acc.zero_().index_add_(0, keys, vals)
    if base == "partition_claims":
        keep, p1, _, P, _, _ = args
        idx = torch.where(keep, p1, 0).long()
        src = keep.to(torch.int32)
        acc = torch.zeros((P,), dtype=torch.int32, device=keep.device)
        return lambda: acc.zero_().scatter_reduce_(0, idx, src, "amax")
    return None


def _k4_shape(name, args):
    base = _k4_base(name)
    if base == "select_mask":
        topic = args[8]
        return dict(K=args[0].shape[0], nb=args[5].shape[0],
                    L=None if topic is None else topic[0].shape[0],
                    n_tb=None if topic is None else topic[3].shape[0],
                    P=None if args[9] is None else args[9][1].shape[0])
    if base == "topic_round_sums":
        return dict(K=args[0].shape[0], L=args[1][0].shape[0], n_tb=args[1][3].shape[0],
                    nb=args[2])
    if base == "net_viol":
        return dict(nb=args[1].shape[0], cum=args[0] is not None, topic=args[4] is not None)
    return dict(K=args[0].shape[0], P=args[3], mode="claim" if args[4] is None else "used",
                D=None if args[5] is None else args[5][2].shape[0])


def check_k4(torch, np, log, timer, inputs, rehearse):
    """K4a-K4d (``ops/selection.py``, ``csrc/selection.cu``) on the inputs
    the large pipelined warm-ups gave them — at the default configuration
    (phase 3: round 1, a swap round's claim) and at ``moves_per_broker_step``
    = MULTI_ROUND_MOVES (phase 12b: the cumulative forms, the used sets) —
    and on the seeded edges of ``k4_cases``: bit for bit against the plain
    twin on the card and on CPU copies, identical over two launches and a
    graph replay, through ``guarded_k4``; timed as one call (event ms)
    beside the plain twin on the card, the bound, and the one PyTorch call
    of ``_k4_library``.  Returns {kernel: row}: the default configuration's
    numbers, the 256 run's with the suffix ``_256``."""
    from cruise_control_tpu_torch.ops import cuda
    from cruise_control_tpu_torch.ops import selection as sel

    def cpu(x):
        return _clone(torch, x, "cpu")

    rows = {}
    for label, names in K4_INPUTS.items():
        for name in names:
            base = _k4_base(name)
            args = inputs[label][name]
            kernel, plain = getattr(sel, base), getattr(sel, f"{base}_plain")
            for case, a in k4_cases(torch, name, args):
                got = k4_call(kernel, name, a)
                if not _exact(torch, got, k4_call(kernel, name, a)):
                    raise RuntimeError(f"{name} ({case}) differs between two launches")
                if not _exact(torch, got, k4_call(plain, name, a)):
                    raise RuntimeError(f"{name} ({case}) differs from its plain twin")
                if not _exact(torch, got, k4_call(plain, name, cpu(a))):
                    raise RuntimeError(f"{name} ({case}) differs from its plain twin on the "
                                       "CPU")
                if not rehearse:
                    guarded_k4(torch, cuda, name, a)
            fn = lambda: k4_call(kernel, name, args)  # noqa: E731
            if not rehearse and not _graph_replay_equal(torch, fn):
                raise RuntimeError(f"{name}: a graph replay differs from the eager launch")
            library = _k4_library(torch, name, args)
            r = {"shape": _k4_shape(name, args), "ms": timer(torch, fn),
                 "plain_ms": timer(torch, lambda: k4_call(plain, name, args)),
                 "bound_ms": bound_ms(_k4_bytes(name, args)),
                 "library_ms": None if library is None else timer(torch, library),
                 "max_abs_err": 0.0, "cases": len(k4_cases(torch, name, args))}
            suffix = K4_SUFFIX[name[len(base):]]
            rows.setdefault(base, {}).update({f"{k}{suffix}": v for k, v in r.items()})
            log(f"{name} at {label} {r['shape']}: bit for bit with its plain twin on the card "
                f"and the CPU in {r['cases']} cases, identical over two launches"
                f"{'' if rehearse else ', a graph replay and into canary-guarded buffers'}; "
                f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']}, "
                f"bound {r['bound_ms']:.6f})")
    return rows


# ---------------------------------------------------------------------------
# Phase 21: K4e and K6's top-k, group rank and argsorts against their plain
# twins
# ---------------------------------------------------------------------------

NEW_KERNELS = ("top_k", "select_legs", "frontier_budgets", "group_rank", "argsort",
               "row_argsort")
# The form of each kernel whose numbers head its row in the kernels line:
# the large pipelined warm-up's compaction, compacted leg build, frontier
# budgets (with (topic, broker) budgets), broker ranks, K3's score sort and
# the builders' row sorts.
NEW_PRIMARY = {"top_k": "top_k[mask]", "select_legs": "select_legs[compact]",
               "frontier_budgets": "frontier_budgets[frontier,topic]",
               "group_rank": "group_rank[broker]", "argsort": "argsort[score]",
               "row_argsort": "row_argsort[rows]"}


def new_kernel_inputs(kept):
    """The first inputs of each recorded form of K4e, K6 top-k and group
    rank in ``kept`` (a capture dict)."""
    return {n: a for n, a in kept.items() if n.split("[")[0] in NEW_KERNELS}


def new_call(torch, name, args, plain=False):
    """One call of a new kernel's wrapper (or, with ``plain``, its plain
    twin) on recorded ``args``, as a flat tuple of output tensors (None
    where an output is absent)."""
    from cruise_control_tpu_torch.analyzer.actions import Candidates
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.ops import order
    from cruise_control_tpu_torch.ops import selection as sel
    base = name.split("[")[0]
    if base == "argsort":  # (keys, num_keys, mode); the launch counts no mode
        x, num_keys, _ = args
        return ((order.argsort_plain if plain else order.argsort)(x, num_keys=num_keys),)
    if base == "row_argsort":
        return ((order.argsort_plain if plain else order.argsort)(args[0], dim=1),)
    if base == "top_k":
        if len(args) == 2:
            return tuple((order.top_k_plain if plain else order.top_k)(*args))
        x, mask, k = args
        if not plain:
            return tuple(order.masked_top_k(x, mask, k))
        vals, idx = order.top_k_plain(torch.where(mask, x, -float("inf")), k)
        return vals, idx, mask.sum(dtype=torch.int32)
    if base == "select_legs":
        cand = Candidates(*args[0])
        return tuple((sel.select_legs_plain if plain else sel.select_legs)(cand, *args[1:]))
    if base == "frontier_budgets":
        out = (sel.frontier_budgets_plain if plain else sel.frontier_budgets)(*args)
        return out[:3] + (out[3] or (None,) * 3) + out[4:]
    group, key, num_groups, form = args
    if plain:
        return (gk.within_group_rank_plain(group, key),)
    return (gk._within_group_rank(group, key, num_groups, form),)


def _new_shape(name, args):
    base = name.split("[")[0]
    if base in ("argsort", "row_argsort"):
        from cruise_control_tpu_torch.ops import order
        x, num_keys, mode = args
        return dict(shape=list(x.shape), dtype=str(x.dtype).split(".")[-1], num_keys=num_keys,
                    passes=order.argsort_passes(num_keys), mode=mode)
    if base == "top_k":
        return dict(n=args[0].shape[0], k=args[-1], dtype=str(args[0].dtype).split(".")[-1],
                    mask=len(args) == 3)
    if base == "select_legs":
        return dict(K=args[2].shape[0], kc=args[2].shape[0] if args[1] is None
                    else args[1].shape[0], nb=args[8], L=args[10],
                    frontier=args[5] is not None)
    if base == "frontier_budgets":
        return dict(B=args[0].shape[0], nb=args[0].shape[0] if args[2] is None
                    else args[2].shape[0], T=args[4] if args[3] is not None else None)
    return dict(N=args[0].shape[0], S=args[2], form=args[3])


def _new_bytes(torch, name, args):
    """Bytes the function must move on these inputs: each input read once
    where the lanes or rows need it (a gathered table's entries once each),
    each distinct output written once (not the layouts' copies: K4e's
    score copies, third slot and delta rows and (rep, lead) columns, and
    ``hi_tb``'s copy of ``gain_rep`` beside a constant)."""
    base = name.split("[")[0]
    if base in ("argsort", "row_argsort"):  # the keys read, the int64 indices written
        return args[0].numel() * 12
    if base == "top_k":
        n, k = args[0].shape[0], args[-1]
        return n * 4 + (n + 4 if len(args) == 3 else 0) + k * 8
    if base == "select_legs":
        from cruise_control_tpu_torch.analyzer.actions import Candidates
        from cruise_control_tpu_torch.ops import selection as sel
        cand = Candidates(*args[0])
        sel_idx, score, c_of_f, legs = args[1], args[2], args[5], args[10]
        k_full = score.shape[0]
        idx = (torch.arange(k_full, device=score.device) if sel_idx is None
               else sel_idx.long().clamp(0, k_full - 1))
        kc = idx.shape[0]
        # score, eligible, lane; src, dest, partitions, disks; the 8 delta
        # channels' 4 + 4 + 5 fields.
        per_in = 4 + 1 + 4 + 6 * 4 + 32 + 20 + (4 if sel_idx is not None else 0)
        # scores, eligible, 4 int fields, 2 slots, 2 lanes, 2 x 8 deltas.
        per_out = 4 + 1 + 16 + 8 + 8 + 64
        tables = 0
        if c_of_f is not None:
            brokers = torch.cat([cand.src[idx], cand.dest[idx]]).long()
            tables += 4 * int(torch.unique(brokers.clamp(0, c_of_f.shape[0] - 1)).numel())
        if legs:
            num_r = args[6].shape[0]
            per_in += 8 if legs == 2 else 12  # action_type, replica, dest_replica
            # leg keys, rep, lead, non-zero flag, K2 key
            per_out += legs * 17
            at = cand.action_type[idx]
            r1 = cand.replica[idx].long().clamp(0, num_r - 1)
            reps, leads = [r1], [r1[(at == sel.ACTION_MOVE) | (at == sel.ACTION_SWAP)]]
            if legs == 4:
                r2 = cand.dest_replica[idx].long().clamp(0, num_r - 1)
                reps.append(r2)
                leads.append(r2[at == sel.ACTION_SWAP])
            # replica_topic's and replica_is_leader's entries the lanes need
            tables += 4 * int(torch.unique(torch.cat(reps)).numel()) + \
                int(torch.unique(torch.cat(leads)).numel())
        return kc * (per_in + per_out) + tables
    if base == "frontier_budgets":
        nb = args[0].shape[0] if args[2] is None else args[2].shape[0]
        t_nb = args[4] * nb if args[3] is not None else 0
        return nb * 64 + t_nb * 12 + nb * 96 + t_nb * 20 + (nb * 4 if args[2] is not None else 0)
    return args[0].shape[0] * 12


def _new_library(torch, name, args):
    """One PyTorch call computing the same function, or None: ``torch.topk``
    (ties in no given order) for the top-k; ``torch.sort`` of the (group,
    key, row) order and ``cummax`` for the group rank; the stable
    ``torch.sort`` of the keys (along dim 1 for the rows) for the argsorts."""
    base = name.split("[")[0]
    if base == "argsort":
        return lambda: torch.sort(args[0], stable=True)
    if base == "row_argsort":
        return lambda: torch.sort(args[0], dim=1, stable=True)
    if base == "top_k":
        x = args[0] if len(args) == 2 else torch.where(args[1], args[0], -float("inf"))
        return lambda: torch.topk(x, args[-1])
    if base == "group_rank":
        group, key = args[0], args[1]
        bits = (key + 0.0).view(torch.int32).long()
        okey = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # value order
        composite = group.long() * 2 ** 33 + (2 ** 32 - 1 - (okey + 2 ** 31))
        starts = torch.arange(group.shape[0], device=group.device)
        return lambda: (torch.sort(composite, stable=True), torch.cummax(starts, 0))
    return None


def new_kernels_device_ms(torch, inputs, log):
    """Device ms a call of each recorded form at mid and large (every device
    op of a call, ``device_ms_total``): {(rung, form): ms}."""
    out = {}
    for label, kept in inputs.items():
        for name, args in kept.items():
            out[(label, name)] = device_ms_total(torch, lambda: new_call(torch, name, args),
                                                 log)
    log(f"K4e, K6 top-k and group rank device ms a call: "
        f"{ {f'{a} {b}': None if v is None else round(v, 5) for (a, b), v in out.items()} }")
    return out


def top_k_edges(torch, np, dev):
    """Seeded top-k cases at the main path's shapes and on the edges."""
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    big = np.float32(1e30)
    x = (rng.integers(1, 40, 65536) / 4).astype(np.float32)
    zeros = rng.choice(np.array([0.0, -0.0, 1.0, -big], np.float32), 65536)
    src = np.where(rng.random(100371) < 0.3, rng.standard_normal(100371), -big)
    xl = np.where(rng.random(250863) < 0.2, rng.standard_normal(250863), -big)
    ints = rng.integers(-2 ** 31, 2 ** 31 - 1, 9000, dtype=np.int64).astype(np.int32)
    ints[:64] = np.iinfo(np.int32).min
    return [
        ("compaction 65,536 -> 32,768", (t(x), t(rng.random(65536) < 0.5), 32768)),
        ("compaction, live below k", (t(x), t(rng.random(65536) < 0.1), 32768)),
        ("compaction 65,536 -> 4,096", (t(x), t(rng.random(65536) < 0.5), 4096)),
        ("k = n = 65,536, masked", (t(x), t(rng.random(65536) < 0.5), 65536)),
        ("+0.0 / -0.0 / -big ties, masked", (t(zeros), t(rng.random(65536) < 0.7), 32768)),
        ("sources 100,371 -> 800", (t(src.astype(np.float32)), 800)),
        ("sources 250,863 -> 2,048", (t(xl.astype(np.float32)), 2048)),
        ("matched 250,863 -> 32,768", (t(xl.astype(np.float32)), 32768)),
        ("k = n = 7,000 int32 (room order)", (t(rng.integers(0, 60, 7000).astype(np.int32)),
                                              7000)),
        ("k = n = 200 int32", (t(rng.integers(-2, 9, 200).astype(np.int32)), 200)),
        ("int32 with INT32_MIN ties", (t(ints), 3000)),
        ("k = 1, n = 4,097", (t(rng.standard_normal(4097).astype(np.float32)), 1)),
        ("every key equal", (t(np.full(10001, 2.5, np.float32)), 3000)),
        ("every key -inf", (t(np.full(5000, -np.inf, np.float32)), 4097)),
    ]


def group_rank_edges(torch, np, dev):
    """Seeded group-rank cases: the large rung's broker shape with a skewed
    broker, one group of 20,000 rows, 40,000 pair groups over the xl250
    rows, single-row groups, every key equal, signed-zero and -big ties."""
    rng = np.random.default_rng(SEED + 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    big = np.float32(1e30)
    r = 100371
    skew = np.where(rng.random(r) < 0.1, 7, rng.integers(0, 200, r)).astype(np.int32)
    load = np.where(rng.random(r) < 0.4, rng.gamma(2.0, 1.0, r), -big).astype(np.float32)
    return [
        ("skewed: a tenth of 100,371 rows on one of 200 brokers", (t(skew), t(load), 200)),
        ("one group of 20,000 rows", (t(np.zeros(20000, np.int32)),
                                      t((rng.integers(0, 40, 20000) / 2).astype(np.float32)), 1)),
        ("40,000 pair groups over 250,863 rows",
         (t(rng.integers(0, 40000, 250863).astype(np.int32)),
          t(np.where(rng.random(250863) < 0.5, 1.0, -big).astype(np.float32)), 40000)),
        ("single-row groups", (t(rng.permutation(10000).astype(np.int32)),
                               t(rng.standard_normal(10000).astype(np.float32)), 10000)),
        ("every key equal", (t(rng.integers(0, 50, 10233).astype(np.int32)),
                             t(np.full(10233, 3.0, np.float32)), 50)),
        ("+0.0 / -0.0 / -big ties", (t(rng.integers(0, 50, 10233).astype(np.int32)),
                                     t(rng.choice(np.array([0.0, -0.0, 1.0, -big],
                                                           np.float32), 10233)), 50)),
    ]


def argsort_edges(torch, np, dev):
    """Seeded argsort cases: (keys, num_keys, None) at the main path's
    shapes and on the edges: n = 0, 1, 2,048, 2,049, 4,096 and 4,097, every
    key equal, keys at ``num_keys - 1`` (the invalid rows' key), +0.0 /
    -0.0, +inf / -inf and NaN of both signs, K3's regroup of the designated
    cuts' 20,000 (topic, broker) keys and the xl250 pair keys."""
    rng = np.random.default_rng(SEED + 2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def floats(n):
        x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 3.0], np.float32), n)
        nan = rng.random(n) < 0.05
        x[nan] = np.float32(np.nan)
        x.view(np.uint32)[nan & (rng.random(n) < 0.5)] |= np.uint32(0x80000000)
        return x

    def brokers(n):
        return rng.integers(0, 201, n).astype(np.int32)

    r = 100371
    invalid = np.where(rng.random(r) < 0.3, 200, rng.integers(0, 200, r)).astype(np.int32)
    pairs = np.where(rng.random(r) < 0.2, 20000, rng.integers(0, 20000, r)).astype(np.int32)
    ints = rng.integers(-2 ** 31, 2 ** 31 - 1, 9000, dtype=np.int64).astype(np.int32)
    ints[:64] = np.iinfo(np.int32).min
    cases = [(f"n = {n:,}", (t(brokers(n)), 201, None)) for n in (0, 1, 2048, 2049, 4096,
                                                                 4097)]
    return cases + [
        ("every key equal", (t(np.full(10000, 7, np.int32)), 201, None)),
        ("every key -0.0 / +0.0", (t(rng.choice(np.array([0.0, -0.0], np.float32), 3000)),
                                   None, None)),
        ("brokers 100,371, invalid rows at num_keys - 1", (t(invalid), 201, None)),
        ("pairs 100,371, invalid rows at num_keys - 1", (t(pairs), 20001, None)),
        ("xl250 pairs 250,863", (t(rng.integers(0, 200001, 250863).astype(np.int32)), 200001,
                                 None)),
        ("K3 regroup above 4,096 segments: 20,000 keys", (t(rng.integers(
            0, 20001, 51200).astype(np.int32)), 20001, None)),
        ("score 65,536: signed zeros, infinities, NaN of both signs", (t(floats(65536)), None,
                                                                       None)),
        ("score 1,500, one block", (t(floats(1500)), None, None)),
        ("int32 without a range, INT32_MIN ties", (t(ints), None, None)),
    ]


def row_argsort_edges(torch, np, dev):
    """Seeded row-sort cases (int32 [T, B], as the builders pass -donor_cap,
    -deficit and -spare): the large shape, rows all equal, the xl250 [200,
    1,000] shape, rows above 2,048 (two ``cc_argsort`` launches)."""
    rng = np.random.default_rng(SEED + 3)

    def t(a):
        return (torch.from_numpy(np.ascontiguousarray(a)).to(dev), None, None)

    return [("large [100, 200]", t(-rng.integers(0, 4, (100, 200)).astype(np.int32))),
            ("rows all equal [100, 200]", t(np.zeros((100, 200), np.int32))),
            ("xl250 [200, 1,000]", t(-rng.integers(0, 6, (200, 1000)).astype(np.int32))),
            ("above 2,048 a row [3, 2,500]", t(rng.integers(-50, 50, (3, 2500))
                                                .astype(np.int32)))]


def k4e_edges(torch, name, args):
    """Seeded variants of a recorded K4e input: every zero delta negated to
    -0.0 on the src rows, no compaction, no frontier, 0, 2 and 4 legs (leg
    build); +inf budgets, zero slack and no frontier (budgets)."""
    if name.startswith("select_legs"):
        cand_f, sel_idx, score, elig, lane, c_of_f, rt, rl, nb, sub, legs = args
        from cruise_control_tpu_torch.analyzer.actions import Candidates
        cand = Candidates(*cand_f)
        zero = dataclasses.replace(
            cand, delta_src=torch.zeros_like(cand.delta_src),
            delta_dest=torch.zeros_like(cand.delta_dest),
            d_replica_count=torch.zeros_like(cand.d_replica_count),
            d_leader_count=torch.zeros_like(cand.d_leader_count),
            d_potential_nw_out=torch.zeros_like(cand.d_potential_nw_out),
            d_leader_bytes_in_src=torch.zeros_like(cand.d_leader_bytes_in_src),
            d_leader_bytes_in_dest=torch.zeros_like(cand.d_leader_bytes_in_dest))
        zero_f = tuple(getattr(zero, f.name) for f in dataclasses.fields(zero))
        rest = (score, elig, lane)
        cases = [("zero deltas (-0.0 src rows)", (zero_f, sel_idx) + rest + args[5:]),
                 ("no compaction", (cand_f, None) + rest + args[5:]),
                 ("no frontier", (cand_f, sel_idx) + rest + (None,) + args[6:])]
        cases += [(f"{n} legs", args[:10] + (n,)) for n in (0, 2, 4) if n != legs]
        return cases
    room, slack, foc, topic, num_t = args
    inf = torch.full_like(room, float("inf"))
    cases = [("+inf budgets", (inf, inf, foc, topic, num_t)),
             ("zero slack (-0.0)", (room, torch.zeros_like(slack), foc, topic, num_t)),
             ("no frontier", (room, slack, None, topic, num_t))]
    if topic is not None:
        cases.append(("+inf topic budgets", (room, slack, foc,
                                            tuple(torch.full_like(b, float("inf"))
                                                  for b in topic), num_t)))
    return cases


def _even(n):
    return n + (n & 1)


def guarded_new(torch, cuda, name, args):
    """One launch of a new kernel through its C entry into outputs (and
    scratch) that each lie between canary bands; raises if a band changed or
    the outputs differ from the wrapper's."""
    from cruise_control_tpu_torch.analyzer.actions import Candidates
    from cruise_control_tpu_torch.ops import order
    from cruise_control_tpu_torch.ops import selection as sel
    base = name.split("[")[0]
    dev = (args[0] if base != "select_legs" else args[2]).device
    if base == "row_argsort" and args[0].shape[1] > order._RADIX_SMALL:
        # Above 2,048 a row the wrapper's first launch: cc_argsort of every key.
        name, base, args = "argsort", "argsort", (args[0].reshape(-1), None, None)
    if base == "argsort":
        x, num_keys = args[0], args[1]
        n, words = x.shape[0], order.argsort_work_words(x.shape[0])
        buf, guard, views = canary_views(torch, dev, [_even(2 * n), _even(max(words, 2))])
        out = views[0][:2 * n].view(torch.int64)
        cuda.launch("argsort", n, order.argsort_passes(num_keys), order.key_kind(x, num_keys), x,
                    out, None, None, views[1][:words] if words else None, words)
        got = (out,)
    elif base == "row_argsort":
        x = args[0]
        T, B = x.shape
        buf, guard, views = canary_views(torch, dev, [_even(2 * T * B)])
        out = views[0][:2 * T * B].view(torch.int64).view(T, B)
        cuda.launch("row_argsort", T, B, x, out)
        got = (out,)
    elif base == "top_k":
        x, k = args[0], args[-1]
        mask = args[1] if len(args) == 3 else None
        n, words = x.shape[0], order._top_k_work_words(x.shape[0], k)
        buf, guard, views = canary_views(torch, dev, [_even(k), _even(k), 2, _even(max(words, 2))])
        vals = views[0][:k].view(x.dtype)
        idx, live = views[1][:k], views[2][:1].view(())
        cuda.launch("top_k", n, k, int(x.dtype == torch.int32), x, mask, vals, idx,
                    live if mask is not None else None, views[3][:words] if words else None,
                    words)
        got = (vals, idx) + ((live,) if mask is not None else ())
    elif base == "group_rank":
        group, key, num_groups = args[:3]
        n = group.shape[0]
        words = 3 * n + 2 * (num_groups + 1) + 1
        buf, guard, views = canary_views(torch, dev, [_even(n), _even(words)])
        out = views[0][:n]
        cuda.launch("group_rank", n, num_groups, group, key, out, views[1][:words], words)
        got = (out,)
    elif base == "select_legs":
        cand = Candidates(*args[0])
        sel_idx, score, elig, lane, c_of_f, rt, rl, nb, sub, legs = args[1:]
        k_full = score.shape[0]
        kc = k_full if sel_idx is None else sel_idx.shape[0]
        # The outputs' shapes, as the wrapper lays them out.
        shapes = [(t.shape, t.dtype) for t in new_call(torch, name, args) if t is not None]
        numels = [int(torch.Size(sh).numel()) for sh, _ in shapes]
        sizes = [_even(-(-m // 4) if dt == torch.bool else m)
                 for m, (_, dt) in zip(numels, shapes)]
        buf, guard, views = canary_views(torch, dev, sizes)
        outs = []
        for v, m, (sh, dt) in zip(views, numels, shapes):
            outs.append(v.view(torch.uint8)[:m].view(torch.bool).view(sh) if dt == torch.bool
                        else v[:m].view(dt).view(sh))
        outs += [None] * (16 - len(outs))
        fields = [getattr(cand, f).contiguous() for f, _, _ in sel._LEG_FIELDS]
        cuda.launch("select_legs", kc, k_full, nb, sub, legs,
                    0 if c_of_f is None else c_of_f.shape[0], rt.shape[0], sel_idx, score, elig,
                    lane, *fields, c_of_f, rt if legs else None, rl if legs else None, *outs)
        got = tuple(outs)
    else:
        room, slack, foc, topic, num_t = args
        nb_full = room.shape[0]
        nb = nb_full if foc is None else foc.shape[0]
        t_nb = num_t * nb if topic is not None else 0
        sizes = [_even(nb * 8)] * 3 + ([_even(t_nb)] * 3 + [_even(2 * t_nb)] * 2
                                       if topic is not None else [])
        buf, guard, views = canary_views(torch, dev, sizes)
        f32 = [v.view(torch.float32) for v in views]
        b3 = tuple(f32[i][:nb * 8].view(nb, 8) for i in range(3))
        t3 = tuple(f32[3 + i][:t_nb] for i in range(3)) if topic is not None else (None,) * 3
        hl = tuple(f32[6 + i][:2 * t_nb].view(t_nb, 2) for i in range(2)) \
            if topic is not None else (None, None)
        cuda.launch("frontier_budgets", nb, nb_full, num_t, room, slack, foc,
                    *(topic or (None,) * 3), *b3, *t3, *hl)
        got = b3 + t3 + hl
    torch.cuda.synchronize()
    if not bool((buf[guard] == CANARY).all()):
        raise RuntimeError(f"{name}: a launch wrote outside its buffers")
    if not _exact(torch, got, new_call(torch, name, args)):
        raise RuntimeError(f"{name}: the guarded launch differs from the wrapper's")


def check_new_kernels(torch, np, log, timer, inputs, device, dev, rehearse):
    """K4e (``select_legs``, ``frontier_budgets``), K6's top-k, group rank
    and argsorts (``argsort``, ``row_argsort``) on the inputs the mid and
    large warm-ups gave each of their forms (phase 3), on seeded variants of
    them (``k4e_edges``) and on seeded cases at the main path's shapes and
    edges (``top_k_edges``, ``group_rank_edges``, ``argsort_edges``,
    ``row_argsort_edges``; an empty input is held, not timed):
    bit for bit against the plain twin on the card and on CPU copies,
    identical over two launches and (the recorded forms and the seeded
    cases) a graph replay, through ``guarded_new``; the recorded forms and
    the seeded cases timed as one call (event ms) beside the plain twin, the
    bound and one PyTorch call (``_new_library``), with their device ms a
    call from phase 4.  Returns {kernel: row}: the numbers of its form in
    ``NEW_PRIMARY`` at large, every other form's under ``forms``."""
    from cruise_control_tpu_torch.ops import cuda

    def cpu(x):
        return _clone(torch, x, "cpu")

    def hold(name, label, args, timed):
        got = new_call(torch, name, args)
        if not _exact(torch, got, new_call(torch, name, args)):
            raise RuntimeError(f"{name} ({label}) differs between two launches")
        if not _exact(torch, got, new_call(torch, name, args, plain=True)):
            raise RuntimeError(f"{name} ({label}) differs from its plain twin")
        if not _exact(torch, got, new_call(torch, name, cpu(args), plain=True)):
            raise RuntimeError(f"{name} ({label}) differs from its plain twin on the CPU")
        if not rehearse:
            guarded_new(torch, cuda, name, args)
            if timed and not _graph_replay_equal(torch, lambda: new_call(torch, name, args)):
                raise RuntimeError(f"{name} ({label}): a graph replay differs from the eager "
                                   "launch")
        if not timed:
            return None
        library = _new_library(torch, name, args)
        return {"shape": _new_shape(name, args),
                "ms": timer(torch, lambda: new_call(torch, name, args)),
                "plain_ms": timer(torch, lambda: new_call(torch, name, args, plain=True)),
                "bound_ms": bound_ms(_new_bytes(torch, name, args)),
                "library_ms": None if library is None else timer(torch, library),
                "max_abs_err": 0.0}

    forms, checked = {}, 0
    how = "" if rehearse else ", over two launches, a graph replay and into canary-guarded " \
        "buffers"
    for label, kept in inputs.items():
        for name, args in sorted(kept.items()):
            r = hold(name, f"{label} warm-up", args, True)
            r["device_ms"] = device.get((label, name))
            forms[(label, name)] = r
            checked += 1
            if name.startswith(("select_legs", "frontier_budgets")):
                for case, a in k4e_edges(torch, name, args):
                    hold(name, f"{label} {case}", a, False)
                    checked += 1
            log(f"{name} at {label} {r['shape']}: bit for bit with its plain twin on the card "
                f"and the CPU{how}; "
                f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library {r['library_ms']}, "
                f"bound {r['bound_ms']:.6f}, device a call {r['device_ms']})")
    for name, cases in (("top_k[seeded]", top_k_edges(torch, np, dev)),
                        ("group_rank[seeded]", group_rank_edges(torch, np, dev)),
                        ("argsort[seeded]", argsort_edges(torch, np, dev)),
                        ("row_argsort[seeded]", row_argsort_edges(torch, np, dev))):
        for case, args in cases:
            if name.startswith("group_rank"):
                args = args + ("seeded",)
            checked += 1
            if args[0].numel() == 0:  # nothing to launch, time or replay
                hold(name, case, args, False)
                log(f"{name} {case}: bit for bit (empty)")
                continue
            r = hold(name, case, args, True)
            forms[("seeded", f"{name} {case}")] = r
            log(f"{name} {case} {r['shape']}: bit for bit; {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound {r['bound_ms']:.6f})")
    rows = {}
    for base in NEW_KERNELS:
        mine = {k: v for k, v in forms.items() if k[1].split("[")[0] == base}
        if not mine:
            raise RuntimeError(f"no recorded or seeded input of {base}")
        primary = ("large", NEW_PRIMARY[base])
        head = mine.get(primary) or mine.get(("large", base)) or next(iter(mine.values()))
        rows[base] = dict(head, cases_checked=checked, forms={
            f"{a} {b}": {k: v for k, v in r.items() if k != "max_abs_err"}
            for (a, b), r in mine.items()})
    log(f"K4e, K6 top-k, group rank and argsorts: {checked} cases bit for bit")
    return rows


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
