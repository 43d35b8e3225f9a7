#!/usr/bin/env python3
"""Walls of the port's main solves, to compare two checkouts in one call.

    python3 solve_walls.py [--repo DIR] [--runs N] [--label NAME]

Imports ``cruise_control_tpu_torch`` from DIR (default: this checkout) and,
on one GPU, solves chip_smoke.py's mid, large and xl250 rungs (seed 2026)
with the full 15-goal stack as the service calls it,
``optimize(fused=True, donate_model=True)``, and the mid rung once more on
the per-goal path (``pipeline=False, fuse_group_size=1``): per solve a
warm-up run that captures the step graphs, then N timed runs (default 3;
each wall printed, the median kept; the last run's proposals and a digest
of its placement, to hold two checkouts' placements equal), and one more
run under
``torch.profiler``: the device's busy share of the median wall, and the
device ms a launch and in all of K1, ``segment_sum``, the row index, K3
(by its kernels before and after its redesign), the ordered sum, K9's
sweep, frontier mask and batch, K4's four kernels, K6's top-k and
argsorts, torch's ``index_add_`` and every sort kernel (chip_smoke.py's
``profile_mid``); then K3, the ordered sum and K9's three calls on the
large warm-up's first inputs (K9's also on chip_smoke.py's 7,000-broker
fleet): device ms a call, one call between two events and a call in a
replayed graph, and the ordered sum at the band
averages' shapes beside ``torch.sum`` (chip_smoke.py's
``check_ordered_sum``).  For K8, each solve's replays and gated-off
replays (the openers' too), and at mid and large one step graph replayed
with its step gated off (chip_smoke.py's ``gated_off_replay``: event ms,
the device ops a replay runs and their device ms, and on a tree whose
graphs keep the body torch captured, that body replayed without its
gate); and K8's flight row at the service's shape (device ms a call and
event ms).  Every solve's walls and the gated-off replays' event ms are
taken before the first profiler session of the process, the profiles
after.  Prints the
card's name and power limit, and last one JSON object.  To compare two
checkouts, unpack the other one (``git archive``) into a directory and run
this script for each in turns within one call: A, B, B, A.
"""

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

# The profiler's sessions replay CUDA graphs: keep CUPTI set up between
# them (see chip_smoke.py's main).
os.environ.setdefault("TEARDOWN_CUPTI", "0")
os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")


# torch's index_add_ kernels (the topic budgets' scatter-adds before K4b).
INDEX_ADD = ("indexFunc",)
# K3's device kernels before its redesign: the cut and the ordered
# cumsum's three launches.
PREFIX_CUT_BEFORE = ("prefix_cut_kernel", "scan_blocks_kernel", "block_totals_kernel",
                     "add_back_kernel")


def main(argv) -> int:
    def opt(name, default):
        return argv[argv.index(name) + 1] if name in argv else default
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.abspath(opt("--repo", here))
    runs, label = int(opt("--runs", 3)), opt("--label", repo)
    sys.path.insert(0, repo)
    import torch
    if not torch.cuda.is_available():
        print("solve_walls: no CUDA device", file=sys.stderr)
        return 1
    # This checkout's chip_smoke.py (rungs, stack, profile), whichever
    # checkout is measured.
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from cruise_control_tpu_torch.analyzer import graphs
    from cruise_control_tpu_torch.analyzer import optimizer as opt_mod
    from cruise_control_tpu_torch.analyzer import proposals as props
    from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
    from cruise_control_tpu_torch.ops import cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{label}: {smi}", flush=True)
    cuda.build_all()
    out = {"label": label, "card": smi}
    # Walls first, every solve's, with no profiler session in the process
    # yet: a session leaves CUPTI set up (TEARDOWN_CUPTI=0), which adds host
    # time to every later graph launch.  Then each solve under the profiler.
    solves = {}
    for name, rung, kw in (("mid", cs.MID, {}), ("large", cs.LARGE, {}), ("xl250", cs.XL250, {}),
                           ("mid per-goal", cs.MID, dict(pipeline=False, fuse_group_size=1))):
        b, r, t, ppt, rf = rung
        model = generate_cluster(ClusterSpec(num_brokers=b, num_racks=r, num_topics=t,
                                             mean_partitions_per_topic=ppt,
                                             replication_factor=rf, distribution="exponential",
                                             seed=cs.SEED), device="cuda")

        def solve(model=model, kw=kw):
            return opt_mod.optimize(model, cs.STACK, fused=True, donate_model=True,
                                    raise_on_hard_failure=False, device="cuda", **kw)
        t0 = time.monotonic()
        if name == "large":  # K3's and the ordered sum's first inputs
            cuda.CAPTURE = {}
        solve()
        torch.cuda.synchronize()
        warm = time.monotonic() - t0
        if name == "large":
            kept, cuda.CAPTURE = cuda.CAPTURE, None
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            run = solve()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        wall = statistics.median(walls)
        steps = sum(g.steps for g in run.goal_results)
        placement = hashlib.sha256(b"".join(getattr(run.model, f).cpu().numpy().tobytes()
                                            for f in cs.PLACEMENT)).hexdigest()[:16]
        row = {"warm_up_s": warm, "walls_s": walls, "wall_s": wall, "steps": steps,
               "proposals": len(props.diff(model, run.model)), "placement_sha256": placement}
        # K8: the run's replays and gated-off replays, and one step graph
        # replayed gated off (mid: the graph chip_smoke.py's check_graphs
        # times; large: a distribution goal's dense graph), its event ms here.
        tot = cs.pipeline_report(run, lambda _: None, name)
        row.update(replays=tot["replays"], gated_off=tot["gated_off"],
                   opener_replays=tot["opener_replays"],
                   opener_gated_off=tot["opener_gated_off"])
        goal = None
        if name in ("mid", "large"):
            goal = ("TopicReplicaDistributionGoal" if name == "mid"
                    else cs.band_goal_graphed(graphs, model))
            row["gated_off_replay"] = cs.gated_off_replay(
                torch, graphs, model, goal, print, f"{label} {name}", strict=False,
                profiled=False)
        out[name] = row
        solves[name] = (model, solve, goal)
        del run
    for name, (model, solve, goal) in solves.items():
        row = out[name]
        # K3 by its kernels before and after its redesign (one tree has one
        # set), and every sort kernel of the solve ("ort": in "sort" and
        # "Sort" alike).
        names = dict(cs.PROFILE_NAMES, prefix_cut_before=PREFIX_CUT_BEFORE, sorts=("ort",),
                     index_add=INDEX_ADD)
        prof = cs.profile_mid(torch, solve, row["wall_s"], row["steps"], f"{label} {name}",
                              print, names)
        family = ("broker_aggregates", "segment_sum", "segment_row_index", "prefix_cut",
                  "prefix_cut_before", "ordered_sum", "stack_sweep", "frontier_active",
                  "frontier_active_batch", "sorts", "select_mask", "topic_round_sums",
                  "net_viol", "partition_claims", "index_add", "top_k", "argsort",
                  "row_argsort")
        row.update(busy=prof["busy"], device_ms=prof["device_ms"],
                   device_ms_per_launch={k: prof["per_launch"].get(k) for k in family},
                   device_ms_total={k: prof["totals"].get(k) for k in family})
        if goal is not None:  # the gated-off replay's device ops and device ms
            row["gated_off_replay_profiled"] = cs.gated_off_replay(
                torch, graphs, model, goal, print, f"{label} {name}", strict=False)
        print(f"{label} {name}: {json.dumps(row)}", flush=True)
    del solves
    # K3, the ordered sum and K9 on the large warm-up's first inputs: device
    # ms a call (every device op), one call between two events, a call in a
    # replayed graph, last (no profiler session after a graph of this
    # script's own: chip_smoke.py's docstring, phase 21).
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.ops import order
    calls = {"prefix_cut": lambda: gk.prefix_cut_admit(*kept["prefix_cut"]),
             "ordered_sum": lambda: order.ordered_sum(*kept["ordered_sum"])}
    k9 = cs.k9_args(gk, *cs._clone(torch, kept["stack_sweep"][1:3]))
    calls.update({n: fn for n, (fn, _) in cs.k9_calls(gk, k9).items()})
    # K9 at the detector fleet's 7,000 brokers (chip_smoke.py's FLEET).
    from cruise_control_tpu_torch.analyzer.state import BrokerArrays
    b, r, t, ppt, rf = cs.FLEET
    fleet = generate_cluster(ClusterSpec(num_brokers=b, num_racks=r, num_topics=t,
                                         mean_partitions_per_topic=ppt, replication_factor=rf,
                                         distribution="exponential", seed=cs.SEED), device="cuda")
    k9_fleet = cs.k9_args(gk, fleet, BrokerArrays.from_model(fleet))
    calls.update({f"{n}_fleet": fn for n, (fn, _) in cs.k9_calls(gk, k9_fleet).items()})
    out["kernels"] = {n: {"device_ms_call": cs.device_ms_total(torch, fn, print)}
                      for n, fn in calls.items()}
    # K8's flight row at the service shape (chip_smoke.py's SERVICE_SHAPES),
    # its step active: device ms a call by its kernels, and one call's event
    # ms.
    from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N, CTR_STEPS,
                                                         CTR_WIDTH, FLIGHT_WIDTH)
    import numpy as np
    fs = cs.SERVICE_SHAPES["flight_row"]
    keep, score, elig, fmask = cs.flight_fixture(torch, np, "cuda", fs["K"], 0.01, 0.3,
                                                 fs["B"], (0, 0, 0),
                                                 np.random.default_rng(cs.SEED))
    ctr = torch.zeros((CTR_WIDTH,), dtype=torch.int32, device="cuda")
    ctr[CTR_STEPS], ctr[CTR_LAST_N], ctr[CTR_BUDGET] = 5, 1, 32
    buf = torch.zeros((32, FLIGHT_WIDTH), dtype=torch.int32, device="cuda")
    one = torch.ones((), dtype=torch.int32, device="cuda")

    def flight_row():
        opt_mod.flight_row(ctr, keep, fs["offsets"], fs["kinds"], score, elig, fmask, one,
                           one, 12, buf)
    out["kernels"]["flight_row"] = dict(
        device_ms=cs.device_ms(torch, flight_row, cs.FLIGHT_ROW_KERNELS, print),
        device_ms_call=cs.device_ms_total(torch, flight_row, print))
    out["kernels"]["flight_row"]["ms"] = cs.time_ms(torch, flight_row)
    for n, fn in calls.items():
        out["kernels"][n].update(ms=cs.time_ms(torch, fn), graph_ms=cs.graph_ms(torch, fn))
    # The ordered sum at the band averages' shapes, beside torch.sum.
    import numpy as np
    out["kernels"].update(cs.check_ordered_sum(torch, np, print, cs.time_ms,
                                               kept["ordered_sum"][0], False))
    print(f"{label} kernels: {json.dumps(out['kernels'])}", flush=True)
    print(json.dumps({"solve_walls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
