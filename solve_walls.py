#!/usr/bin/env python3
"""Walls of the port's main solves, to compare two checkouts in one call.

    python3 solve_walls.py [--repo DIR] [--runs N] [--label NAME]

Imports ``cruise_control_tpu_torch`` from DIR (default: this checkout) and,
on one GPU, solves chip_smoke.py's mid, large and xl250 rungs (seed 2026)
with the full 15-goal stack as the service calls it,
``optimize(fused=True, donate_model=True)``: per rung a warm-up run that
captures the step graphs, then N timed runs (default 3; each wall printed,
the median kept), and for mid and large one more run under
``torch.profiler``: the device's busy share of the median wall, and each
kernel's device ms a launch (chip_smoke.py's ``profile_mid``).  Prints the
card's name and power limit, and last one JSON object.  To compare two
checkouts, unpack the other one (``git archive``) into a directory and run
this script for each in turns within one call: A, B, B, A.
"""

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
    from cruise_control_tpu_torch.analyzer import optimizer as opt_mod
    from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
    from cruise_control_tpu_torch.ops import cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{label}: {smi}", flush=True)
    cuda.build_all()
    out = {"label": label, "card": smi}
    for name, rung, profiled in (("mid", cs.MID, True), ("large", cs.LARGE, True),
                                 ("xl250", cs.XL250, False)):
        b, r, t, ppt, rf = rung
        model = generate_cluster(ClusterSpec(num_brokers=b, num_racks=r, num_topics=t,
                                             mean_partitions_per_topic=ppt,
                                             replication_factor=rf, distribution="exponential",
                                             seed=cs.SEED), device="cuda")

        def solve():
            return opt_mod.optimize(model, cs.STACK, fused=True, donate_model=True,
                                    raise_on_hard_failure=False, device="cuda")
        t0 = time.monotonic()
        solve()
        torch.cuda.synchronize()
        warm = time.monotonic() - t0
        walls = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            run = solve()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        wall = statistics.median(walls)
        steps = sum(g.steps for g in run.goal_results)
        row = {"warm_up_s": warm, "walls_s": walls, "wall_s": wall, "steps": steps}
        if profiled:
            prof = cs.profile_mid(torch, solve, wall, steps, f"{label} {name}", print)
            family = ("broker_aggregates", "segment_sum", "segment_row_index")
            row.update(busy=prof["busy"], device_ms=prof["device_ms"],
                       device_ms_per_launch={k: prof["per_launch"].get(k) for k in family},
                       device_ms_total={k: prof["totals"].get(k) for k in family})
        out[name] = row
        print(f"{label} {name}: {json.dumps(row)}", flush=True)
        del model, run
    print(json.dumps({"solve_walls": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
