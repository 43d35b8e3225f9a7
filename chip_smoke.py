#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cruise_control_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA device and the CUDA toolkit (``nvcc``); it fails at once without them.

Phases, in order (any failure raises and the process exits non-zero):

1. print the device name and ``nvidia-smi``'s name and power limit;
2. build the four kernels from ``cruise_control_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. mid rung (50 brokers, 10 racks, 40 topics, ~10.2k replicas, seed 2026),
   full 15-goal stack, warm-up run; each kernel's inputs at its first
   launch are captured;
4. each kernel against its plain PyTorch version on the card, on seeded
   fixtures and on the captured inputs, with timings (CUDA events, median
   of 20) and the least time the card could take for the same bytes;
5. mid rung, timed run with the launch counters set to 0 just before:
   every hard goal satisfied, ``verify_run`` passes, every kernel launched;
   then one more mid run under ``torch.profiler`` for the device's busy
   share and the device ops per step;
6. large rung (200 brokers, ~100k replicas), the first 7 goals, the same
   checks;
7. a 12-broker cluster and the mid rung solved on the card and on the CPU
   plain path: per goal the same satisfied flags;
8. the ``kernels`` JSON line, the ``nvidia-smi`` line, and last the result
   line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --rehearse-cpu`` runs the same phases on the CPU
with the plain PyTorch versions at small sizes, without building, timing on
the card or checking launch counts (the plain path launches no kernel), to
find faults in this script without a GPU.  It prints no result line and
exits with 3.
"""

from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
TIMED_RUNS = 20

# Device kernel names of each wrapper, as the profiler reports them.
PROFILE_NAMES = {
    "broker_aggregates": ("broker_aggregates_kernel",),
    "best_per_segment": ("segment_max_key", "segment_winner"),
    "prefix_cut": ("prefix_cut_kernel",),
    "apply_actions": ("apply_actions_kernel",),
}

KERNELS = {
    # name: (source, JAX function it replaces)
    "broker_aggregates": ("cruise_control_tpu_torch/csrc/broker_aggregates.cu",
                          "cruise_control_tpu/ops/segment.py:22"),
    "best_per_segment": ("cruise_control_tpu_torch/csrc/best_per_segment.cu",
                         "cruise_control_tpu/analyzer/optimizer.py:210"),
    "prefix_cut": ("cruise_control_tpu_torch/csrc/prefix_cut.cu",
                   "cruise_control_tpu/analyzer/goals/kernels.py:1031"),
    "apply_actions": ("cruise_control_tpu_torch/csrc/apply_actions.cu",
                      "cruise_control_tpu/analyzer/actions.py:233"),
}


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

    from cruise_control_tpu_torch.analyzer import optimizer as opt
    from cruise_control_tpu_torch.analyzer import proposals as props
    from cruise_control_tpu_torch.analyzer.actions import apply_candidates
    from cruise_control_tpu_torch.analyzer.goals import kernels as gk
    from cruise_control_tpu_torch.analyzer.verifier import verify_run
    from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
    from cruise_control_tpu_torch.ops import cuda
    from cruise_control_tpu_torch.ops.segment import broker_aggregates

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wrappers = {"broker_aggregates": broker_aggregates,
                "best_per_segment": opt._best_per_segment,
                "prefix_cut": gk.prefix_cut_admit,
                "apply_actions": apply_candidates}
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

    def spec_of(rung):
        b, r, t, ppt, rf = rung
        return ClusterSpec(num_brokers=b, num_racks=r, num_topics=t,
                           mean_partitions_per_topic=ppt, replication_factor=rf,
                           distribution="exponential", seed=SEED)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def read_counts():
        return {n: w.launches for n, w in wrappers.items()}

    def check_run(label, initial, run, goals):
        for g in run.goal_results:
            log(f"  {label} {g.name:38s} steps={g.steps:3d} actions={g.actions_applied:5d} "
                f"satisfied {g.satisfied_before}->{g.satisfied_after} "
                f"{g.duration_s:.3f}s")
        bad = [g.name for g in run.goal_results if g.is_hard and not g.satisfied_after]
        if bad:
            raise RuntimeError(f"{label}: hard goals unsatisfied: {bad}")
        proposals = props.diff(initial, run.model)
        verify_run(initial, run, goals, proposals=proposals)
        return proposals

    # 3. mid rung warm-up, capturing each kernel's first inputs
    mid = generate_cluster(spec_of(mid_rung), device=dev)
    log(f"mid rung: {int(mid.replica_valid.sum())} replicas, {mid.num_brokers} brokers, "
        f"{mid.num_partitions} partitions")
    cuda.CAPTURE = {}
    t0 = time.monotonic()
    run_warm = opt.optimize(mid, STACK, raise_on_hard_failure=False, device=dev)
    torch.cuda.synchronize()
    log(f"mid warm-up run: {time.monotonic() - t0:.2f} s")
    captured, cuda.CAPTURE = cuda.CAPTURE, None
    missing = [n for n in wrappers if n not in captured]
    if missing:
        raise RuntimeError(f"kernels never launched in the warm-up run: {missing}")
    warm_props = check_run("mid-warm", mid, run_warm, STACK)

    # 4. kernels against their plain versions
    results = check_kernels(torch, np, dev, captured, wrappers, log, timer)

    # 5. mid rung, timed and counted
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run_mid = opt.optimize(mid, STACK, raise_on_hard_failure=False, device=dev)
    torch.cuda.synchronize()
    mid_wall = time.monotonic() - t0
    mid_counts = read_counts()
    mid_props = check_run("mid", mid, run_mid, STACK)
    mid_steps = sum(g.steps for g in run_mid.goal_results)
    log(f"mid timed run: {mid_wall:.3f} s wall, {mid_steps} steps, "
        f"{len(mid_props)} proposals, identical to warm-up: {mid_props == warm_props}")
    log(f"mid launches: {mid_counts}")
    if not rehearse and min(mid_counts.values()) == 0:
        raise RuntimeError(f"a kernel was not launched on the mid path: {mid_counts}")
    device_ms = (profile_mid(torch, opt, mid, mid_wall, mid_steps, log) if not rehearse
                 else {n: None for n in wrappers})

    # 6. large rung, first 7 goals
    large = generate_cluster(spec_of(large_rung), device=dev)
    log(f"large rung: {int(large.replica_valid.sum())} replicas, {large.num_brokers} brokers")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    run_large = opt.optimize(large, LARGE_GOALS, raise_on_hard_failure=False,
                             device=dev)
    torch.cuda.synchronize()
    large_wall = time.monotonic() - t0
    large_counts = read_counts()
    large_props = check_run("large", large, run_large, LARGE_GOALS)
    log(f"large run: {large_wall:.3f} s wall, "
        f"{sum(g.steps for g in run_large.goal_results)} steps, "
        f"{len(large_props)} proposals")
    log(f"large launches: {large_counts}")
    if not rehearse and min(large_counts.values()) == 0:
        raise RuntimeError(f"a kernel was not launched on the large path: {large_counts}")

    # 7. the card against the CPU plain path: a 12-broker cluster and the mid rung
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
        same_place = bool(torch.equal(run_card.model.replica_broker.cpu(),
                                      run_cpu.model.replica_broker))
        log(f"{label} card vs CPU plain path: equisatisfying {flags_card == flags_cpu}, "
            f"identical placement {same_place}")
        if flags_card != flags_cpu:
            raise RuntimeError(f"{label}: card and CPU disagree per goal: "
                               f"{flags_card} vs {flags_cpu}")

    # 8. results
    log(f"summary: mid wall {mid_wall:.3f} s ({mid_steps} steps, "
        f"{mid_wall / max(mid_steps, 1) * 1e3:.1f} ms/step), large wall "
        f"{large_wall:.3f} s; card {smi}")
    line = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": mid_counts[name],
                     "launches_large": large_counts[name],
                     "launches_per_mid_step": mid_counts[name] / max(mid_steps, 1),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms_per_launch": device_ms[name],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": r["library_ms"]})
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


def profile_mid(torch, opt, mid, mid_wall, mid_steps, log):
    """One more mid run under ``torch.profiler``: device kernel time, kernel
    launches per step and the device's busy share of the unprofiled wall,
    with the device ops that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        opt.optimize(mid, STACK, raise_on_hard_failure=False)
        torch.cuda.synchronize()
        prof_wall = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    log(f"profile: {len(kernels)} device ops ({len(kernels) / max(mid_steps, 1):.0f} per "
        f"step), {device_ms:.1f} ms device time; busy share {device_ms / 1e3 / mid_wall:.3f} "
        f"of the unprofiled {mid_wall:.3f} s wall ({prof_wall:.3f} s under the profiler)")
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
        log(f"  {wrapper}: device ms per launch {per_launch[wrapper]}")
    return per_launch


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
    from cruise_control_tpu_torch.ops.segment import broker_aggregates_plain

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
        bound_ms=bound_ms(R * 38 + B * 32))
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
        library_ms=None, bound_ms=bound_ms(K * (9 + 4 * C) + S * 12 * C + K))
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
        library_ms=None, bound_ms=bound_ms(Kc * 29 + Bm * 4 + 2 * Rm * 9))
    log(f"K7 apply_actions: K={Kc} R={Rm} ok (exact)")
    for name, r in out.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.6f} ms")
    return out


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
