#!/usr/bin/env python3
"""Do profiled CUDA-graph replays survive CUPTI's teardown between
``torch.profiler`` sessions, and does the answer depend on which kernels
the graphs hold?

    python3 cupti_graph_check.py [--parent DIR] [--rounds N]
    python3 cupti_graph_check.py --one OPS [--repo DIR] [--rounds N]
    python3 cupti_graph_check.py --smoke DIR [--stop PHASE] [--graphs N]

With ``--one`` a single process (one GPU) captures a graph of OPS, then
runs N rounds (default 30): capture a new graph of OPS, destroy the graph
of two rounds before, and replay every live graph, and run OPS eagerly,
inside one ``torch.profiler`` session; it prints ``round k`` after each.
OPS is ``family`` (K1 and the round sums of ``cruise_control_tpu_torch.
ops.segment``, each call its row index and walk, at the 200-broker rung's
shapes: R = 100,371 replicas on B = 200 brokers, 2 x 32,768 lanes of 8
columns) or ``library`` (``index_add_`` and a stable ``torch.sort`` of
the same rows: no kernel of the port).

Without ``--one`` it runs, each in a child process: both OPS with the
profiler's default (CUPTI torn down after each session), both with
``TEARDOWN_CUPTI=0 DISABLE_CUPTI_LAZY_REINIT=1`` (the settings torch
applies for its own CUDA graphs, and chip_smoke.py's), and with
``--parent DIR`` the family OPS of another checkout (``git archive`` of
the parent commit unpacked there) with the default.  It prints one line
per child and last one JSON object: each variant's exit code (-11 is a
segmentation fault) and the rounds it finished.  It exits 0 when every
child ran; the exit codes are the finding.

With ``--smoke`` it runs DIR's chip_smoke.py (any checkout, the parent's
too) up to the start of phase PHASE (default: the one after phase 9's
profiled pipelined solve), capturing, replaying and destroying N graphs of
``index_add_`` and ``torch.sort`` (no kernel of the port) before each of
its profiler sessions; it exits 0 on reaching PHASE, and a crash shows as
the process's own exit code (139 from a shell: a segmentation fault).
"""

import json
import os
import subprocess
import sys
import time

SEED = 2026
R, B, LANES, C = 100_371, 200, 2 * 32_768, 8
CALLS = 4  # calls of OPS in one graph
WORKAROUND = {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}


def one(ops: str, repo: str, rounds: int) -> int:
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    broker = t(rng.integers(0, B, R).astype(np.int32))
    valid, lead = t(rng.random(R) < 0.95), t(rng.random(R) < 0.33)
    ll = t(rng.exponential(100.0, (R, 4)).astype(np.float32))
    lf = t(rng.exponential(100.0, (R, 4)).astype(np.float32))
    values = t(rng.normal(0.0, 50.0, (LANES, C)).astype(np.float32))
    lane_seg = t(rng.integers(0, B, LANES).astype(np.int32))
    lane_mask = t(rng.random(LANES) < 0.5)
    if ops == "family":
        from cruise_control_tpu_torch.ops import segment as sg

        def call():
            sg.broker_aggregates(broker, valid, lead, ll, lf, B)
            sg.segment_sum(values, lane_seg, lane_mask, B)
    else:
        rows = torch.where(valid[:, None], ll, 0.0)
        keys = torch.where(valid, broker, B)
        ids = torch.where(lane_mask, lane_seg, 0).long()
        lanes = torch.where(lane_mask[:, None], values, 0.0)
        acc, acc_s = torch.zeros((B, 4), device=dev), torch.zeros((B, C), device=dev)

        def call():
            acc.zero_().index_add_(0, broker.long(), rows)
            torch.sort(keys, stable=True)
            acc_s.zero_().index_add_(0, ids, lanes)

    def capture():
        call()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(CALLS):
                call()
        g.replay()
        return g

    live = {-1: capture()}
    for k in range(rounds):
        live[k] = capture()
        live.pop(k - 2, None)  # destroyed
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for g in live.values():
                for _ in range(3):
                    g.replay()
            call()
            torch.cuda.synchronize()
        print(f"round {k}", flush=True)
    return 0


def matrix(parent, rounds: int) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    variants = [("family", here, "default"), ("library", here, "default")]
    if parent:
        variants.append(("family", os.path.abspath(parent), "default"))
    variants += [("family", here, "kept"), ("library", here, "kept")]
    out = []
    for ops, repo, cupti in variants:
        env = {k: v for k, v in os.environ.items() if k not in WORKAROUND}
        if cupti == "kept":
            env.update(WORKAROUND)
        t0 = time.monotonic()
        try:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", ops,
                                "--repo", repo, "--rounds", str(rounds)], env=env,
                               capture_output=True, text=True, timeout=180)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = "timeout", e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        done = sum(line.startswith("round ") for line in stdout.splitlines())
        row = {"ops": ops, "tree": "parent" if repo != here else "this", "cupti": cupti,
               "rc": rc, "rounds_done": done, "rounds": rounds,
               "s": round(time.monotonic() - t0, 1)}
        out.append(row)
        print(json.dumps(row), flush=True)
        if rc != 0:
            print("\n".join(stderr.splitlines()[-12:]), flush=True)
    print(json.dumps({"cupti_graph_check": out}), flush=True)
    return 0


def smoke(repo: str, stop: str, graphs: int) -> int:
    """``repo``'s chip_smoke.py run to the start of phase ``stop``, with
    ``graphs`` CUDA graphs of ``index_add_`` and a stable ``torch.sort``
    (20 calls each, the 200-broker rung's shapes: no kernel of the port)
    captured, replayed and destroyed before each of its profiler sessions
    (``profile_mid``), as the K1-family checks' timing graphs are."""
    for k, v in WORKAROUND.items():
        os.environ.setdefault(k, v)
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    profile_mid, log = cs.profile_mid, cs.log

    def captures_then_profile(torch, *args, **kw):
        import numpy as np
        rng = np.random.default_rng(SEED)
        keys = torch.from_numpy(rng.integers(0, B, R).astype(np.int32)).cuda()
        rows = torch.from_numpy(rng.random((R, 4)).astype(np.float32)).cuda()
        acc = torch.zeros((B, 4), device="cuda")
        ids = keys.long()
        calls = (lambda: acc.zero_().index_add_(0, ids, rows),
                 lambda: torch.sort(keys, stable=True))
        for i in range(graphs):
            fn = calls[i % 2]
            fn()
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(20):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            del g
        print(f"cupti_graph_check: {graphs} library graphs captured and destroyed",
              flush=True)
        return profile_mid(torch, *args, **kw)

    def log_until(msg):
        log(msg)
        if msg.startswith(f"--- {stop} "):
            print(f"cupti_graph_check: reached {stop}", flush=True)
            os._exit(0)
    cs.profile_mid, cs.log = captures_then_profile, log_until
    return cs.main([])


def main(argv) -> int:
    def opt(name, default):
        return argv[argv.index(name) + 1] if name in argv else default
    rounds = int(opt("--rounds", 30))
    if "--smoke" in argv:
        return smoke(os.path.abspath(opt("--smoke", ".")), opt("--stop", "small pipelined"),
                     int(opt("--graphs", 10)))
    if "--one" in argv:
        return one(opt("--one", "family"), opt("--repo", os.path.dirname(
            os.path.abspath(__file__))), rounds)
    return matrix(opt("--parent", None), rounds)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
