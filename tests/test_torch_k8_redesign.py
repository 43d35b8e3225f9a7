"""K8 as the card runs it: the gated step split into its gate and its body
(``state.step_active``, ``optimizer._step_body``), and K8's flight rows
over the grid (``csrc/flight_row.cu``), on the CPU.

- The step graph replays the gate, then the body under an IF node on it
  (``analyzer/graphs.py``, ``csrc/step_graph.cu``): a gated-off replay runs
  no body.  Emulated here on seeded 6-broker states — the body run only
  when the gate is on — and held bit for bit against the eager gated step
  (``_gated_step``: gate and body, the body run with the gate off too): with
  the gate on, off by ``last_n = 0`` and off by ``steps == budget``, with
  the flight recorder off and on.  The eager gated step itself is held
  against the JAX package by tests/test_torch_fused_*.py and
  tests/test_torch_pergoal_*.py, so no JAX program is compiled here.
- The flight row's two launches are walked in numpy (``_flight_walk``):
  every lane goes to its thread by the grid-strided groups of 16 from the
  first co-aligned lane, the head and tail lane by lane, each group's batch
  counts as popcounts of its kept bits over the batch's range, each block's
  partial row, then their reduction.  Held against ``flight_row_plain`` on
  K not a multiple of 16, a batch boundary inside a group, empty batches,
  1 and 8 batches, no eligible lane, no frontier mask, misaligned bases,
  a tie of -0 and +0 as the maximum (+0 wins), NaN scores of each sign and
  the service's K = 102,400 cut.  The kernel's constants are read from its
  source.
- The graph cache credits a replayed graph's body launches once for each
  step its gate let run, when the counts are read and before it drops the
  graph (eviction, ``clear``), and then keeps nothing of it alive.

Tolerance: exact (placement, counters, every slot of the row).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer import candidates as tc
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import (CTR_BUDGET, CTR_LAST_N, CTR_STEPS,
                                                     CTR_WIDTH, FLIGHT_WIDTH, BrokerArrays,
                                                     OptimizationOptions, StepState,
                                                     step_active)
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from tests.torch_port_helpers import PLACEMENT, SPEC_6

CSRC = Path(topt.__file__).resolve().parents[1] / "csrc"
GOAL, PREV = "ReplicaDistributionGoal", ("RackAwareGoal",)


def _kernel_constant(name: str) -> int:
    src = (CSRC / "flight_row.cu").read_text()
    return int(re.search(rf"\b{name} = (\d+)", src).group(1))


# ---------------------------------------------------------------------------
# The gate and the body
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def six():
    tm = generate_cluster(ClusterSpec(**SPEC_6), device="cpu")
    con = BalancingConstraint.default()
    spec, prev = GOAL_SPECS[GOAL], tuple(GOAL_SPECS[g] for g in PREV)
    inv = topt.compute_step_invariants(spec, prev, tm, BrokerArrays.from_model(tm), con)
    return tm, inv, (spec, prev, con, tc.default_num_sources(tm), tc.default_num_dests(tm))


def _state(tm, counters):
    st = StepState.working(tm, OptimizationOptions.none(tm))
    st.counters.copy_(torch.tensor(counters, dtype=torch.int32))
    return st


def _snapshot(st, flight_cap):
    out = [getattr(st.model, f).clone() for f in PLACEMENT] + [st.counters.clone()]
    if flight_cap:
        out.append(st.flight_buffer(flight_cap).clone())
    return out


# (steps, total, last_n, repair, depth, lanes, budget)
GATES = {"on": [2, 5, 3, 0, 1, 7, 8],
         "off_last_n": [2, 5, 0, 0, 1, 7, 8],
         "off_budget": [8, 5, 3, 0, 1, 7, 8]}


@pytest.mark.parametrize("flight_cap", [0, 4])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_gated_replay_equals_eager_gated_step(six, gate, flight_cap):
    tm, inv, (spec, prev, con, ns, nd) = six
    eager, graph = _state(tm, GATES[gate]), _state(tm, GATES[gate])
    if flight_cap:
        for st in (eager, graph):
            st.flight_buffer(flight_cap).fill_(99)
    before = _snapshot(graph, flight_cap)
    topt._gated_step(eager, inv, spec, prev, con, ns, nd, flight_cap=flight_cap)
    active = step_active(graph.counters)
    assert bool(active) == (gate == "on")
    if bool(active):  # the IF node: the body runs only under its gate
        topt._step_body(graph, inv, active, spec, prev, con, ns, nd, flight_cap=flight_cap)
    for a, b in zip(_snapshot(eager, flight_cap), _snapshot(graph, flight_cap)):
        assert torch.equal(a, b)
    changed = any(not torch.equal(a, b) for a, b in zip(before, _snapshot(graph, flight_cap)))
    assert changed == (gate == "on")
    if gate == "on":
        assert graph.counters[CTR_STEPS] == GATES[gate][CTR_STEPS] + 1


@pytest.mark.parametrize("gate", ["off_last_n", "off_budget"])
def test_gated_off_body_changes_nothing(six, gate):
    """The body run under its gate when the gate is off (the eager paths do
    this): model, counters and flight buffer bit-identical."""
    tm, inv, (spec, prev, con, ns, nd) = six
    st = _state(tm, GATES[gate])
    st.flight_buffer(4).fill_(99)
    before = _snapshot(st, 4)
    topt._step_body(st, inv, step_active(st.counters), spec, prev, con, ns, nd, flight_cap=4)
    for a, b in zip(before, _snapshot(st, 4)):
        assert torch.equal(a, b)


def test_step_active_is_the_loop_cond():
    for last_n in (-1, 0, 1, 5):
        for steps, budget in ((0, 0), (0, 1), (3, 4), (4, 4), (5, 4)):
            c = torch.zeros((CTR_WIDTH,), dtype=torch.int32)
            c[CTR_LAST_N], c[CTR_STEPS], c[CTR_BUDGET] = last_n, steps, budget
            got = step_active(c)
            assert got.dtype == torch.bool and got.shape == ()
            assert bool(got) == (last_n > 0 and steps < budget)


# ---------------------------------------------------------------------------
# K8's flight rows over the grid
# ---------------------------------------------------------------------------

def test_kernel_constants_match_the_wrapper():
    assert _kernel_constant("kThreads") == topt.FLIGHT_THREADS
    assert _kernel_constant("kGroup") == topt.FLIGHT_GROUP
    assert _kernel_constant("kMaxBlocks") == topt.FLIGHT_MAX_BLOCKS
    assert _kernel_constant("kMaxSegments") + 2 == topt.FLIGHT_PARTIAL


@pytest.mark.parametrize("k, b, blocks", [
    (0, 0, 1), (1, 0, 1), (2048, 0, 1), (2049, 0, 2), (102_400, 200, 50),
    (262_144, 1_000, 128), (100, 5_000, 3), (3_000_000, 0, 1024)])
def test_flight_tiling(k, b, blocks):
    assert topt.flight_tiling(k, b) == blocks


def _key(bits: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving integer key of f32 bits."""
    bits = bits.astype(np.int32)
    return np.where(bits >= 0, bits, bits ^ np.int32(0x7FFFFFFF))


def _flight_walk(keep, offsets, score, eligible, fmask, mis=(0, 0, 0)):
    """The row's data slots [actions, frontier, score bits, kind index] as
    the two launches compute them, with the bases of keep, eligible and
    score ``mis`` bytes past a 16-byte boundary."""
    group, threads = topt.FLIGHT_GROUP, topt.FLIGHT_THREADS
    k = keep.shape[0]
    b = 0 if fmask is None else fmask.shape[0]
    blocks = topt.flight_tiling(k, b)
    stride = blocks * threads
    nseg = len(offsets) - 1
    lo = [offsets[s] if s < nseg else k for s in range(8)]
    hi = [offsets[s + 1] if s < nseg else k for s in range(8)]
    h = (group - mis[0] % 16) % 16
    head = k if (h >= k or (mis[1] + h) % 16 or (mis[2] + 4 * h) % 16) else h
    groups = (k - head) // group
    tail = head + groups * group
    cnt = np.zeros((blocks, 8), np.int64)
    best = np.full(blocks, _key(np.float32(-np.inf).view(np.int32)), np.int64)
    front = np.zeros(blocks, np.int64)
    seen = np.zeros(k, np.int64)
    keys = _key(score.view(np.int32))
    for g in range(groups):
        blk = (g % stride) // threads
        i0 = head + g * group
        seen[i0:i0 + group] += 1
        bits = sum(1 << j for j in range(group) if keep[i0 + j])
        for s in range(8):
            a = min(max(lo[s] - i0, 0), group)
            e = min(max(hi[s] - i0, 0), group)
            cnt[blk, s] += bin(bits & ((1 << e) - 1) & ~((1 << a) - 1)).count("1")
        el = eligible[i0:i0 + group]
        if el.any():
            best[blk] = max(best[blk], keys[i0:i0 + group][el].max())
    for j in range(head + (k - tail)):
        blk = (j % stride) // threads
        i = j if j < head else tail + (j - head)
        seen[i] += 1
        if keep[i]:
            for s in range(8):
                cnt[blk, s] += lo[s] <= i < hi[s]
        if eligible[i]:
            best[blk] = max(best[blk], keys[i])
    assert (seen == 1).all()  # every lane read exactly once
    if fmask is not None:
        for i in range(b):
            front[(i % stride) // threads] += bool(fmask[i])
    tot = cnt.sum(axis=0)[:nseg]
    n = int(tot.sum())
    top = int(np.argmax(tot))  # the first batch with the most
    bits = int(np.int32(_key(np.int32(best.max()))))
    return n, (int(front.sum()) if fmask is not None else -1), bits, (top if n > 0 else None)


CASES = {
    # name: (K, offsets or None for one batch, keep share, eligible share, B)
    "ragged": (1000 + 7, (0, 400, 1007), 0.3, 0.5, 12),
    "boundary_in_group": (96, (0, 37, 70, 96), 0.5, 0.5, 4),
    "empty_batches": (160, (0, 0, 50, 50, 160, 160), 0.4, 0.3, 3),
    "one_batch": (333, None, 0.2, 0.4, None),
    "eight_batches": (512, (0, 1, 17, 64, 65, 200, 300, 301, 512), 0.5, 0.5, 30),
    "no_eligible": (200, (0, 100, 200), 0.3, 0.0, 7),
    "nothing_kept": (64, (0, 20, 64), 0.0, 0.5, 5),
    "below_a_group": (11, (0, 5, 11), 0.5, 0.5, 2),
    "service": (102_400, (0, 65536, 69632, 102400), 0.01, 0.3, 200),
    "signed_zero_tie": (300, (0, 150, 300), 0.3, 0.5, 6),
    "nan": (300, (0, 150, 300), 0.3, 0.5, 6),
}


def _special_scores(case, score, eligible):
    """``signed_zero_tie``: every score negative but the eligible lanes'
    maximum, -0 and +0 on alternate eligible lanes (-0 first, in both
    halves); ``nan``: a NaN of each sign among the eligible lanes."""
    score = score.copy()
    lanes = np.flatnonzero(eligible)
    if case == "signed_zero_tie":
        score[:] = -np.abs(score) - np.float32(1.0)
        for j, i in enumerate(lanes[::7]):
            score[i] = np.float32(-0.0) if j % 2 == 0 else np.float32(0.0)
    elif case == "nan":
        score[lanes[3]] = -np.float32(np.nan)
        score[lanes[-4]] = np.float32(np.nan)
    return score


# Byte offsets of keep, eligible and score past a 16-byte boundary: aligned
# (the allocator's), co-aligned from lane 13 (a head of 13 lanes), and not
# aligned alike (every lane one at a time).  The service cut is walked at
# its aligned bases only.
MISALIGNED = [(0, 0, 0), (3, 3, 12), (5, 1, 0)]


@pytest.mark.parametrize("case, mis", [(c, m) for c in sorted(CASES) for m in MISALIGNED
                                       if c != "service" or m == (0, 0, 0)])
def test_flight_walk_equals_plain_twin(case, mis):
    k, offsets, pk, pe, b = CASES[case]
    offsets = offsets or (0, k)
    kinds = tuple((3 * s + 1) % 5 for s in range(len(offsets) - 1))
    rng = np.random.default_rng(len(case) + k)
    keep = rng.random(k) < pk
    eligible = rng.random(k) < pe
    score = _special_scores(case, rng.normal(size=k).astype(np.float32), eligible)
    fmask = None if b is None else rng.random(b) < 0.5
    n, front, bits, top = _flight_walk(keep, offsets, score, eligible, fmask, mis)
    counters = torch.zeros((CTR_WIDTH,), dtype=torch.int32)
    counters[CTR_STEPS], counters[CTR_LAST_N], counters[CTR_BUDGET] = 2, 1, 8
    buf = torch.full((4, FLIGHT_WIDTH), 99, dtype=torch.int32)
    topt.flight_row_plain(counters, torch.from_numpy(keep), offsets, kinds,
                          torch.from_numpy(score), torch.from_numpy(eligible),
                          None if fmask is None else torch.from_numpy(fmask),
                          torch.tensor(1, dtype=torch.int32),
                          torch.tensor(9, dtype=torch.int32), 3, buf)
    want = buf[2].tolist()
    assert want == [n, front, 1, 3, 9, bits, -1 if top is None else kinds[top]]
    if pe == 0.0:
        assert bits == int(np.float32(-np.inf).view(np.int32))
    if case == "signed_zero_tie":
        assert bits == 0  # +0
    if case == "nan":
        assert bits == int(np.float32(np.nan).view(np.int32))


# ---------------------------------------------------------------------------
# The cache's launch crediting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop", ["read", "clear", "evict"])
def test_replayed_graph_is_credited_and_collected(monkeypatch, drop):
    """A replayed graph's body launches are credited for the steps that ran
    (``executed``), once; a graph the cache drops is settled first and then
    collected.  The executables are stand-ins: nothing is launched."""
    import gc
    import weakref

    from cruise_control_tpu_torch.analyzer import graphs
    from cruise_control_tpu_torch.ops import cuda

    launched = []
    monkeypatch.setattr(cuda, "launch", lambda name, *args: launched.append(name))
    monkeypatch.setitem(cuda.COUNTED, "stand_in", cuda.ModeCounter())
    cache = graphs.GraphCache()
    shape = ("shape", 0)
    executed = torch.zeros((), dtype=torch.int64)
    g = graphs.StepGraph(None, 1, None, {"stand_in": 2}, executed, cache._mark_replayed)
    cache._graphs[("goal", shape)] = g
    cache._states[shape] = None
    g.replay(3)
    executed.fill_(2)  # the gate let two of the three replays run
    assert launched == ["step_graph_launch"] * 3
    if drop == "read":
        assert cuda.launch_counts()["stand_in"] == 4
        g.replay(1)
        executed.fill_(3)
        assert cuda.launch_counts()["stand_in"] == 6
        return
    if drop == "clear":
        cache.clear()
    else:
        monkeypatch.setattr(graphs, "MAX_SHAPES", 1)
        monkeypatch.setattr(graphs.StepState, "alloc_like",
                            staticmethod(lambda model, options: None))
        monkeypatch.setattr(graphs.GraphCache, "shape_key",
                            staticmethod(lambda model, options: ("other", 1)))
        with pytest.raises(AttributeError):  # the stand-in state has no ``load``
            cache.state(None, None)
        assert shape not in cache._states
    assert cuda.COUNTED["stand_in"].launches == 4
    alive = weakref.ref(g)
    del g
    gc.collect()
    assert alive() is None
    assert launched[-1] == "step_graph_destroy"
