"""K9's sweep and frontier mask as the card computes them
(``csrc/stack_sweep.cu``, ``csrc/frontier_active.cu``), walked in numpy and
held bit for bit against the port's plain twins and the JAX package.

The CUDA kernels cannot run here, so their decompositions are walked:

- the frontier mask (``_frontier_walk``): the flags and the two totals,
  then each ranking (donor surpluses, receiver rooms) by the rank pass (a
  thread a broker counts the entries that come before its own) or by the
  bitonic network (each position takes its partner's entry or keeps its
  own, stage by stage, as the shuffle, shared-memory and in-thread stages
  do), the in-block scans of 16, the block totals scanned in levels of 16,
  each running sum rebuilt as in-block scan plus the level-1 value of the
  block before, and each position's test.  Held against
  ``frontier_mask_plain`` and the JAX package's ``frontier_active``
  (``cruise_control_tpu/analyzer/goals/kernels.py:842``, fed the same broker
  rows) at B = 1 to 8,192 brokers, on non-dyadic values with equal-value
  ties, +0 and -0, every broker a donor, no broker under its band, a total
  surplus of 0 and dead brokers that still host replicas.
- the sweep (``_sweep_walk``): the grid's blocks by axis — a block per
  broker-axis goal (the per-goal body, which this redesign keeps), tiles of
  ``kThreads x kPer`` replicas per replica-axis goal and for the offline
  flag (each replica's ``replica_offline_now`` from the model's fields), a
  warp a topic for the (topic, broker) goals — each tile OR-ing its verdict
  into its goal's flag.  Held against ``stack_satisfied_plain`` and the JAX
  package's ``_stack_satisfied``
  (``cruise_control_tpu/analyzer/optimizer.py:2332``) on clusters whose
  only rack conflict, offline replica or wrong leader sits in the last
  replica (of the last, partial tile) and whose only topic out of band is
  the last topic.

Tolerance: exact (every flag and every broker).
"""

import dataclasses
import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.balancing_constraint import BalancingConstraint as JaxBC
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.goals.specs import GOAL_SPECS as JAX_SPECS
from cruise_control_tpu_torch.analyzer.balancing_constraint import BalancingConstraint
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.goals.specs import GOAL_SPECS
from cruise_control_tpu_torch.analyzer.state import BrokerArrays
from cruise_control_tpu_torch.model.generator import ClusterSpec, generate_cluster
from cruise_control_tpu_torch.model.tensor_model import BrokerState
from cruise_control_tpu_torch.ops import order
from tests.torch_port_helpers import STACK, scan_blocks, scan_levels, to_jax

F32 = np.float32
BIG = F32(1e30)
CSRC = Path(tk.__file__).resolve().parents[2] / "csrc"


def _constant(source, name):
    m = re.search(rf"constexpr int(?:64_t)? {name} = ([^;]+);", (CSRC / source).read_text())
    return m.group(1)


# The sweep's tiling, as csrc/stack_sweep.cu declares it.
K_THREADS = int(_constant("stack_sweep.cuh", "kThreads"))
K_PER = int(_constant("stack_sweep.cu", "kPer"))
K_TILE = K_THREADS * K_PER
TOPIC_WARPS = K_THREADS // 32
assert _constant("stack_sweep.cu", "kTopicWarps") == "kThreads / 32"


# ---------------------------------------------------------------------------
# The frontier mask
# ---------------------------------------------------------------------------

def _rank_perm(keys):
    """(perm, sorted keys) by the rank pass: entry j's rank is the number of
    entries that come before it (value descending, index ascending)."""
    b = keys.shape[0]
    j = np.arange(b)
    before = (keys[None, :] > keys[:, None]) | (
        (keys[None, :] == keys[:, None]) & (j[None, :] < j[:, None]))
    perm = np.empty(b, np.int64)
    perm[before.sum(1)] = j
    return perm, keys[perm]


def _bitonic_perm(keys):
    """(perm, sorted keys) by the bitonic network over the padded power of
    two (padding -inf, last), each position taking its partner's entry or
    keeping its own at every stage, as the kernel's threads do."""
    b = keys.shape[0]
    p = 1 << max(0, (b - 1).bit_length())
    key = np.full(p, -np.inf, F32)
    key[:b] = keys
    idx = np.arange(p)
    i = np.arange(p)
    k = 2
    while k <= p:
        j = k >> 1
        while j:
            pk, pi = key[i ^ j], idx[i ^ j]
            first = (pk > key) | ((pk == key) & (pi < idx))
            take = np.where(((i & j) == 0) == ((i & k) == 0), first, ~first)
            key, idx = np.where(take, pk, key), np.where(take, pi, idx)
            j >>= 1
        k <<= 1
    return idx[:b], key[:b]


def _leading(keys, limit, route):
    """bool[B]: the entries the kernel marks — ranked, running sums rebuilt
    from the in-block scans and the scanned level-1 totals, tested."""
    b = keys.shape[0]
    perm, v = (_rank_perm if route == "rank" else _bitonic_perm)(keys)
    blocks = scan_blocks(v[:, None])
    inblock = blocks.reshape(-1)[:b]
    cs = inblock.copy()
    if b > 16:
        level1 = scan_levels(blocks[:, 15])[:, 0]
        cs[16:] = inblock[16:] + level1[np.arange(16, b) // 16 - 1]
    out = np.zeros(b, bool)
    out[perm] = ((cs - v) < limit) & (v > 0)
    return out


def _ordered_sum(x):
    return F32(order.ordered_sum_plain(torch.from_numpy(x)).item())


def _frontier_walk(metric, lower, upper, alive, valid, rc, eps, route):
    """(bool[B], population): the frontier mask as the kernel computes it."""
    eps = F32(eps)
    over = alive & (metric > upper + eps)
    under = alive & (metric < lower - eps)
    dead = ~alive & valid & (rc > 0)
    target = np.where(upper >= BIG, metric, (lower + upper) * F32(0.5))
    shed_to = np.minimum(target, upper) if under.any() else upper
    donor = alive & (metric > shed_to + eps)
    zero = F32(0.0)
    surplus = (np.where(alive, np.maximum(metric - shed_to, zero), zero)
               + np.where(dead, np.maximum(metric, zero), zero))
    deficit = np.where(under, np.maximum(lower - metric, zero), zero)
    total_surplus, total_deficit = _ordered_sum(surplus), _ordered_sum(deficit)
    donors = _leading(np.where(donor, surplus, zero), F32(2.0) * total_deficit, route)
    room = np.where(alive & ~over, np.maximum(np.minimum(upper, BIG) - metric, zero), zero)
    receivers = (_leading(room, F32(2.0) * total_surplus, route) if total_surplus > 0
                 else np.zeros_like(donors))
    active = over | under | dead | donors | receivers
    return active, int(active.sum())


CASES = ("mixed", "all_donors", "no_under", "zero_surplus", "dead")


def _frontier_rows(b, case, seed):
    """(metric, lower, upper, alive, valid, replica_count, eps): one band
    goal's broker rows.  Non-dyadic lognormal loads; about a fifth of the
    metrics copied onto others (equal-value ties), a few set to -0.0."""
    rng = np.random.default_rng(seed)
    cap = rng.lognormal(3.0, 0.3, b).astype(F32)
    metric = (cap * rng.uniform(0.42, 0.93, b)).astype(F32)
    ties = rng.random(b) < 0.2
    metric[ties] = metric[rng.integers(0, b, int(ties.sum()))]
    lower, upper = (cap * F32(0.45)).astype(F32), (cap * F32(0.9)).astype(F32)
    alive = np.ones(b, bool)
    valid = np.ones(b, bool)
    rc = rng.integers(0, 40, b).astype(np.int32)
    if case == "mixed":
        metric[rng.random(b) < 0.05] = F32(-0.0)
        upper[rng.random(b) < 0.1] = BIG
        alive[rng.random(b) < 0.05] = False
    elif case == "all_donors":  # every broker over its band
        metric = (upper * F32(1.7) + F32(0.3)).astype(F32)
        metric[ties] = metric[0]
    elif case == "no_under":
        metric = np.maximum(metric, lower * F32(1.01)).astype(F32)
    elif case == "zero_surplus":  # every broker inside its band: no surplus
        metric = (lower + (upper - lower) * F32(0.37)).astype(F32)
        metric[ties] = metric[0]
        lower[ties], upper[ties] = lower[0], upper[0]
    elif case == "dead":  # dead brokers that still host replicas (light ones)
        alive[rng.random(b) < 0.15] = False
        rc[~alive] = np.maximum(rc[~alive], 1)
        metric[~alive] = (metric[~alive] * F32(0.01)).astype(F32)
    return metric, lower, upper, alive, valid, rc, float(F32(1e-6))


def _jax_frontier(monkeypatch, metric, lower, upper, alive, valid, rc, eps):
    """The JAX package's ``frontier_active`` on these broker rows."""
    monkeypatch.setattr(jk, "broker_metric", lambda *a: jnp.asarray(metric))
    monkeypatch.setattr(jk, "limits", lambda *a: (jnp.asarray(lower), jnp.asarray(upper)))
    monkeypatch.setattr(jk, "_metric_epsilon", lambda spec: eps)
    model = types.SimpleNamespace(num_brokers=metric.shape[0])
    arrays = types.SimpleNamespace(alive=jnp.asarray(alive), valid=jnp.asarray(valid),
                                   replica_count=jnp.asarray(rc))
    return np.asarray(jk.frontier_active(None, model, arrays, None))


SIZES = (1, 15, 16, 17, 31, 32, 33, 200, 257, 1000, 4097, 8192)
FRONTIER = ([(b, "mixed") for b in SIZES]
            + [(b, c) for b in (17, 257, 4097) for c in CASES if c != "mixed"])


@pytest.mark.parametrize("b,case", FRONTIER)
def test_frontier_walk_matches_plain_and_jax(monkeypatch, b, case):
    rows = _frontier_rows(b, case, seed=b)
    plain, count = tk.frontier_mask_plain(*[torch.from_numpy(x) for x in rows[:-1]], rows[-1])
    want = _jax_frontier(monkeypatch, *rows)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert int(count[0]) == int(want.sum())
    routes = ("rank", "bitonic") if b <= 1024 else ("bitonic",)
    for route in routes:
        got, n = _frontier_walk(*rows, route)
        np.testing.assert_array_equal(got, want, err_msg=route)
        assert n == int(want.sum())
    # The rows reach both rankings where the case allows it.
    if case in ("mixed", "dead") and b >= 200:
        assert 0 < int(want.sum()) < b


@pytest.mark.parametrize("b", SIZES)
def test_rankings_are_the_stable_argsort(b):
    """Both sorts give the plain twin's permutation (``order.argsort`` of the
    negated keys: value descending, index ascending, +0 equal to -0) on
    keys with ties, zeros of both signs and padding past B."""
    rng = np.random.default_rng(b + 1)
    keys = rng.lognormal(0.0, 1.0, b).astype(F32)
    keys[rng.random(b) < 0.3] = F32(0.0)
    keys[rng.random(b) < 0.1] = F32(-0.0)
    keys[rng.random(b) < 0.2] = keys[0]
    want = order.argsort(-torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(_bitonic_perm(keys)[0], want)
    if b <= 1024:
        np.testing.assert_array_equal(_rank_perm(keys)[0], want)
    # The running sums rebuilt from the level-1 values are ordered_cumsum's bits.
    v = keys[want]
    blocks = scan_blocks(v[:, None])
    cs = blocks.reshape(-1)[:b].copy()
    if b > 16:
        cs[16:] = cs[16:] + scan_levels(blocks[:, 15])[:, 0][np.arange(16, b) // 16 - 1]
    np.testing.assert_array_equal(cs.view(np.int32),
                                  order.ordered_cumsum(torch.from_numpy(v)).numpy().view(np.int32))


def test_kernel_limits_match_the_wrapper():
    assert tk.FRONTIER_MAX_BROKERS == int(_constant("frontier_active.cu", "kMaxBrokers"))
    assert tk.FRONTIER_RANK_MAX_BROKERS <= int(_constant("frontier_active.cu", "kMaxThreads"))


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

SWEEP_GOALS = STACK + ["RackAwareDistributionGoal", "PreferredLeaderElectionGoal",
                       "MinTopicLeadersPerBrokerGoal"]
SPEC = dict(num_brokers=12, num_racks=12, num_topics=30, mean_partitions_per_topic=25.0,
            replication_factor=3, distribution="exponential", seed=5)
AXIS = {"rack": "replica", "rack_distribution": "replica", "preferred_leader": "replica",
        "topic_replica_distribution": "topic", "min_topic_leaders": "topic"}


def _np(t):
    return t.numpy()


def _offline_now(m):
    rb = _np(m.replica_broker)
    disk = _np(m.replica_disk)
    dead_disk = (disk >= 0) & (_np(m.disk_capacity)[np.maximum(disk, 0)] < 0)
    sticky = _np(m.replica_offline) & (rb == _np(m.replica_original_broker))
    return _np(m.replica_valid) & ((_np(m.broker_state)[rb] == BrokerState.DEAD)
                                   | dead_disk | sticky)


def _replica_violations(kind, m, alive):
    """bool[R]: the replicas that violate a replica-axis goal."""
    r = m.num_replicas_padded
    i = np.arange(r)
    rb, valid, part = _np(m.replica_broker), _np(m.replica_valid), _np(m.replica_partition)
    pr, state = _np(m.partition_replicas), _np(m.broker_state)
    if kind == "preferred_leader":
        pref = pr[part, 0]
        sp = np.maximum(pref, 0)
        pref_ok = ((pref >= 0) & valid[sp] & ~_offline_now(m)[sp]
                   & (state[rb[sp]] != BrokerState.DEMOTED))
        return (valid & _np(m.replica_is_leader) & alive[rb]
                & (((pref != i) & pref_ok) | (state[rb] == BrokerState.DEMOTED)))
    rack = _np(m.broker_rack)
    sib = pr[part]
    same = (sib >= 0) & (sib < i[:, None]) & (rack[rb[np.maximum(sib, 0)]] == rack[rb][:, None])
    rank = same.sum(1)
    if kind == "rack":
        hit = rank > 0
    else:
        rf = _np(m.partition_replication_factor())[part]
        hit = rank.astype(F32) >= np.ceil(rf.astype(F32) / F32(m.num_racks))
    return valid & alive[rb] & hit


def _topic_cells_out(kind, m, con, alive, num_alive, pa, pb):
    """bool[T, B]: the (topic, broker) cells out of a topic goal's band, each
    topic's band from the integer total of its row (a warp's shuffle sum)."""
    if kind == "topic_replica_distribution":
        counts = _np(m.topic_broker_replica_counts())
        avg = counts.sum(1).astype(F32) / num_alive
        upper, lower = np.ceil(avg * pa)[:, None], np.floor(avg * pb)[:, None]
        return alive & ((counts > upper) | (counts < lower))
    designated = _np(tk._designated_topic_mask(m, con))[:, None]
    return designated & alive & (_np(m.topic_leader_counts()).astype(F32) < pa)


def _tiles(n, size_of_tile, lanes):
    """The index sets of the kernel's tiles over n items: tile x, lane t and
    slot k take item x * size + t + k * lanes (items past n skipped)."""
    tiles = max(1, -(-n // size_of_tile))
    per = size_of_tile // lanes
    out = []
    for x in range(tiles):
        i = (x * size_of_tile + np.arange(lanes)[:, None] + np.arange(per)[None, :] * lanes)
        out.append(i[i < n])
    return out


def _sweep_walk(specs, m, arrays, con):
    """(bool[G], offline): K9's sweep as the kernel's grid computes it."""
    alive = _np(arrays.alive)
    dead_hosting = (~alive & _np(arrays.valid) & (_np(arrays.replica_count) > 0)).any()
    r, t_count = m.num_replicas_padded, m.num_topics
    replica_tiles = _tiles(r, K_TILE, K_THREADS)
    # Every replica in exactly one tile; the last tile is partial here.
    assert np.array_equal(np.sort(np.concatenate(replica_tiles)), np.arange(r))
    topic_tiles = _tiles(t_count, TOPIC_WARPS, TOPIC_WARPS)
    num_alive = F32(int(_np(arrays.num_alive)))
    sat = np.ones(len(specs), bool)
    for g, spec in enumerate(specs):
        axis = AXIS.get(spec.kind, "broker")
        if axis == "broker":  # one block: the per-goal body, unchanged
            sat[g] = bool(tk.goal_satisfied(spec, m, arrays, con))
            continue
        _, pa, pb, _ = (F32(x) for x in tk._sweep_params(spec, con)[1])
        if axis == "replica":
            viol = _replica_violations(spec.kind, m, alive)
            hits = [viol[i].any() for i in replica_tiles]
        else:
            out = _topic_cells_out(spec.kind, m, con, alive, num_alive, pa, pb)
            hits = [out[tile].any() for tile in topic_tiles]  # a warp a topic
        hits[0] |= spec.is_hard and dead_hosting  # the goal's first block
        sat[g] = not any(hits)
    offline = any(_offline_now(m)[i].any() for i in replica_tiles)
    return sat, offline


def _balanced_topics(m, skew=True):
    """The cluster with each topic's replicas dealt round-robin over the
    brokers (its partitions' replicas on distinct brokers), then (``skew``)
    the last topic's partitions each with a replica moved to broker 0: the
    last topic alone out of its band."""
    rb = _np(m.replica_broker).copy()
    topic, part, valid = _np(m.replica_topic), _np(m.replica_partition), _np(m.replica_valid)
    pr = _np(m.partition_replicas)
    for tp in range(m.num_topics):
        rows = np.flatnonzero(valid & (topic == tp))
        rows = rows[np.lexsort((rows, part[rows]))]
        rb[rows] = (np.arange(rows.size) + tp) % m.num_brokers
    last = m.num_topics - 1
    for p in np.unique(part[valid & (topic == last)]) if skew else ():
        reps = pr[p][pr[p] >= 0]
        if not (rb[reps] == 0).any():
            rb[reps[0]] = 0
    rb = torch.from_numpy(rb)
    return m.replace(replica_broker=rb, replica_original_broker=rb.clone())


def _variant(name):
    m = generate_cluster(ClusterSpec(**SPEC), device="cpu")
    rows = np.flatnonzero(_np(m.replica_valid))
    r = int(rows[-1])
    if name == "rack_last":  # the last replica onto its lowest sibling's broker
        sib = _np(m.partition_replicas)[int(m.replica_partition[r])]
        rb = m.replica_broker.clone()
        rb[r] = rb[int(sib[sib >= 0].min())]
        return m.replace(replica_broker=rb), r
    if name == "offline_last":  # reported offline, still on its original broker
        off = m.replica_offline.clone()
        off[r] = True
        return m.replace(replica_offline=off), r
    if name == "preferred_last":  # the last partition led by its second replica
        sib = _np(m.partition_replicas)[int(m.replica_partition[r])]
        lead = m.replica_is_leader.clone()
        lead[int(sib[0])], lead[int(sib[1])] = False, True
        return m.replace(replica_is_leader=lead), r
    if name == "topic_last":
        return _balanced_topics(m), r
    return m.set_broker_state(3, BrokerState.DEAD), r  # "dead_broker"


VARIANTS = ("rack_last", "offline_last", "preferred_last", "topic_last", "dead_broker")


@pytest.fixture(scope="module")
def baseline():
    """The unchanged cluster's flags: every variant flips only its own."""
    m = generate_cluster(ClusterSpec(**SPEC), device="cpu")
    specs = tuple(GOAL_SPECS[g] for g in SWEEP_GOALS)
    con = BalancingConstraint.default()
    sat, off = tk.stack_satisfied_plain(specs, m, BrokerArrays.from_model(m), con)
    return dict(zip(SWEEP_GOALS, sat.tolist())), bool(off[0])


@pytest.mark.parametrize("name", VARIANTS)
def test_sweep_walk_matches_plain_and_jax(baseline, name):
    m, r = _variant(name)
    assert r >= K_TILE > 0 and m.num_replicas_padded < 2 * K_TILE  # in the last tile
    specs = tuple(GOAL_SPECS[g] for g in SWEEP_GOALS)
    topics = (m.num_topics - 1,)
    con = dataclasses.replace(BalancingConstraint.default(), min_leader_topic_ids=topics)
    jcon = dataclasses.replace(JaxBC.default(), min_leader_topic_ids=topics)
    arrays = BrokerArrays.from_model(m)
    sat, off = tk.stack_satisfied_plain(specs, m, arrays, con)
    jsat, joff = jopt._stack_satisfied(to_jax(m), specs=tuple(JAX_SPECS[g] for g in SWEEP_GOALS),
                                       constraint=jcon)
    np.testing.assert_array_equal(sat.numpy(), np.asarray(jsat))
    assert bool(off[0]) == bool(joff)
    got, offline = _sweep_walk(specs, m, arrays, con)
    np.testing.assert_array_equal(got, sat.numpy())
    assert offline == bool(off[0])
    flags = dict(zip(SWEEP_GOALS, got.tolist()))
    base, base_off = baseline
    flipped = {"rack_last": ("RackAwareGoal", "RackAwareDistributionGoal"),
               "preferred_last": ("PreferredLeaderElectionGoal",)}.get(name, ())
    for g in flipped:
        assert base[g] and not flags[g], g
    if name == "offline_last":
        assert offline and not base_off
    if name == "topic_last":
        num_alive = F32(int(_np(arrays.num_alive)))
        _, pa, pb, _ = (F32(x) for x in tk._sweep_params(GOAL_SPECS[STACK[12]], con)[1])
        out = _topic_cells_out("topic_replica_distribution", m, con, _np(arrays.alive),
                               num_alive, pa, pb)
        assert np.flatnonzero(out.any(1)).tolist() == [m.num_topics - 1]
        assert not flags["TopicReplicaDistributionGoal"]
