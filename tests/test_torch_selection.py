"""K4, the selection glue of ``select_batched`` (``ops/selection.py``), and
the port's ``select_batched`` in one to three rounds, against the JAX
package.

- ``select_batched``: the port's plain path against the JAX package's
  ``select_batched`` (jitted, as its step runs it) on the same seeded
  candidates over a 12-broker JBOD model — keep masks bit for bit, and the
  repair and live-lane counts — for rounds 1, 2 and 3, with and without
  swaps and topic budgets, under ``disk_guard``, on a frontier, compacted
  (``compact_k``) and under the repair oracle.  The budgets are drawn near
  the candidates' deltas (some +inf), so the repair passes fire.
- Each plain twin (``select_mask_plain``, ``topic_round_sums_plain``,
  ``net_viol_plain``, ``partition_claims_plain``) and its wrapper on CPU
  tensors against a numpy transcription of the JAX package's lines, on
  seeded edges: no lane kept and every lane kept, every leg on key 0, a key
  count that is not a multiple of 32, +inf budgets and -0.0 deltas.

Every output is a bool or an exact integer-valued float, so every
comparison is exact.  (The card's kernels, ``csrc/selection.cu``, are held
against the plain twins bit for bit in ``chip_smoke.py``.)"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.actions import Candidates as JaxCandidates
from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu_torch.analyzer import optimizer as topt
from cruise_control_tpu_torch.analyzer.actions import Candidates
from cruise_control_tpu_torch.ops import selection as sel
from tests.torch_port_helpers import SPEC_12, to_torch

EPS = np.float32(1e-6)
NB = 12
K = 768


@pytest.fixture(scope="module")
def models():
    jm = jax_generate(JaxSpec(**dict(SPEC_12, disks_per_broker=4)))
    return jm, to_torch(jm)


def _candidates(rng, jm, k, swaps, intra):
    """Seeded candidate fields (numpy) over the model's valid replicas."""
    valid = np.nonzero(np.asarray(jm.replica_valid))[0]
    rb = np.asarray(jm.replica_broker)
    rp = np.asarray(jm.replica_partition)
    rd = np.asarray(jm.replica_disk)
    lead = np.asarray(jm.replica_is_leader)
    kinds = [0, 1] + ([3] if swaps else []) + ([2] if intra else [])
    at = rng.choice(kinds, k).astype(np.int32)
    replica = rng.choice(valid, k).astype(np.int32)
    src = rb[replica].astype(np.int32)
    other = rng.choice(valid, k).astype(np.int32)
    dest = ((src + rng.integers(1, NB, k)) % NB).astype(np.int32)
    swap = at == 3
    dest = np.where(swap, rb[other], dest).astype(np.int32)
    dest = np.where(at == 2, src, dest).astype(np.int32)
    dest_replica = np.where(swap | (at == 1), other, -1).astype(np.int32)
    partition = rp[replica].astype(np.int32)
    partition2 = np.where(swap, rp[other], partition).astype(np.int32)
    num_disks = int(jm.num_disks)
    src_disk = np.where(at == 2, rd[replica], -1).astype(np.int32)
    dest_disk = np.where(at == 2, rng.integers(0, num_disks, k), -1).astype(np.int32)
    load = rng.gamma(2.0, 1.0, (k, 4)).astype(np.float32)
    noise = rng.standard_normal((k, 4)).astype(np.float32) * np.float32(0.25)
    moves = (at == 0) | (at == 2)
    d_rc = np.where(at == 0, 1, 0).astype(np.int32)
    d_lc = np.where(at == 1, 1, np.where(swap, rng.integers(-1, 2, k),
                                         np.where(moves, lead[replica], 0))).astype(np.int32)
    return dict(
        action_type=at, replica=replica, src=src, dest=dest, dest_replica=dest_replica,
        partition=partition, partition2=partition2, valid=np.ones(k, bool),
        delta_src=np.where(swap[:, None], noise, -load), delta_dest=np.where(
            swap[:, None], -noise, load).astype(np.float32),
        d_replica_count=d_rc, d_leader_count=d_lc,
        d_potential_nw_out=rng.gamma(2.0, 1.0, k).astype(np.float32),
        d_leader_bytes_in_src=rng.gamma(2.0, 0.5, k).astype(np.float32),
        d_leader_bytes_in_dest=rng.gamma(2.0, 0.5, k).astype(np.float32),
        src_disk=src_disk, dest_disk=dest_disk)


def _budgets(rng, shape, scale, inf_share):
    b = (rng.random(shape) * scale).astype(np.float32)
    b[rng.random(shape) < inf_share] = np.inf
    return b


def _case(rng, jm, swaps, topic, intra, frontier):
    f = _candidates(rng, jm, K, swaps, intra)
    score = (rng.integers(1, 40, K) / 4.0).astype(np.float32)
    eligible = rng.random(K) < 0.85
    room = _budgets(rng, (NB, 8), 6.0, 0.2)
    slack = _budgets(rng, (NB, 8), 6.0, 0.2)
    room[:, 4:6] = rng.integers(0, 4, (NB, 2))  # the count channels: a few
    n_tb = int(jm.num_topics) * NB
    tb = tuple(_budgets(rng, n_tb, 4.0, 0.25).round() for _ in range(3)) if topic else None
    fr = None
    if frontier:
        active = np.zeros(NB, bool)
        active[rng.choice(NB, 7, replace=False)] = True
        fr = active
        eligible &= active[f["src"]] & active[f["dest"]]
    return f, score, eligible, room, slack, tb, fr


@functools.partial(jax.jit, static_argnames=("disk_guard", "rounds", "subrounds", "has_swaps",
                                             "compact_k", "repair_oracle"))
def _jax_select(score, cand, eligible, model, room, slack, tb, frontier, *, disk_guard,
                rounds, subrounds, has_swaps, compact_k, repair_oracle):
    return jopt.select_batched(score, cand, eligible, model, room, slack, tb, disk_guard,
                               rounds=rounds, subrounds=subrounds, has_swaps=has_swaps,
                               frontier=frontier, compact_k=compact_k,
                               repair_oracle=repair_oracle)


# (rounds, swaps, topic budgets, disk guard, frontier, compact_k, repair oracle)
SELECT_CASES = [
    (1, True, True, False, False, None, False),
    (2, True, True, False, False, None, False),
    (3, True, True, False, False, None, False),
    (2, False, False, False, False, None, False),
    (3, False, True, False, False, 512, False),
    (2, True, True, True, False, None, False),
    (2, True, True, False, True, None, False),
    (2, True, True, False, False, None, True),
    (3, False, False, True, True, 512, False),
]


@pytest.mark.parametrize("case", SELECT_CASES, ids=[
    "r{}-{}{}{}{}{}{}".format(r, "swaps" if s else "moves", "-topic" if t else "",
                              "-disk" if d else "", "-frontier" if f else "",
                              f"-k{c}" if c else "", "-oracle" if o else "")
    for r, s, t, d, f, c, o in SELECT_CASES])
def test_select_batched_matches_jax(case, models):
    rounds, swaps, topic, disk, frontier, compact_k, oracle = case
    jm, tm = models
    fired = 0
    for seed in range(3):
        rng = np.random.default_rng(100 * rounds + seed)
        f, score, eligible, room, slack, tb, active = _case(rng, jm, swaps, topic, disk,
                                                            frontier)
        jfr = tfr = None
        if active is not None:
            jfr, tfr = jopt._build_frontier(active, 8), topt._build_frontier(active, 8)
        jcand = JaxCandidates(**{n: jnp.asarray(a) for n, a in f.items()})
        tcand = Candidates(**{n: torch.from_numpy(a) for n, a in f.items()})
        jkeep, jstats = _jax_select(
            jnp.asarray(score), jcand, jnp.asarray(eligible), jm, jnp.asarray(room),
            jnp.asarray(slack), None if tb is None else tuple(jnp.asarray(b) for b in tb),
            jfr, disk_guard=disk, rounds=rounds, subrounds=2, has_swaps=swaps,
            compact_k=compact_k, repair_oracle=oracle)
        tkeep, tstats = topt.select_batched(
            torch.from_numpy(score), tcand, torch.from_numpy(eligible), tm,
            torch.from_numpy(room), torch.from_numpy(slack),
            None if tb is None else tuple(torch.from_numpy(b) for b in tb), 2,
            has_swaps=swaps, compact_k=compact_k, frontier=tfr, disk_guard=disk,
            repair_oracle=oracle, rounds=rounds)
        want, got = np.asarray(jkeep), tkeep.numpy()
        bad = np.nonzero(got != want)[0]
        assert bad.size == 0, (f"seed {seed}: keep masks differ first at lane {bad[0]} "
                               f"(port {got[bad[0]]}, JAX {want[bad[0]]}); {bad.size} lanes")
        assert want.any()
        assert (int(tstats[0]), int(tstats[1]), int(tstats[2])) == \
            tuple(int(x) for x in jstats), seed
        fired += int(tstats[0])
    if not oracle:
        assert fired > 0  # the budgets are tight enough for the repair to run


def test_more_rounds_keep_more(models):
    """A second round keeps lanes that the first could not (the lanes of a
    broker are capped per round), and keeps every lane of the first."""
    jm, tm = models
    rng = np.random.default_rng(7)
    f, score, eligible, room, slack, tb, _ = _case(rng, jm, True, True, False, False)
    args = (torch.from_numpy(score), Candidates(**{n: torch.from_numpy(a) for n, a in f.items()}),
            torch.from_numpy(eligible), tm, torch.from_numpy(room), torch.from_numpy(slack),
            tuple(torch.from_numpy(b) for b in tb), 2)
    one, _ = topt.select_batched(*args, has_swaps=True, rounds=1)
    two, _ = topt.select_batched(*args, has_swaps=True, rounds=2)
    assert bool((two | ~one).all()) and int(two.sum()) > int(one.sum())


# ---------------------------------------------------------------------------
# The plain twins against numpy transcriptions of the JAX package's lines
# ---------------------------------------------------------------------------

def _np_select_mask(elig, d_src, d_dest, src_b, dest_b, room, slack, cum_net, topic, used,
                    disks):
    """``optimizer.py:584-587,599-637`` in numpy."""
    if used is not None:
        keep_total, used_part, p1, p2 = used
        elig = elig & ~keep_total & ~used_part[p1] & ~used_part[p2]
    if disks is not None:
        sd, dd, us, ud = disks
        elig = elig & ~((dd >= 0) & (us[np.maximum(sd, 0)] | ud[np.maximum(dd, 0)]))
    cd = d_dest if cum_net is None else cum_net[dest_b] + d_dest
    cs = d_src if cum_net is None else cum_net[src_b] + d_src
    ok = ((cd <= room[dest_b] + EPS) & (cd >= -slack[dest_b] - EPS) &
          (cs >= -slack[src_b] - EPS) & (cs <= room[src_b] + EPS)).all(axis=1)
    elig = elig & ok
    if topic is not None:
        keys, d_rep, d_lead, gain, shed, shed_lead, cum_rep, cum_lead = topic
        rep = d_rep if cum_rep is None else cum_rep[keys] + d_rep
        lead = d_lead if cum_lead is None else cum_lead[keys] + d_lead
        elig = elig & ((rep <= gain[keys] + EPS) & (rep >= -shed[keys] - EPS)).all(axis=0)
        elig = elig & ((lead <= np.float32(np.inf) + EPS) &
                       (lead >= -shed_lead[keys] - EPS)).all(axis=0)
    return elig


def _np_topic_sums(keep, topic, nb):
    """``optimizer.py:671-682,745-749``: scatter-adds in lane order."""
    keys, d_rep, d_lead, gain, shed, shed_lead, cum_rep, cum_lead = topic
    n_tb = gain.shape[0]
    kk = np.where(keep[None, :], keys, 0).reshape(-1)
    rep = np.zeros(n_tb, np.float32)
    lead = np.zeros(n_tb, np.float32)
    np.add.at(rep, kk, np.where(keep[None, :], d_rep, np.float32(0)).reshape(-1))
    np.add.at(lead, kk, np.where(keep[None, :], d_lead, np.float32(0)).reshape(-1))
    if cum_rep is not None:
        rep, lead = cum_rep + rep, cum_lead + lead
    vt = (rep > gain + EPS) | (rep < -shed - EPS) | (lead < -shed_lead - EPS)
    bad_b = np.zeros(nb, bool)
    np.logical_or.at(bad_b, np.arange(n_tb) % nb, vt)
    return vt, bad_b, rep, lead


def _np_net_viol(cum_net, round_net, room, slack, bad_b):
    total = round_net if cum_net is None else cum_net + round_net
    out = ((total > room + EPS) | (total < -slack - EPS)).any(axis=1)
    return out if bad_b is None else out | bad_b


def _np_claims(keep, p1, p2, P, used=None, disks=None):
    """``optimizer.py:645-652`` (claim1) and ``:851-852,862-864``."""
    if used is None:
        claim1 = np.zeros(P, bool)
        np.logical_or.at(claim1, np.where(keep, p1, 0), keep)
        return keep & ~((p2 != p1) & claim1[p2]), None
    used = used.copy()
    np.logical_or.at(used, np.where(keep, p1, 0), keep)
    np.logical_or.at(used, np.where(keep, p2, 0), keep)
    out_disks = None
    if disks is not None:
        sd, dd, us, ud = (a.copy() for a in disks)
        touches = keep & (dd >= 0)
        np.logical_or.at(us, np.where(touches, np.maximum(sd, 0), 0), touches)
        np.logical_or.at(ud, np.where(touches, np.maximum(dd, 0), 0), touches)
        out_disks = (us, ud)
    return used, out_disks


# Edge cases: (name, kept share, every leg on key 0, topics, inf share, -0.0 deltas)
EDGES = [("mixed", 0.5, False, 5, 0.2, False), ("none-kept", 0.0, False, 5, 0.2, False),
         ("all-kept", 1.0, False, 5, 0.2, False), ("key-0", 0.6, True, 5, 0.2, False),
         ("n_tb-odd", 0.5, False, 3, 0.2, False), ("all-inf", 0.7, False, 5, 1.0, False),
         ("neg-zero", 0.5, False, 5, 0.2, True)]


def _edge(name, share, key0, topics, inf_share, negzero, nb=11, k=500, legs=4, P=97, D=23,
          seed=0):
    rng = np.random.default_rng(seed + 31 * len(name))
    n_tb = topics * nb  # 55 or 33 keys: never a multiple of 32
    keep = rng.random(k) < share
    d_src = (rng.integers(-6, 7, (k, 8)) / 4).astype(np.float32)
    d_dest = (rng.integers(-6, 7, (k, 8)) / 4).astype(np.float32)
    d_rep = rng.integers(-1, 2, (legs, k)).astype(np.float32)
    d_lead = rng.integers(-1, 2, (legs, k)).astype(np.float32)
    if negzero:
        for d in (d_src, d_dest, d_rep, d_lead):
            d[d == 0] = -0.0
    keys = (np.zeros((legs, k)) if key0 else rng.integers(0, n_tb, (legs, k))).astype(np.int32)
    src_b = rng.integers(0, nb, k).astype(np.int32)
    dest_b = rng.integers(0, nb, k).astype(np.int32)
    room, slack = (_budgets(rng, (nb, 8), 6.0, inf_share) for _ in range(2))
    gain, shed, shed_lead = (_budgets(rng, n_tb, 5.0, inf_share).round() for _ in range(3))
    cum_net = (rng.integers(-8, 9, (nb, 8)) / 4).astype(np.float32)
    cum_rep, cum_lead = (rng.integers(-2, 3, n_tb).astype(np.float32) for _ in range(2))
    round_net = (rng.integers(-24, 25, (nb, 8)) / 4).astype(np.float32)
    p1 = rng.integers(0, P, k).astype(np.int32)
    p2 = np.where(rng.random(k) < 0.5, rng.integers(0, P, k), p1).astype(np.int32)
    sd = np.where(rng.random(k) < 0.4, rng.integers(0, D, k), -1).astype(np.int32)
    dd = np.where(sd >= 0, rng.integers(0, D, k), -1).astype(np.int32)
    return dict(keep=keep, elig=rng.random(k) < max(share, 0.3) if share < 1 else keep,
                d_src=d_src, d_dest=d_dest, d_rep=d_rep, d_lead=d_lead, keys=keys,
                src_b=src_b, dest_b=dest_b, room=room, slack=slack, gain=gain, shed=shed,
                shed_lead=shed_lead, cum_net=cum_net, cum_rep=cum_rep, cum_lead=cum_lead,
                round_net=round_net, p1=p1, p2=p2, sd=sd, dd=dd, P=P, nb=nb,
                used=rng.random(P) < 0.2, us=rng.random(D) < 0.2, ud=rng.random(D) < 0.2)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _topic(e, cum):
    return (e["keys"], e["d_rep"], e["d_lead"], e["gain"], e["shed"], e["shed_lead"],
            e["cum_rep"] if cum else None, e["cum_lead"] if cum else None)


def _tt(tup):
    return None if tup is None else tuple(_t(a) for a in tup)


@pytest.mark.parametrize("cum", [False, True], ids=["round1", "later"])
@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_select_mask_plain(edge, cum):
    e = _edge(*edge)
    for topic_on in (False, True):
        topic = _topic(e, cum) if topic_on else None
        used = (e["keep"], e["used"], e["p1"], e["p2"]) if cum else None
        disks = (e["sd"], e["dd"], e["us"], e["ud"]) if cum else None
        cum_net = e["cum_net"] if cum else None
        want = _np_select_mask(e["elig"], e["d_src"], e["d_dest"], e["src_b"], e["dest_b"],
                               e["room"], e["slack"], cum_net, topic, used, disks)
        args = (_t(e["elig"]), _t(e["d_src"]), _t(e["d_dest"]), _t(e["src_b"]),
                _t(e["dest_b"]), _t(e["room"]), _t(e["slack"]), _t(cum_net), _tt(topic),
                _tt(used), _tt(disks))
        np.testing.assert_array_equal(sel.select_mask_plain(*args).numpy(), want)
        np.testing.assert_array_equal(sel.select_mask(*args).numpy(), want)


@pytest.mark.parametrize("cum", [False, True], ids=["round1", "later"])
@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_topic_round_sums_plain(edge, cum):
    e = _edge(*edge)
    topic = _topic(e, cum)
    vt, bad_b, rep, lead = _np_topic_sums(e["keep"], topic, e["nb"])
    for fn in (sel.topic_round_sums_plain, sel.topic_round_sums):
        got = fn(_t(e["keep"]), _tt(topic), e["nb"], write_cum=True)
        np.testing.assert_array_equal(got[0].numpy(), vt)
        np.testing.assert_array_equal(got[1].numpy(), bad_b)
        np.testing.assert_array_equal(got[2].numpy(), rep)
        np.testing.assert_array_equal(got[3].numpy(), lead)
        assert fn(_t(e["keep"]), _tt(topic), e["nb"])[2] is None
    if edge[0] == "none-kept":
        assert not bad_b.any() or cum


@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_net_viol_plain(edge):
    e = _edge(*edge)
    _, bad_b, _, _ = _np_topic_sums(e["keep"], _topic(e, True), e["nb"])
    for cum_net in (None, e["cum_net"]):
        for bad in (None, bad_b):
            want = _np_net_viol(cum_net, e["round_net"], e["room"], e["slack"], bad)
            args = (_t(cum_net), _t(e["round_net"]), _t(e["room"]), _t(e["slack"]), _t(bad))
            np.testing.assert_array_equal(sel.net_viol_plain(*args).numpy(), want)
            np.testing.assert_array_equal(sel.net_viol(*args).numpy(), want)


@pytest.mark.parametrize("edge", EDGES, ids=[e[0] for e in EDGES])
def test_partition_claims_plain(edge):
    e = _edge(*edge)
    keep, p1, p2, P = e["keep"], e["p1"], e["p2"], e["P"]
    want, _ = _np_claims(keep, p1, p2, P)
    for fn in (sel.partition_claims_plain, sel.partition_claims):
        np.testing.assert_array_equal(fn(_t(keep), _t(p1), _t(p2), P).numpy(), want)
    want_used, want_disks = _np_claims(keep, p1, p2, P, e["used"], (e["sd"], e["dd"], e["us"],
                                                                  e["ud"]))
    for fn in (sel.partition_claims_plain, sel.partition_claims):
        used, us, ud = _t(e["used"].copy()), _t(e["us"].copy()), _t(e["ud"].copy())
        assert fn(_t(keep), _t(p1), _t(p2), P, used, (_t(e["sd"]), _t(e["dd"]), us, ud)) is None
        np.testing.assert_array_equal(used.numpy(), want_used)
        np.testing.assert_array_equal(us.numpy(), want_disks[0])
        np.testing.assert_array_equal(ud.numpy(), want_disks[1])


def test_wrappers_refuse_bad_inputs():
    e = _edge(*EDGES[0])
    with pytest.raises(TypeError, match="keep"):
        sel.topic_round_sums(_t(e["keep"].astype(np.int32)), _tt(_topic(e, False)), e["nb"])
    with pytest.raises(ValueError, match="fold"):
        sel.topic_round_sums(_t(e["keep"]), _tt(_topic(e, False)), 4)
    with pytest.raises(ValueError, match="together"):
        topic = _topic(e, True)[:7] + (None,)
        sel.select_mask(_t(e["elig"]), _t(e["d_src"]), _t(e["d_dest"]), _t(e["src_b"]),
                        _t(e["dest_b"]), _t(e["room"]), _t(e["slack"]), None, _tt(topic))
    with pytest.raises(ValueError, match="used disks"):
        sel.partition_claims(_t(e["keep"]), _t(e["p1"]), _t(e["p2"]), e["P"], None,
                             (_t(e["sd"]), _t(e["dd"]), _t(e["us"]), _t(e["ud"])))


# ---------------------------------------------------------------------------
# K4e: the leg build and the frontier budgets against numpy
# ---------------------------------------------------------------------------

def _np_legs(f, sel_idx, score, elig, lane, c_of_f, rtopic, rlead, nb, subrounds, legs):
    """``optimizer.py:509-580`` in numpy (the compaction's gathers, the
    frontier slots, ``_channel_deltas`` and the legs), with the layouts the
    rounds read: [dest; src; dest] rows, the K3 (rep, lead) columns, the K2
    keys."""
    if sel_idx is not None:
        f = {n: a[sel_idx] for n, a in f.items()}
        score, elig, lane = score[sel_idx], elig[sel_idx], lane[sel_idx]
    sb, db = f["src"], f["dest"]
    if c_of_f is not None:
        c = np.maximum(c_of_f, 0)
        sb, db = c[sb], c[db]
    dc = f["d_replica_count"].astype(np.float32)[:, None]
    dl = f["d_leader_count"].astype(np.float32)[:, None]
    dp = f["d_potential_nw_out"][:, None]
    d_src = np.concatenate([f["delta_src"], -dc, -dl, -dp,
                            -f["d_leader_bytes_in_src"][:, None]], 1)
    d_dest = np.concatenate([f["delta_dest"], dc, dl, dp,
                             f["d_leader_bytes_in_dest"][:, None]], 1)
    out = dict(score=np.tile(score, max(2, legs)), eligible=elig, partition=f["partition"],
               partition2=f["partition2"], src_disk=f["src_disk"], dest_disk=f["dest_disk"],
               seg3=np.concatenate([db, sb, db]), src_lane=sb * subrounds + lane,
               dest_lane=db * subrounds + lane, d3=np.concatenate([d_dest, d_src, d_dest]))
    if not legs:
        return out
    at, r1 = f["action_type"], f["replica"]
    zero = np.float32(0.0)
    t1 = rtopic[r1]
    r2 = np.where(f["dest_replica"] >= 0, f["dest_replica"], 0)
    t2 = rtopic[r2]
    moves_tb, swap = (at == 0) | (at == 3), at == 3
    lead1 = ((at == 1) | (moves_tb & rlead[r1])).astype(np.float32)
    if legs == 4:
        same_t = swap & (t1 == t2)
        rep1 = np.where(same_t, zero, moves_tb.astype(np.float32))
        rep2 = np.where(same_t, zero, swap.astype(np.float32))
        keys = np.stack([t1 * nb + sb, t1 * nb + db, t2 * nb + db, t2 * nb + sb])
        d_rep = np.stack([-rep1, rep1, -rep2, rep2])
        lead2 = (swap & rlead[r2]).astype(np.float32)
        l1 = np.where(same_t, lead1 - lead2, lead1)
        l2 = np.where(same_t, zero, lead2)
        d_lead = np.stack([-l1, l1, -l2, l2])
    else:
        mv = moves_tb.astype(np.float32)
        keys = np.stack([t1 * nb + sb, t1 * nb + db])
        d_rep, d_lead = np.stack([-mv, mv]), np.stack([-lead1, lead1])
    out.update(leg_keys=keys, d_rep=d_rep, d_lead=d_lead, d_rl=np.stack([d_rep, d_lead], -1),
               leg_nz=(d_rep != 0) | (d_lead != 0), leg_lane_keys=keys * 16 + lane % 16)
    return out


def _same_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)  # -0.0 apart from +0.0
    np.testing.assert_array_equal(got, want, err_msg=what)


def _legs_case(jm, legs, compact, frontier, seed=0):
    rng = np.random.default_rng(seed + 10 * legs + 2 * compact + frontier)
    f = _candidates(rng, jm, K, legs == 4, True)
    # Zero deltas on a share of the lanes: their negated channels are -0.0.
    zero = rng.random(K) < 0.3
    f["delta_src"][zero] = 0.0
    f["d_potential_nw_out"][zero] = 0.0
    f["d_leader_bytes_in_src"][zero] = 0.0
    score = (rng.integers(1, 40, K) / 4.0).astype(np.float32)
    elig = rng.random(K) < 0.7
    lane = rng.integers(0, 8, K).astype(np.int32)
    sel_idx = np.sort(rng.choice(K, K // 3, replace=False)).astype(np.int32)[::-1].copy() \
        if compact else None
    c_of_f = None
    if frontier:
        active = np.zeros(NB, bool)
        active[rng.choice(NB, 5, replace=False)] = True
        c_of_f = topt._build_frontier(active, 8).compact_of_full.numpy()
    return f, sel_idx, score, elig, lane, c_of_f


@pytest.mark.parametrize("frontier", [False, True], ids=["all-brokers", "frontier"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compacted"])
@pytest.mark.parametrize("legs", [0, 2, 4], ids=["no-topic", "moves", "swaps"])
def test_select_legs_plain(legs, compact, frontier, models):
    jm, tm = models
    f, sel_idx, score, elig, lane, c_of_f = _legs_case(jm, legs, compact, frontier)
    nb = 8 if frontier else NB
    rtopic, rlead = np.asarray(jm.replica_topic), np.asarray(jm.replica_is_leader)
    want = _np_legs(f, sel_idx, score, elig, lane, c_of_f, rtopic, rlead, nb, 4, legs)
    cand = Candidates(**{n: torch.from_numpy(a) for n, a in f.items()})
    args = (cand, _t(sel_idx), _t(score), _t(elig), _t(lane), _t(c_of_f), tm.replica_topic,
            tm.replica_is_leader, nb, 4, legs)
    for fn in (sel.select_legs_plain, sel.select_legs):
        got = fn(*args)
        for name, w in want.items():
            _same_bits(getattr(got, name).numpy(), w, name)
        for name in ("leg_keys", "d_rep", "d_lead", "d_rl", "leg_nz", "leg_lane_keys"):
            assert (getattr(got, name) is None) == (legs == 0), name
        kc = K // 3 if compact else K
        _same_bits(got.d_src.numpy(), want["d3"][kc:2 * kc], "d_src")
        _same_bits(got.src_b.numpy(), want["seg3"][kc:2 * kc], "src_b")
        # The rounds' views: [dest; src] sums, [src; dest] safe admits.
        _same_bits(got.lane_score.numpy(), want["score"][:kc], "lane_score")
        _same_bits(got.seg_both.numpy(), want["seg3"][:2 * kc], "seg_both")
        _same_bits(got.d_both.numpy(), want["d3"][:2 * kc], "d_both")
        _same_bits(got.seg_safe.numpy(), want["seg3"][kc:], "seg_safe")
        _same_bits(got.d_safe.numpy(), want["d3"][kc:], "d_safe")
        _same_bits(got.safe_score.numpy(), want["score"][:2 * kc], "safe_score")
        if legs:
            _same_bits(got.leg_score.numpy(), np.tile(want["score"][:kc], legs), "leg_score")
    assert (np.asarray(want["d3"]).view(np.uint32) == 0x80000000).any()  # -0.0 lanes


@pytest.mark.parametrize("topic", [False, True], ids=["no-topic", "topic"])
@pytest.mark.parametrize("frontier", [False, True], ids=["all-brokers", "frontier"])
def test_frontier_budgets_plain(frontier, topic):
    rng = np.random.default_rng(3 + 2 * frontier + topic)
    nb_full, T = 13, 5
    room, slack = (_budgets(rng, (nb_full, 8), 6.0, 0.2) for _ in range(2))
    slack[rng.random((nb_full, 8)) < 0.2] = 0.0  # -slack: -0.0
    tb = tuple(_budgets(rng, T * nb_full, 4.0, 0.25).round() for _ in range(3)) if topic \
        else None
    foc = None
    if frontier:
        active = np.zeros(nb_full, bool)
        active[[1, 4, 9, 12]] = True
        foc = topt._build_frontier(active, 8).full_of_compact.numpy()  # -1 pads
    gather = np.arange(nb_full) if foc is None else np.maximum(foc, 0)
    want_topic = None if tb is None else tuple(
        b.reshape(T, nb_full)[:, gather].reshape(-1) for b in tb)
    for fn in (sel.frontier_budgets_plain, sel.frontier_budgets):
        r, s, ns, tp, hi, lo = fn(_t(room), _t(slack), _t(foc), _tt(tb), T)
        _same_bits(r.numpy(), room[gather], "room")
        _same_bits(s.numpy(), slack[gather], "slack")
        _same_bits(ns.numpy(), -slack[gather], "neg_slack")
        if tb is None:
            assert tp is None and hi is None and lo is None
            continue
        for g, w in zip(tp, want_topic):
            _same_bits(g.numpy(), w, "topic budgets")
        _same_bits(hi.numpy(), np.stack([want_topic[0], np.full_like(want_topic[0], np.inf)],
                                        1), "hi_tb")
        _same_bits(lo.numpy(), np.stack([-want_topic[1], -want_topic[2]], 1), "lo_tb")


def test_k4e_wrappers_refuse_bad_inputs(models):
    jm, tm = models
    f, sel_idx, score, elig, lane, _ = _legs_case(jm, 2, True, False)
    cand = Candidates(**{n: torch.from_numpy(a) for n, a in f.items()})
    base = (cand, _t(sel_idx), _t(score), _t(elig), _t(lane), None, tm.replica_topic,
            tm.replica_is_leader, NB, 4)
    with pytest.raises(ValueError, match="legs"):
        sel.select_legs(*base, 3)
    with pytest.raises(ValueError, match="sel_idx"):
        sel.select_legs(cand, _t(sel_idx).long(), *base[2:], 2)
    with pytest.raises(ValueError, match="cand.delta_src"):
        sel.select_legs(Candidates(**dict(vars(cand), delta_src=cand.delta_src[:, :3])),
                        *base[1:], 2)
    with pytest.raises(ValueError, match="eligible"):
        sel.select_legs(cand, base[1], base[2], base[3][:-1], *base[4:], 2)
    room = torch.zeros(NB, 8)
    with pytest.raises(ValueError, match="room_dest"):
        sel.frontier_budgets(room[:, :4], room, None, None, 1)
    with pytest.raises(ValueError, match="gain_rep"):
        sel.frontier_budgets(room, room, None, (torch.zeros(5),) * 3, 1)
