"""The per-segment row index that K10's blend kernels walk
(``kernels.blend_row_index``), on the CPU.

On the card, ``blend_aggregates`` and ``blend_disk_load`` give each
(segment, blend) one thread that walks the segment's index rows in order
and keeps the rows the blend puts on the segment.  Here the index is held
to its definition (the rows whose before-segment is the segment, and those
whose after-segment is it and differs from the before-segment, in
increasing row order, with the right offsets), each blend's members of a
segment are its index rows filtered by the landed test, and a float32 walk
of the index in numpy, in its order, gives the plain twins' bits (and the
JAX package's aggregates of each blend).  Brokers: the JAX solves of
tests/test_torch_placement_score.py's ``solved`` fixture, and a skewed
after-placement with a fifth of the replicas on one broker.  Disks: the
JBOD model of tests/test_torch_intra_disk.py, healthy and with dead disks,
blended with a seeded placement that moves replicas between disks of their
broker and onto other brokers' disks."""

import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.state import BrokerArrays as JaxBrokerArrays
from cruise_control_tpu_torch.analyzer.goals import kernels as gk
from tests.test_torch_placement_score import SIZES, _masks, solved  # noqa: F401
from tests.torch_port_helpers import jbod_model, to_torch

DISK_SPEC = dict(num_brokers=8, num_racks=4, num_topics=5, mean_partitions_per_topic=16.0,
                 replication_factor=3, seed=3)
DISK_CASES = {"healthy": (), "dead": (2, 5)}
BLENDS = (1, 5, 32)

_DISK_MODELS = {}


def _np(t):
    return t.cpu().numpy()


def _skewed(tm, seed=5, share=0.2):
    """``tm`` with a seeded ``share`` of its valid replicas moved to broker 0
    and leaders flipped on a tenth: one long segment."""
    rng = np.random.default_rng(seed)
    rb, lead = _np(tm.replica_broker).copy(), _np(tm.replica_is_leader).copy()
    valid = np.nonzero(_np(tm.replica_valid))[0]
    rb[rng.choice(valid, int(share * valid.shape[0]), replace=False)] = 0
    flip = rng.random(lead.shape[0]) < 0.1
    lead[flip] = ~lead[flip]
    return tm.with_placement(torch.from_numpy(rb), torch.from_numpy(lead))


def _disk_models(case):
    """(port JBOD model, a seeded after-placement of it): a third of the
    replicas on another disk of their broker, a tenth on a disk of another
    broker, leaders flipped on a tenth."""
    if case not in _DISK_MODELS:
        tm = to_torch(jbod_model(DISK_SPEC, dead=DISK_CASES[case]))
        rng = np.random.default_rng(9)
        rb, rd = _np(tm.replica_broker).copy(), _np(tm.replica_disk).copy()
        lead = _np(tm.replica_is_leader).copy()
        disks, valid = _np(tm.broker_disks), _np(tm.replica_valid)
        intra = np.nonzero(valid & (rng.random(rd.shape[0]) < 0.3))[0]
        rd[intra] = disks[rb[intra], rng.integers(0, disks.shape[1], intra.shape[0])]
        inter = np.nonzero(valid & (rng.random(rd.shape[0]) < 0.1))[0]
        rb[inter] = rng.integers(0, tm.num_brokers, inter.shape[0])
        rd[inter] = disks[rb[inter], rng.integers(0, disks.shape[1], inter.shape[0])]
        flip = rng.random(lead.shape[0]) < 0.1
        lead[flip] = ~lead[flip]
        ta = tm.with_placement(torch.from_numpy(rb), torch.from_numpy(lead),
                               torch.from_numpy(rd))
        _DISK_MODELS[case] = (tm, ta)
    return _DISK_MODELS[case]


def _broker_pairs(solved):  # noqa: F811
    out = {}
    for size in SIZES:
        _, _, tm, ta = solved(size)
        out[size] = (tm, ta)
    _, _, tm, _ = solved("12")
    out["skewed"] = (tm, _skewed(tm))
    return out


def _segments(tm, ta, disks):
    f = "replica_disk" if disks else "replica_broker"
    return (getattr(tm, f), getattr(ta, f), tm.num_disks if disks else tm.num_brokers)


def _check_index(tm, ta, disks):
    before, after, S = _segments(tm, ta, disks)
    offsets, rows = gk.blend_row_index(before, after, tm.replica_valid, S)
    assert offsets.dtype == rows.dtype == torch.int32
    assert offsets.shape == (S + 1,)
    o, rows = _np(offsets), _np(rows)
    b, a, v = _np(before), _np(after), _np(tm.replica_valid)
    assert o[0] == 0 and (np.diff(o) >= 0).all()
    assert rows.shape[0] <= 2 * b.shape[0]
    for s in range(S):
        want = np.nonzero(v & ((b == s) | ((a == s) & (a != b))))[0]
        np.testing.assert_array_equal(rows[o[s]:o[s + 1]], want, err_msg=f"segment {s}")
    moved = int((v & (a != b) & (a >= 0) & (a < S)).sum())
    assert o[S] == int((v & (b >= 0) & (b < S)).sum()) + moved
    return o, rows


def test_broker_index_holds_the_union_rows_in_order(solved):  # noqa: F811
    """Per broker: the valid rows it holds before, then the valid rows that
    move onto it, merged in increasing row order; the offsets count them."""
    for label, (tm, ta) in _broker_pairs(solved).items():
        o, _ = _check_index(tm, ta, disks=False)
        if label == "skewed":
            assert o[1] - o[0] >= int(0.2 * int(tm.replica_valid.sum()))


@pytest.mark.parametrize("case", list(DISK_CASES))
def test_disk_index_holds_the_union_rows_in_order(case):
    tm, ta = _disk_models(case)
    assert bool((tm.replica_disk != ta.replica_disk).any())
    _check_index(tm, ta, disks=True)


def test_index_edges():
    """Rows outside every segment, invalid rows, no after placement and an
    empty axis."""
    b = torch.tensor([0, 1, 2, 0, 5, 1, -1], dtype=torch.int32)
    a = torch.tensor([1, 1, 0, 0, 2, 3, 1], dtype=torch.int32)
    v = torch.tensor([1, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    o, rows = gk.blend_row_index(b, a, v, 4)
    assert o.tolist() == [0, 2, 6, 8, 9]
    assert rows[:9].tolist() == [0, 2, 0, 1, 5, 6, 2, 4, 5]
    o, rows = gk.blend_row_index(b, None, v, 4)
    assert o.tolist() == [0, 1, 3, 4, 4] and rows[:4].tolist() == [0, 1, 5, 2]
    empty = torch.zeros(0, dtype=torch.int32)
    o, rows = gk.blend_row_index(empty, empty, torch.zeros(0, dtype=torch.bool), 3)
    assert o.tolist() == [0, 0, 0, 0] and rows.numel() == 0


def test_topic_index_and_masks_by_partition(solved):  # noqa: F811
    """``blend_indexes``: the per-topic index holds each topic's valid rows
    in row order, the broker index is ``blend_row_index``'s, and the masks
    come transposed."""
    _, _, tm, ta = solved("12")
    masks = torch.from_numpy(_masks(tm.num_partitions, 5, seed=4))
    masks_t, (o, rows), (to, trows) = gk.blend_indexes(tm, ta, masks, topics=True)
    assert masks_t.shape == (tm.num_partitions, 8) and masks_t.is_contiguous()
    assert torch.equal(masks_t[:, :5], masks.t()) and not masks_t[:, 5:].any()
    want = gk.blend_row_index(tm.replica_broker, ta.replica_broker, tm.replica_valid,
                              tm.num_brokers)
    assert torch.equal(o, want[0]) and torch.equal(rows, want[1])
    topic, valid, to, trows = _np(tm.replica_topic), _np(tm.replica_valid), _np(to), _np(trows)
    assert to[-1] == int(valid.sum())
    for t in range(tm.num_topics):
        np.testing.assert_array_equal(trows[to[t]:to[t + 1]],
                                      np.nonzero(valid & (topic == t))[0])
    assert gk.blend_indexes(tm, ta, masks)[2] is None


def _landed(tm, masks, idx):
    """bool[C, n]: blend c lands index row idx[j] (the partition clamped as
    the JAX gather clamps)."""
    part = np.clip(_np(tm.replica_partition)[idx], 0, masks.shape[1] - 1)
    return masks[:, part]


def _check_members(tm, ta, masks, disks):
    before, after, S = _segments(tm, ta, disks)
    o, rows = (_np(x) for x in gk.blend_row_index(before, after, tm.replica_valid, S))
    b, a, v = _np(before), _np(after), _np(tm.replica_valid)
    part = np.clip(_np(tm.replica_partition), 0, masks.shape[1] - 1)
    blended = np.where(masks[:, part], a[None, :], b[None, :])
    for s in range(S):
        idx = rows[o[s]:o[s + 1]]
        kept = np.where(_landed(tm, masks, idx), a[idx][None, :], b[idx][None, :]) == s
        for c in range(masks.shape[0]):
            want = np.nonzero(v & (blended[c] == s))[0]
            np.testing.assert_array_equal(idx[kept[c]], want, err_msg=f"blend {c} seg {s}")


@pytest.mark.parametrize("c", BLENDS)
def test_blend_members_are_the_filtered_index_rows(solved, c):  # noqa: F811
    """For every blend and segment, the valid rows the blend puts on the
    segment are exactly the segment's index rows that pass the landed test,
    in the same order."""
    for label, (tm, ta) in _broker_pairs(solved).items():
        _check_members(tm, ta, _masks(tm.num_partitions, c, seed=c), disks=False)
    for case in DISK_CASES:
        tm, ta = _disk_models(case)
        _check_members(tm, ta, _masks(tm.num_partitions, c, seed=c + 1), disks=True)


def _walk_aggregates(tm, ta, masks):
    """The aggregates kernel's walk in numpy: per (broker, blend), the index
    rows in order, the kept ones' six floats added one by one in float32
    from 0; counts and (topic, broker) counts as integers."""
    C, B, T = masks.shape[0], tm.num_brokers, tm.num_topics
    o, rows = (_np(x) for x in gk.blend_row_index(tm.replica_broker, ta.replica_broker,
                                                  tm.replica_valid, B))
    b, a = _np(tm.replica_broker), _np(ta.replica_broker)
    lb, la = _np(tm.replica_is_leader), _np(ta.replica_is_leader)
    ll, lf, topic = _np(tm.replica_load_leader), _np(tm.replica_load_follower), \
        _np(tm.replica_topic)
    sums = np.zeros((C, B, 6), np.float32)
    counts = np.zeros((2, C, B), np.int32)
    topics = np.zeros((2, C, T, B), np.int32)
    for s in range(B):
        idx = rows[o[s]:o[s + 1]]
        landed = _landed(tm, masks, idx)
        kept = np.where(landed, a[idx][None, :], b[idx][None, :]) == s
        lead = np.where(landed, la[idx][None, :], lb[idx][None, :])
        vals = np.concatenate([np.where(lead[..., None], ll[idx][None], lf[idx][None]),
                               np.broadcast_to(ll[idx][None, :, 2:3], lead.shape + (1,)),
                               np.where(lead, ll[idx][None, :, 1], 0)[..., None]],
                              -1).astype(np.float32)
        acc = np.zeros((C, 6), np.float32)
        for j in range(idx.shape[0]):
            acc = np.where(kept[:, j, None], acc + vals[:, j], acc)
        sums[:, s] = acc
        counts[0, :, s] = kept.sum(1)
        counts[1, :, s] = (kept & lead).sum(1)
        for c in range(C):
            np.add.at(topics[0, c, :, s], topic[idx][kept[c]], 1)
            np.add.at(topics[1, c, :, s], topic[idx][kept[c] & lead[c]], 1)
    return sums, counts, topics


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("c", BLENDS)
def test_index_walk_gives_the_plain_aggregates_bits(solved, c):  # noqa: F811
    """The walk's sums equal ``blend_aggregates_plain``'s bit for bit (and
    the JAX package's ``BrokerArrays.from_model`` of each blend), its counts
    and (topic, broker) counts exactly: the kernel's order is the plain
    version's."""
    for label, (tm, ta) in _broker_pairs(solved).items():
        masks = _masks(tm.num_partitions, c, seed=10 + c)
        sums, counts, topics = _walk_aggregates(tm, ta, masks)
        ref = gk.blend_aggregates_plain(tm, ta, torch.from_numpy(masks), True, True)
        got = (sums[..., :4], counts[0], counts[1], sums[..., 4], sums[..., 5], topics[0],
               topics[1])
        for i, (g, r) in enumerate(zip(got, ref)):
            np.testing.assert_array_equal(_bits(g), _bits(_np(r)), err_msg=f"{label} {i}")
        if label == "skewed":
            continue
        jm = solved(label)[0]
        for k in range(c):
            blend = gk.blend_placement(tm, ta, torch.from_numpy(masks[k]))
            jb = jm.replace(replica_broker=_np(blend.replica_broker),
                            replica_is_leader=_np(blend.replica_is_leader))
            jarr = JaxBrokerArrays.from_model(jb)
            for g, r in ((sums[k, :, :4], jarr.load), (counts[0, k], jarr.replica_count),
                         (counts[1, k], jarr.leader_count),
                         (sums[k, :, 4], jarr.potential_nw_out),
                         (sums[k, :, 5], jarr.leader_bytes_in),
                         (topics[0, k], jb.topic_broker_replica_counts()),
                         (topics[1, k], jb.topic_leader_counts())):
                np.testing.assert_array_equal(_bits(g), _bits(np.asarray(r)),
                                              err_msg=f"{label} blend {k} against JAX")


@pytest.mark.parametrize("c", BLENDS)
@pytest.mark.parametrize("case", list(DISK_CASES))
def test_index_walk_gives_the_plain_disk_load_bits(case, c):
    """The disk-loads kernel's walk in numpy, per (disk, blend) the kept
    rows' DISK load added in index order from 0 in float32, equals
    ``blend_disk_load_plain`` bit for bit (and each blend's ``disk_load``)."""
    tm, ta = _disk_models(case)
    masks = _masks(tm.num_partitions, c, seed=20 + c)
    D = tm.num_disks
    o, rows = (_np(x) for x in gk.blend_row_index(tm.replica_disk, ta.replica_disk,
                                                  tm.replica_valid, D))
    b, a = _np(tm.replica_disk), _np(ta.replica_disk)
    lb, la = _np(tm.replica_is_leader), _np(ta.replica_is_leader)
    ll, lf = _np(tm.replica_load_leader)[:, 3], _np(tm.replica_load_follower)[:, 3]
    walk = np.zeros((c, D), np.float32)
    for d in range(D):
        idx = rows[o[d]:o[d + 1]]
        landed = _landed(tm, masks, idx)
        kept = np.where(landed, a[idx][None, :], b[idx][None, :]) == d
        val = np.where(np.where(landed, la[idx][None, :], lb[idx][None, :]),
                       ll[idx][None, :], lf[idx][None, :]).astype(np.float32)
        acc = np.zeros(c, np.float32)
        for j in range(idx.shape[0]):
            acc = np.where(kept[:, j], acc + val[:, j], acc)
        walk[:, d] = acc
    ref = _np(gk.blend_disk_load_plain(tm, ta, torch.from_numpy(masks)))
    np.testing.assert_array_equal(_bits(walk), _bits(ref))
    for k in range(c):
        blend = gk.blend_placement(tm, ta, torch.from_numpy(masks[k]))
        np.testing.assert_array_equal(_bits(walk[k]), _bits(_np(blend.disk_load())))
