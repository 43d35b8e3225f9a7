"""The per-segment row index that K1 and ``segment_sum`` walk on the card
(``ops.segment.segment_row_index``), on the CPU.

On the card the index is a stable counting sort built by hand, and one
warp a segment adds the segment's index rows in order, each column one
chain of float32 adds from 0.  Here the index's plain twin is held to its
definition (the kept rows of each segment, in increasing row order, -1 past
the last), and a float32 walk of it in numpy, in its order, gives the bits
of the plain twins (``masked_segment_sum``, ``broker_aggregates_plain``)
and of the JAX package's scatter-adds (``masked_segment_sum``, the model's
``broker_load``, ``potential_leadership_load``, ``broker_leader_bytes_in``
and counts, and the selection's round sums), exactly, at the XLA level the
tests run (tests/conftest.py).  The inputs are seeded numpy arrays and the
JAX package's generated 12-broker cluster, also with a fifth of its
replicas on broker 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.model.generator import ClusterSpec as JaxSpec
from cruise_control_tpu.model.generator import generate_cluster as jax_generate
from cruise_control_tpu.ops.segment import masked_segment_sum as jax_masked_segment_sum
from cruise_control_tpu_torch.ops import cuda
from cruise_control_tpu_torch.ops.segment import (broker_aggregates, broker_aggregates_plain,
                                                  index_tiling, index_warps,
                                                  masked_segment_sum,
                                                  segment_row_index, segment_row_index_plain,
                                                  segment_sum)
from tests.torch_port_helpers import SPEC_12, to_torch


def _case(name, rng):
    """(segment ids i32[N], mask bool[N], S) of index case ``name``."""
    n, S = 3000, 37
    seg = rng.integers(0, S, n)
    mask = rng.random(n) < 0.8
    if name == "empty_segments":      # only even segments hold rows
        seg = 2 * rng.integers(0, (S + 1) // 2, n)
    elif name == "all_masked":
        mask[:] = False
    elif name == "one_segment":
        S, seg = 1, np.zeros(n, np.int64)
    elif name == "no_rows":
        seg, mask = seg[:0], mask[:0]
    elif name == "out_of_range":      # ids past the end kept, negative ones masked
        seg = rng.integers(-3, S + 5, n)
        mask &= seg >= 0
    elif name == "skewed":            # a fifth of the rows on segment 0
        seg[rng.random(n) < 0.2] = 0
    return seg.astype(np.int32), mask, S


CASES = ("mixed", "empty_segments", "all_masked", "one_segment", "no_rows", "out_of_range",
         "skewed")


def _index_np(seg, mask, S):
    """The index by its definition: each segment's kept rows in increasing
    order, the offsets counting them, -1 past the last kept row."""
    kept = mask & (seg >= 0) & (seg < S)
    groups = [np.nonzero(kept & (seg == s))[0] for s in range(S)]
    offsets = np.concatenate([[0], np.cumsum([g.shape[0] for g in groups])]).astype(np.int32)
    rows = np.full(seg.shape[0], -1, np.int32)
    rows[:offsets[-1]] = np.concatenate(groups + [np.zeros(0, np.int64)])
    return offsets, rows


def _walk(values, offsets, rows):
    """f32[S, C]: each segment's index rows of ``values`` added in index
    order from 0 in float32, as the card's warp adds them."""
    S = offsets.shape[0] - 1
    out = np.zeros((S, values.shape[1]), np.float32)
    for s in range(S):
        acc = np.zeros(values.shape[1], np.float32)
        for r in rows[offsets[s]:offsets[s + 1]]:
            acc = acc + values[r]
        out[s] = acc
    return out


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _tensors(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("name", CASES)
def test_index_holds_each_segments_kept_rows_in_order(name):
    """Empty segments, all rows masked, one segment, no rows, ids outside
    [0, S) and a fifth of the rows on one segment: the plain twin and the
    wrapper on the CPU give the definition's offsets and rows."""
    seg, mask, S = _case(name, np.random.default_rng(CASES.index(name)))
    want_o, want_rows = _index_np(seg, mask, S)
    for o, rows in (segment_row_index_plain(*_tensors(seg, mask), S),
                    segment_row_index(*_tensors(seg, mask), S)):
        assert o.dtype == rows.dtype == torch.int32
        assert o.shape == (S + 1,) and rows.shape == seg.shape
        np.testing.assert_array_equal(o.numpy(), want_o)
        np.testing.assert_array_equal(rows.numpy(), want_rows)
    if name == "skewed":
        assert want_o[1] - want_o[0] >= 0.2 * int(mask.sum())


@pytest.mark.parametrize("channels", (1, 8, 16))
@pytest.mark.parametrize("name", CASES)
def test_index_walk_gives_the_plain_and_jax_segment_sums_bits(name, channels):
    """A float32 walk of the index in its order equals ``masked_segment_sum``
    (and ``segment_sum`` on the CPU) bit for bit, and the JAX package's
    ``masked_segment_sum`` on the same inputs."""
    rng = np.random.default_rng(100 + CASES.index(name))
    seg, mask, S = _case(name, rng)
    values = rng.normal(0.0, 50.0, (seg.shape[0], channels)).astype(np.float32)
    o, rows = (x.numpy() for x in segment_row_index_plain(*_tensors(seg, mask), S))
    walk = _walk(values, o, rows)
    tv, ts, tm = _tensors(values, seg, mask)
    np.testing.assert_array_equal(_bits(walk), _bits(masked_segment_sum(tv, ts, S, tm).numpy()))
    np.testing.assert_array_equal(_bits(walk), _bits(segment_sum(tv, ts, tm, S).numpy()))
    jax_out = jax_masked_segment_sum(jnp.asarray(values), jnp.asarray(seg), S, jnp.asarray(mask))
    np.testing.assert_array_equal(_bits(walk), _bits(np.asarray(jax_out)))


_MODELS = {}


def _model(label):
    """The JAX package's 12-broker cluster, or the same with a seeded fifth
    of its valid replicas on broker 0 and leaders flipped on a tenth."""
    if label not in _MODELS:
        jm = jax_generate(JaxSpec(**SPEC_12))
        if label == "skewed":
            rng = np.random.default_rng(5)
            rb = np.asarray(jm.replica_broker).copy()
            lead = np.asarray(jm.replica_is_leader).copy()
            valid = np.nonzero(np.asarray(jm.replica_valid))[0]
            rb[rng.choice(valid, valid.shape[0] // 5, replace=False)] = 0
            flip = rng.random(lead.shape[0]) < 0.1
            lead[flip] = ~lead[flip]
            jm = jm.replace(replica_broker=jnp.asarray(rb), replica_is_leader=jnp.asarray(lead))
        _MODELS[label] = jm
    return _MODELS[label]


@pytest.mark.parametrize("label", ("12", "skewed"))
def test_index_walk_gives_k1s_plain_and_jax_bits(label):
    """K1's walk in numpy over the per-broker index of the valid rows (six
    columns: load by leadership, potential NW_OUT, leaders' NW_IN; counts
    from the offsets and the leader flags) equals ``broker_aggregates_plain``
    and ``broker_aggregates`` on the CPU bit for bit, and the JAX model's
    ``broker_load``, ``potential_leadership_load``, ``broker_leader_bytes_in``,
    replica and leader counts."""
    jm = _model(label)
    tm = to_torch(jm)
    B = tm.num_brokers
    rb, valid = tm.replica_broker.numpy(), tm.replica_valid.numpy()
    lead = tm.replica_is_leader.numpy()
    ll, lf = tm.replica_load_leader.numpy(), tm.replica_load_follower.numpy()
    o, rows = (x.numpy() for x in segment_row_index_plain(tm.replica_broker,
                                                          tm.replica_valid, B))
    cols = np.concatenate([np.where(lead[:, None], ll, lf), ll[:, 2:3],
                           np.where(lead, ll[:, 1], 0.0)[:, None]], 1).astype(np.float32)
    walk = _walk(cols, o, rows)
    counts = np.diff(o)
    leaders = np.array([int(lead[rows[o[s]:o[s + 1]]].sum()) for s in range(B)])
    want = (walk[:, :4], counts, leaders, walk[:, 4], walk[:, 5])
    args = (tm.replica_broker, tm.replica_valid, tm.replica_is_leader, tm.replica_load_leader,
            tm.replica_load_follower, B)
    for got in (broker_aggregates_plain(*args), broker_aggregates(*args)):
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.astype(g.numpy().dtype)),
                                          err_msg=f"{label} column {i}")
    jax_want = (jm.broker_load(), jm.broker_replica_counts(), jm.broker_leader_counts(),
                jm.potential_leadership_load(), jm.broker_leader_bytes_in())
    for i, (w, j) in enumerate(zip(want, jax_want)):
        np.testing.assert_array_equal(_bits(w.astype(np.asarray(j).dtype)), _bits(np.asarray(j)),
                                      err_msg=f"{label} column {i} against JAX")
    if label == "skewed":
        assert counts[0] >= int(valid.sum()) // 5


def test_out_of_range_brokers_count_nowhere():
    """K1's plain twin drops valid rows on a broker outside [0, B), as the
    index does."""
    tm = to_torch(_model("12"))
    rb = tm.replica_broker.clone()
    rb[::7] = tm.num_brokers + 2
    args = (rb, tm.replica_valid, tm.replica_is_leader, tm.replica_load_leader,
            tm.replica_load_follower, tm.num_brokers)
    dropped = tm.replica_valid & (rb == tm.num_brokers + 2)
    want = broker_aggregates_plain(tm.replica_broker, tm.replica_valid & ~dropped,
                                   *args[2:])
    for g, w in zip(broker_aggregates_plain(*args), want):
        assert torch.equal(g, w)


def test_index_walk_gives_the_jax_round_sums_bits():
    """The selection's round sums: the port sums the dest legs then the src
    legs of the kept lanes (``segment_sum`` over the concatenation); the
    JAX package scatters the dest legs, then the src legs
    (``optimizer.py:663-668``).  The walk of the index over the
    concatenation gives both, bit for bit."""
    rng = np.random.default_rng(21)
    K, B, C = 4096, 24, 8
    dest_b = rng.integers(0, B, K).astype(np.int32)
    src_b = rng.integers(0, B, K).astype(np.int32)
    src_b[rng.random(K) < 0.2] = 0
    d_dest = rng.normal(0.0, 30.0, (K, C)).astype(np.float32)
    d_src = rng.normal(0.0, 30.0, (K, C)).astype(np.float32)
    k = rng.random(K) < 0.3
    d_both, seg_both = np.concatenate([d_dest, d_src]), np.concatenate([dest_b, src_b])
    o, rows = (x.numpy() for x in segment_row_index_plain(
        *_tensors(seg_both, np.concatenate([k, k])), B))
    walk = _walk(d_both, o, rows)
    port = segment_sum(*_tensors(d_both, seg_both, np.concatenate([k, k])), B)
    np.testing.assert_array_equal(_bits(walk), _bits(port.numpy()))
    km = jnp.asarray(k)[:, None]
    s = jnp.zeros((B, C), jnp.float32).at[jnp.where(jnp.asarray(k), jnp.asarray(dest_b), 0)].add(
        jnp.where(km, jnp.asarray(d_dest), 0.0))
    s = s.at[jnp.where(jnp.asarray(k), jnp.asarray(src_b), 0)].add(
        jnp.where(km, jnp.asarray(d_src), 0.0))
    np.testing.assert_array_equal(_bits(walk), _bits(np.asarray(s)))


def test_launch_counters_stay_at_zero_on_the_cpu():
    """The wrappers take the plain path for CPU tensors: no kernel runs."""
    tm = to_torch(_model("12"))
    names = ("segment_row_index", "broker_aggregates", "segment_sum", "segment_sum[round]")
    before = {n: cuda.COUNTED[n].launches for n in names}
    broker_aggregates(tm.replica_broker, tm.replica_valid, tm.replica_is_leader,
                      tm.replica_load_leader, tm.replica_load_follower, tm.num_brokers)
    segment_sum(tm.replica_load_leader, tm.replica_broker, tm.replica_valid, tm.num_brokers)
    segment_row_index(tm.replica_broker, tm.replica_valid, tm.num_brokers)
    assert {n: cuda.COUNTED[n].launches for n in names} == before


def test_index_build_tiles_fit_shared_memory():
    """Eight warps a build block up to some 6,400 segments, fewer beyond,
    and a clear error past what one warp's histogram can hold; 128 rows a
    warp unless the per-(segment, block) counts grow past 2**19, then 256."""
    assert index_warps(50) == index_warps(4000) == 8
    assert index_warps(7000) == 4
    assert index_warps(20000) == index_warps(28927) == 1
    with pytest.raises(ValueError, match="segments"):
        index_warps(28928)
    assert index_tiling(10233, 50) == (8, 128, 10)
    assert index_tiling(100371, 800) == (8, 128, 99)
    assert index_tiling(250863, 1000) == (8, 128, 245)
    assert index_tiling(250863, 4000) == (8, 256, 123)
    assert index_tiling(1_000_000, 8000) == (4, 256, 977)  # no wider tile
    assert index_tiling(0, 3) == (8, 128, 0)
    with pytest.raises(TypeError):
        segment_row_index(torch.zeros(4, dtype=torch.int64), torch.ones(4, dtype=torch.bool), 2)
