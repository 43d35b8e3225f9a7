"""K6 argsort (``ops/order.py`` ``argsort``; the card's ``csrc/argsort.cu``)
on the CPU.

- ``argsort_plain`` (the CPU path of ``argsort``) against
  ``jnp.argsort(..., stable=True)``, index for index, on seeded inputs and
  the edges: n = 0, 1, 2,048, 2,049, 4,096 and 4,097, every key equal, keys
  at ``num_keys - 1``, +0.0 / -0.0, +inf / -inf and NaN of both signs, the
  regroup of K3's 20,000 (topic, broker) keys; 1-D and along axis 1 (rows
  all equal, the xl250 [200, 1000] shape, a row wider than 2,048), int32
  and float32, with and without ``num_keys``.
- A numpy walk of ``cc_argsort`` and ``cc_row_argsort`` (the float and int
  key maps, the pass count from ``num_keys``, the one-block path, and above
  it every pass's digit counts up front and a one-sweep pass over tiles
  whose destinations come from the earlier tiles' counts; each tile ranked
  as ``rank_tile`` ranks it, by warp shares) against the plain twin on the
  same cases: the kernels' design, held where no card is.
- The wrapper refuses keys outside ``[0, num_keys)`` on CPU tensors, K3's
  scratch puts the int64 score order on an 8-byte boundary, and a numpy
  walk of K10's row-index build on the card (interleaved segment keys, the
  stable sort, the CSR kernel) equals its CPU build.

(The kernels themselves are held against ``argsort_plain`` bit for bit on
the card in ``chip_smoke.py``.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.analyzer.goals import kernels as gk
from cruise_control_tpu_torch.ops import order

SMALL, TILE, THREADS = 2048, 1024, 256


def _floats(rng, n):
    """Float keys with ties, signed zeros, infinities and NaN of both
    signs (the sites sort -score: a NaN's sign bit flips)."""
    x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, 3.0], np.float32), n)
    normal = rng.random(n) < 0.3
    x[normal] = rng.standard_normal(int(normal.sum()))
    nan = rng.random(n) < 0.05
    x[nan] = np.float32(np.nan)
    neg = nan & (rng.random(n) < 0.5)
    x.view(np.uint32)[neg] |= np.uint32(0x80000000)
    return x


def _case(name):
    """(keys, num_keys or None) of a 1-D edge."""
    rng = np.random.default_rng(len(name) * 31 + sum(map(ord, name)))
    if name.startswith("n="):
        n = int(name[2:])
        return rng.integers(0, 201, n).astype(np.int32), 201
    if name == "floats":
        return _floats(rng, 5000), None
    if name == "floats-small":
        return _floats(rng, 1500), None
    if name == "all-equal":
        return np.full(4097, 7, np.int32), 8
    if name == "all-equal-float":
        return np.full(3000, -0.0, np.float32), None
    if name == "top-key":  # every invalid row at num_keys - 1
        x = rng.integers(0, 200, 9000).astype(np.int32)
        x[rng.random(9000) < 0.3] = 200
        return x, 201
    if name == "pair":  # (topic, broker) keys, the invalid rows at T·B
        x = rng.integers(0, 20000, 30000).astype(np.int32)
        x[rng.random(30000) < 0.2] = 20000
        return x, 20001
    if name == "pair-xl250":  # three passes
        return rng.integers(0, 200001, 5000).astype(np.int32), 200001
    if name == "regroup":  # K3's 20,000 (topic, broker) segments, S + 1 keys
        return rng.integers(0, 20001, 65537).astype(np.int32), 20001
    if name == "int-full-range":
        x = rng.integers(-2 ** 31, 2 ** 31 - 1, 6000, dtype=np.int64).astype(np.int32)
        x[:40] = np.iinfo(np.int32).min
        x[40:80] = np.iinfo(np.int32).max
        return x, None
    if name == "one-key":
        return np.zeros(3000, np.int32), 1
    raise KeyError(name)


CASES = ["n=0", "n=1", "n=2048", "n=2049", "n=4096", "n=4097", "floats", "floats-small",
         "all-equal", "all-equal-float", "top-key", "pair", "pair-xl250", "regroup",
         "int-full-range", "one-key"]


def _rows(name):
    """An int32 [T, B] row case, as the builders pass -donor_cap etc."""
    rng = np.random.default_rng(len(name))
    if name == "large":
        return -rng.integers(0, 4, (100, 200)).astype(np.int32)
    if name == "all-equal":
        return np.zeros((7, 300), np.int32)
    if name == "xl250":
        return -rng.integers(0, 6, (200, 1000)).astype(np.int32)
    if name == "wide":  # above one block a row: two cc_argsort passes
        return rng.integers(-50, 50, (3, 2500)).astype(np.int32)
    if name == "full-range":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, (4, 600), dtype=np.int64).astype(np.int32)
    raise KeyError(name)


ROW_CASES = ["large", "all-equal", "xl250", "wide", "full-range"]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    x, num_keys = _case(name)
    want = np.asarray(jnp.argsort(jnp.asarray(x), stable=True))
    got = order.argsort(torch.from_numpy(x), num_keys=num_keys)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(order.argsort(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", ROW_CASES + ["floats"])
def test_plain_rows_match_jax(name):
    x = _floats(np.random.default_rng(2), 4 * 700).reshape(4, 700) if name == "floats" \
        else _rows(name)
    want = np.asarray(jnp.argsort(jnp.asarray(x), axis=1, stable=True))
    got = order.argsort(torch.from_numpy(x), dim=1, mode="rows")
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# A numpy walk of cc_argsort and cc_row_argsort (csrc/argsort.cu, radix.cuh)
# ---------------------------------------------------------------------------

def _sort_key(x, num_keys):
    """The uint32 key whose ascending order is the sort's."""
    b = x.view(np.uint32).copy()
    if x.dtype == np.int32:
        return b if num_keys is not None else b ^ np.uint32(0x80000000)
    nan = (b & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    b[b == np.uint32(0x80000000)] = 0
    k = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000)).astype(np.uint32)
    k[nan] = np.uint32(0xFFFFFFFF)
    return k


def _walk_tile(keys, ids, shift, start, out_keys, out_ids, lo, count, steps):
    """rank_tile: warp w owns the tile's items [w·32·steps, (w+1)·32·steps)
    from ``lo``; each warp counts its share's digits, digit d's first
    destination for warp w is ``start[d]`` plus the counts of the warps
    before it, and each warp then places its share in order."""
    share = 32 * steps
    dig = ((keys[lo:lo + count] >> np.uint32(shift)) & np.uint32(0xFF)).astype(np.int64)
    counts = np.stack([np.bincount(dig[w * share:(w + 1) * share], minlength=256)
                       for w in range(THREADS // 32)])
    offs = start[None, :] + np.cumsum(counts, 0) - counts
    for i in range(count):
        w, d = i // share, dig[i]
        out_keys[offs[w, d]], out_ids[offs[w, d]] = keys[lo + i], ids[lo + i]
        offs[w, d] += 1


def _walk_argsort(x, num_keys=None):
    """One block up to SMALL entries (ceil(m / 256) steps a warp, the
    tile's own counts scanned); else every pass's digit counts from one histogram of the
    input, then a one-sweep launch a pass over tiles of TILE (4 steps a
    warp), each tile's destinations the digit's base plus its count in the
    earlier tiles (the look-back); the pass count from ``num_keys``."""
    keys, ids = _sort_key(x, num_keys), np.arange(x.size, dtype=np.int64)
    m = keys.size
    passes = order.argsort_passes(num_keys)
    counts = [np.bincount((keys >> np.uint32(8 * p)) & np.uint32(0xFF), minlength=256)
              for p in range(passes)]
    for p in range(passes):
        shift = 8 * p
        dig = (keys >> np.uint32(shift)) & np.uint32(0xFF)
        out_keys, out_ids = np.zeros_like(keys), np.zeros_like(ids)
        base = np.concatenate([[0], np.cumsum(counts[p])[:-1]])
        if m <= SMALL:
            _walk_tile(keys, ids, shift, base, out_keys, out_ids, 0, m, -(-m // THREADS))
        else:
            before = np.zeros(256, np.int64)
            for lo in range(0, m, TILE):
                _walk_tile(keys, ids, shift, base + before, out_keys, out_ids, lo,
                           min(TILE, m - lo), TILE // THREADS)
                before += np.bincount(dig[lo:lo + TILE], minlength=256)
        keys, ids = out_keys, out_ids
    return ids, keys


@pytest.mark.parametrize("name", ["n=1", "n=2048", "n=2049", "n=4097", "floats",
                                  "floats-small", "all-equal", "top-key", "pair",
                                  "pair-xl250", "int-full-range", "one-key"])
def test_kernel_walk_equals_plain(name):
    x, num_keys = _case(name)
    want = order.argsort_plain(torch.from_numpy(x), num_keys=num_keys).numpy()
    ids, keys = _walk_argsort(x, num_keys)
    np.testing.assert_array_equal(ids, want)
    if num_keys is not None:  # the sorted keys the regroup hands cc_sorted_offsets
        np.testing.assert_array_equal(keys.view(np.int32), x[want])


@pytest.mark.parametrize("name", ["large", "all-equal", "full-range"])
def test_row_kernel_walk_equals_plain(name):
    """One block a row, four passes of the sign-flipped int32 key."""
    x = _rows(name)
    want = order.argsort_plain(torch.from_numpy(x), dim=1).numpy()
    got = np.stack([_walk_argsort(row)[0] for row in x])
    np.testing.assert_array_equal(got, want)


def test_wide_rows_as_two_sorts():
    """Above 2,048 a row the wrapper sorts by key, then stably by row."""
    x = _rows("wide")
    T, B = x.shape
    by_key = _walk_argsort(x.reshape(-1))[0]
    by_row = _walk_argsort((by_key // B).astype(np.int32), T)[0]
    got = by_key[by_row].reshape(T, B) - np.arange(T)[:, None] * B
    np.testing.assert_array_equal(got, order.argsort_plain(torch.from_numpy(x), dim=1).numpy())


def test_key_maps_and_passes():
    """-0.0 and +0.0 share a key, every NaN sits above +inf, int keys keep
    their order; passes and scratch as the C entry checks them."""
    x = np.array([-np.inf, -1.0, -0.0, 0.0, 1e-45, np.inf, np.nan], np.float32)
    neg_nan = np.array([np.nan], np.float32)
    neg_nan.view(np.uint32)[0] |= np.uint32(0x80000000)
    k = _sort_key(np.concatenate([x, neg_nan]), None)
    assert (np.diff(k[:6].astype(np.int64)) >= 0).all() and k[2] == k[3]
    assert k[6] == k[7] == 0xFFFFFFFF > k[5]
    ints = np.array([np.iinfo(np.int32).min, -1, 0, 1, np.iinfo(np.int32).max], np.int32)
    assert (np.diff(_sort_key(ints, None).astype(np.int64)) > 0).all()
    assert [order.argsort_passes(n) for n in (None, 1, 2, 201, 256, 257, 20001, 200001,
                                              2 ** 24 + 1)] == [4, 1, 1, 1, 1, 2, 2, 3, 4]
    assert order.argsort_work_words(2048) == 0
    assert order.argsort_work_words(65536) == 8 + 4 * 256 + 4 * 256 * 64 + 4 * 65536


def test_wrapper_checks_and_records():
    """Keys outside [0, num_keys) raise on CPU tensors; num_keys takes int32
    only; modes are the call sites; each call records its form."""
    x = torch.tensor([0, 3, 5, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        order.argsort(x, num_keys=5)
    with pytest.raises(ValueError, match="outside"):
        order.argsort(torch.tensor([-1, 0], dtype=torch.int32), num_keys=3)
    with pytest.raises(TypeError, match="int32"):
        order.argsort(torch.zeros(3), num_keys=4)
    with pytest.raises(ValueError, match="mode"):
        order.argsort(x, mode="nowhere")
    assert order.argsort(x, num_keys=6).tolist() == [0, 3, 1, 2]
    assert order.argsort(x, descending=True).tolist() == [2, 1, 3, 0]
    from cruise_control_tpu_torch.ops import cuda
    cuda.CAPTURE = {}
    try:
        order.argsort(x, num_keys=6, mode="broker")
        order.argsort(x.reshape(2, 2), dim=1, mode="rows")
        assert {"argsort", "argsort[broker]", "row_argsort", "row_argsort[rows]"} <= \
            set(cuda.CAPTURE)
    finally:
        cuda.CAPTURE = None


def test_k3_scratch_aligns_the_score_order():
    """The int64 score order starts on an even int32 word whatever (K, S,
    C); the regroup's keys appear above COUNTING_MAX_SEGMENTS only."""
    for K, S, C in ((4097, 60, 8), (4097, 61, 3), (65537, 20000, 2), (7, 5, 1)):
        sizes = gk.prefix_cut_scratch(K, S, C)
        assert sum(sizes[:10]) % 2 == 0 and sizes[10] == 2 * K
        assert sizes[11] == order.argsort_work_words(K)
        assert sizes[12] == sizes[13] == (K if S > gk.COUNTING_MAX_SEGMENTS else 0)


def _walk_blend_index(before, after, valid, S):
    """K10's row-index build on the card: index_keys_kernel's interleaved
    int32 keys, the stable sort (num_keys = S + 1), index_offsets_kernel."""
    R = before.size
    segs = np.stack([before, after], 1) if after is not None else before[:, None]
    held = valid[:, None] & (segs >= 0) & (segs < S)
    if after is not None:
        held[:, 1] &= after != before
    keys = np.where(held, segs, S).reshape(-1).astype(np.int32)
    pos, sorted_keys = _walk_argsort(keys, S + 1)
    rows = (pos >> (1 if after is not None else 0)).astype(np.int32)
    sk = sorted_keys.view(np.int32)
    offsets = np.searchsorted(sk, np.arange(S + 1), side="left").astype(np.int32)
    assert rows.size == (2 * R if after is not None else R)
    return offsets, rows


@pytest.mark.parametrize("with_after", [True, False])
def test_blend_index_walk_equals_cpu_build(with_after):
    rng = np.random.default_rng(11)
    R, S = 6000, 40
    before = rng.integers(-1, S + 2, R).astype(np.int32)
    after = np.where(rng.random(R) < 0.3, rng.integers(0, S, R), before).astype(np.int32)
    valid = rng.random(R) < 0.9
    a = after if with_after else None
    want = gk.blend_row_index(torch.from_numpy(before), None if a is None else
                              torch.from_numpy(a), torch.from_numpy(valid), S)
    offsets, rows = _walk_blend_index(before, a, valid, S)
    np.testing.assert_array_equal(offsets, want[0].numpy())
    np.testing.assert_array_equal(rows, want[1].numpy())
