"""K6 top-k (``ops/order.py`` ``top_k``, ``masked_top_k``; the card's
``csrc/top_k.cu``) on the CPU.

- ``top_k_plain`` against ``jax.lax.top_k``, exactly (index for index, value
  bits), on seeded inputs and the edges: k == n, k == 1, n not a multiple of
  32, every key equal, every key -inf, +0.0 / -0.0 and -big ties, sizes on
  both sides of the kernel's one-block limit (2,048) and tile (4,096), and
  int32 keys (the room order's counts; INT32_MIN ties).
- A numpy walk of ``cc_top_k``'s steps (the 8-bit radix select with its
  last-block digit picks, the tiles' (lt, eq) counts and the ordered
  compaction, the stable LSD radix sort by tiles and rounds of 256 ranked
  by digit) against ``top_k_plain`` on the same cases: the kernel's design,
  held where no card is.
- ``top_k`` and ``masked_top_k`` on CPU tensors equal their plain twin (the
  masked form: ``where(mask, x, -inf)`` and the mask's count) and refuse
  what the kernel does not take.

(The kernel itself is held against ``top_k_plain`` bit for bit on the card
in ``chip_smoke.py``.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu_torch.ops import order

BIG = np.float32(1e30)


def _case(name, seed=0):
    """(x f32[n], k) of an edge."""
    rng = np.random.default_rng(seed + 7 * len(name))
    if name == "mixed":
        return rng.standard_normal(1000).astype(np.float32), 37
    if name == "k-eq-n":
        return rng.standard_normal(777).astype(np.float32), 777
    if name == "k-1":
        return rng.standard_normal(513).astype(np.float32), 1
    if name == "n-odd":
        return (rng.integers(-20, 20, 1001) / 4).astype(np.float32), 100
    if name == "all-equal":
        return np.full(3000, 2.5, np.float32), 1000
    if name == "all-neg-inf":
        return np.full(5000, -np.inf, np.float32), 4097
    if name == "signed-zeros":
        x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, -BIG], np.float32), 2500)
        return x.astype(np.float32), 1500
    if name == "minus-big-ties":
        x = np.where(rng.random(9000) < 0.9, -BIG, rng.integers(0, 5, 9000)).astype(np.float32)
        return x, 2048
    if name == "compaction":  # K4's form: ~half masked at -inf, k a power of two
        x = (rng.integers(1, 40, 20000) / 4.0).astype(np.float32)
        x[rng.random(20000) < 0.5] = -np.inf
        return x, 8192
    if name == "sources":  # the builders' form: relevance with -1e30 tails, k << n
        x = np.where(rng.random(12000) < 0.3, rng.standard_normal(12000), -BIG)
        return x.astype(np.float32), 800
    if name == "full-large":  # k == n above one block (room_order at 7,000 brokers)
        return (rng.integers(0, 50, 7000)).astype(np.float32), 7000
    if name == "int32-room":  # the room order: int32 counts, k == n
        return rng.integers(-3, 40, 200).astype(np.int32), 200
    if name == "int32-large":
        x = rng.integers(-2**31, 2**31 - 1, 9000, dtype=np.int64).astype(np.int32)
        x[:50] = np.iinfo(np.int32).min
        return x, 3000
    raise KeyError(name)


CASES = ["mixed", "k-eq-n", "k-1", "n-odd", "all-equal", "all-neg-inf", "signed-zeros",
         "minus-big-ties", "compaction", "sources", "full-large", "int32-room",
         "int32-large"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


@pytest.mark.parametrize("name", CASES)
def test_top_k_plain_matches_jax(name):
    x, k = _case(name)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = order.top_k_plain(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(np.asarray(jv)))


# ---------------------------------------------------------------------------
# A numpy walk of cc_top_k (csrc/top_k.cu)
# ---------------------------------------------------------------------------

TILE, SMALL, THREADS, ITEMS = 4096, 2048, 256, 16
SWEEP_TILE = 1024  # the one-sweep sort's tile (csrc/radix.cuh)


def _desc_key(v):
    b = np.asarray(v).view(np.uint32)
    if v.dtype == np.int32:
        return b ^ np.uint32(0x7FFFFFFF)
    return np.where(b & np.uint32(0x80000000), b, ~b & np.uint32(0x7FFFFFFF)).astype(np.uint32)


def _walk_select(d, k):
    """The four select launches: (T, need)."""
    prefix, want = np.uint32(0), k
    for p in range(4):
        shift = 24 - 8 * p
        high = np.uint32(0) if p == 0 else np.uint32((0xFFFFFFFF << (32 - 8 * p)) & 0xFFFFFFFF)
        hist = np.zeros(256, np.int64)
        for lo in range(0, d.size, TILE):  # a block's tile, added into the global histogram
            t = d[lo:lo + TILE]
            m = (t & high) == prefix
            hist += np.bincount((t[m] >> np.uint32(shift)) & np.uint32(0xFF), minlength=256)
        acc, digit = 0, 255
        for b in range(256):  # the last block's pick
            if acc + hist[b] >= want:
                digit = b
                break
            acc += hist[b]
        prefix = np.uint32(prefix | (digit << shift))
        want -= acc
    return prefix, want


def _walk_compact(d, t, need):
    """The count and compaction launches: the winners' (keys, indices)."""
    n = d.size
    lt_eq = np.where(d < t, 1 << 16, np.where(d == t, 1, 0)).astype(np.int64)
    tiles = [int(lt_eq[lo:lo + TILE].sum()) for lo in range(0, n, TILE)]
    keys = np.zeros(n, np.uint32)
    idx = np.full(n, -1, np.int64)
    written = 0
    for b, lo in enumerate(range(0, n, TILE)):
        before_lt = sum(c >> 16 for c in tiles[:b])
        before_eq = sum(c & 0xFFFF for c in tiles[:b])
        eq_room = max(need - before_eq, 0)
        base = before_lt + min(before_eq, need)
        # A thread's kItems entries, its exclusive (lt, eq) from the block scan.
        sums = [int(lt_eq[s:min(n, s + ITEMS)].sum()) for s in range(lo, lo + TILE, ITEMS)]
        scan = np.concatenate([[0], np.cumsum(sums)[:-1]])
        for th, s in enumerate(range(lo, lo + TILE, ITEMS)):
            mine = int(scan[th])
            for i in range(s, min(n, s + ITEMS)):
                lt, eq = mine >> 16, mine & 0xFFFF
                if d[i] < t or (d[i] == t and eq < eq_room):
                    pos = base + lt + min(eq, eq_room)
                    keys[pos], idx[pos] = d[i], i
                    written += 1
                mine += int(lt_eq[i])
    return keys[:written], idx[:written]


def _walk_rounds(keys, idx, shift, run, out_keys, out_idx, lo, hi):
    """Rounds of 256 items from ``lo`` in index order, each item to the next
    slot of its digit (the warp-matched stable rank)."""
    for r0 in range(lo, hi, THREADS):
        for i in range(r0, min(hi, r0 + THREADS)):
            dg = (int(keys[i]) >> shift) & 0xFF
            out_keys[run[dg]], out_idx[run[dg]] = keys[i], idx[i]
            run[dg] += 1


def _walk_sort(keys, idx):
    """The LSD radix sort: one block up to SMALL items, else the one-sweep
    sort: every pass's digit counts from one histogram of the items, then a
    launch a pass over tiles of SWEEP_TILE, each tile's destinations the
    digit's base plus its count in the earlier tiles (the look-back)."""
    m = keys.size
    counts = [np.bincount((keys >> np.uint32(8 * p)) & np.uint32(0xFF), minlength=256)
              for p in range(4)]
    for p in range(4):
        shift = 8 * p
        dig = (keys >> np.uint32(shift)) & np.uint32(0xFF)
        out_keys, out_idx = np.zeros_like(keys), np.zeros_like(idx)
        base = np.concatenate([[0], np.cumsum(counts[p])[:-1]])
        if m <= SMALL:
            _walk_rounds(keys, idx, shift, base.copy(), out_keys, out_idx, 0, m)
        else:
            before = np.zeros(256, np.int64)
            for lo in range(0, m, SWEEP_TILE):
                _walk_rounds(keys, idx, shift, base + before, out_keys, out_idx, lo,
                             min(m, lo + SWEEP_TILE))
                before += np.bincount(dig[lo:lo + SWEEP_TILE], minlength=256)
        keys, idx = out_keys, out_idx
    return keys, idx


def _walk_top_k(x, k, mask=None):
    v = x if mask is None else np.where(mask, x, np.float32(-np.inf)).astype(np.float32)
    d = _desc_key(v)
    n = d.size
    if n <= SMALL:
        _, idx = _walk_sort(d, np.arange(n))
    elif k == n:
        _, idx = _walk_sort(d, np.arange(n))
    else:
        t, need = _walk_select(d, k)
        assert 1 <= need and int((d < t).sum()) + need == k
        keys, idx = _walk_compact(d, t, need)
        assert keys.size == k and (np.diff(idx) > 0).all()  # index order kept
        _, idx = _walk_sort(keys, idx)
    idx = idx[:k]
    return v[idx], idx.astype(np.int32)


@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_equals_plain(name):
    x, k = _case(name)
    tv, ti = order.top_k_plain(torch.from_numpy(x), k)
    wv, wi = _walk_top_k(x, k)
    np.testing.assert_array_equal(wi, ti.numpy())
    np.testing.assert_array_equal(_bits(wv), _bits(tv.numpy()))


def test_kernel_walk_masked_compaction():
    """The compaction's form: a mask, with fewer live lanes than k (the -inf
    tail taken by index) and more."""
    rng = np.random.default_rng(5)
    x = (rng.integers(1, 40, 9000) / 4.0).astype(np.float32)
    for share in (0.1, 0.6):
        mask = rng.random(9000) < share
        tv, ti = order.top_k_plain(torch.from_numpy(np.where(mask, x, -np.inf)
                                                     .astype(np.float32)), 4096)
        wv, wi = _walk_top_k(x, 4096, mask)
        np.testing.assert_array_equal(wi, ti.numpy())
        np.testing.assert_array_equal(_bits(wv), _bits(tv.numpy()))


def test_forms_and_scratch():
    """The kernel's path by size, and its scratch (the C entry's check)."""
    assert order._top_k_form(2048, 5) == "small"
    assert order._top_k_form(2049, 2049) == "full"
    assert order._top_k_form(65536, 2048) == "select"
    assert order._top_k_form(65536, 32768) == "select,sort"
    assert order._top_k_work_words(2048, 2048) == 0
    assert order._top_k_work_words(65536, 2048) == 264 + 16 + 4 * 2048
    assert order._top_k_work_words(65536, 32768) == (264 + 8 + 4 * 256 + 4 * 256 * 32 + 16
                                                     + 4 * 32768)


# ---------------------------------------------------------------------------
# The wrappers on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mixed", "signed-zeros", "compaction"])
def test_wrappers_equal_plain_twin(name):
    x, k = _case(name)
    xt = torch.from_numpy(x)
    pv, pi = order.top_k_plain(xt, k)
    v, i = order.top_k(xt, k)
    assert torch.equal(i, pi) and torch.equal(v.view(torch.int32), pv.view(torch.int32))
    mask = torch.from_numpy(np.random.default_rng(3).random(x.size) < 0.4)
    mv, mi, live = order.masked_top_k(xt, mask, k)
    qv, qi = order.top_k_plain(torch.where(mask, xt, -np.inf), k)
    assert torch.equal(mi, qi) and torch.equal(mv.view(torch.int32), qv.view(torch.int32))
    assert live.dtype == torch.int32 and live.dim() == 0 and int(live) == int(mask.sum())


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(10)
    with pytest.raises(TypeError, match="float32"):
        order.top_k(torch.zeros(10, dtype=torch.int64), 3)
    with pytest.raises(TypeError, match="float32"):
        order.top_k(torch.zeros(10, dtype=torch.float64), 3)
    with pytest.raises(TypeError, match="float32"):
        order.masked_top_k(torch.zeros(10, dtype=torch.int32), torch.ones(10, dtype=torch.bool),
                           3)
    with pytest.raises(TypeError, match="1-D"):
        order.top_k(torch.zeros(2, 5), 3)
    for k in (0, 11):
        with pytest.raises(ValueError, match="outside"):
            order.top_k(x, k)
    with pytest.raises(TypeError, match="mask"):
        order.masked_top_k(x, torch.ones(10, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="mask"):
        order.masked_top_k(x, torch.ones(9, dtype=torch.bool), 3)
