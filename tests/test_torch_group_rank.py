"""K6 group rank (``analyzer/goals/kernels.py`` ``_within_group_rank``; the
card's ``csrc/group_rank.cu``) on the CPU.

- ``within_group_rank_plain`` against the JAX package's
  ``_within_group_rank``, exactly, on seeded inputs and the edges: ties at
  -big (the irrelevant rows), +0.0 / -0.0 ties, every key equal, one group
  holding every row, single-row groups, a group id space of 40,000 (above
  ``segment_row_index``'s 28,927 segments, as the (topic, broker) pairs at
  xl250), and the two callers' shapes (by broker and by (topic, broker)
  pair, integer-valued counts and float loads).
- A numpy walk of ``cc_group_rank``'s steps (the counts, the scan, a scatter
  into the groups' ranges in an arbitrary order, and each row's count of its
  group's (key, row) composites above its own, through shared-memory tiles
  where a block of 256 positions lies in one group) against the plain twin.
- The wrapper on CPU tensors equals the plain twin and refuses what the
  kernel does not take.

(The kernel itself is held against the plain twin bit for bit on the card in
``chip_smoke.py``.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu_torch.analyzer.goals import kernels as tk

BIG = np.float32(1e30)


def _case(name, seed=0):
    """(group i32[n], key f32[n], number of groups)."""
    rng = np.random.default_rng(seed + 11 * len(name))
    if name == "brokers":  # the count and load goals: R rows over B brokers
        n, s = 5000, 50
        g = rng.integers(0, s, n)
        key = np.where(rng.random(n) < 0.4, rng.gamma(2.0, 1.0, n), -BIG)
        return g, key, s
    if name == "pairs":  # TopicReplicaDistributionGoal: integer counts, -big
        t, b, n = 40, 30, 6000
        g = rng.integers(0, t, n) * b + rng.integers(0, b, n)
        key = np.where(rng.random(n) < 0.3, rng.integers(1, 9, n), -BIG)
        return g, key, t * b
    if name == "signed-zeros":
        n, s = 3000, 17
        return (rng.integers(0, s, n), rng.choice(np.array([0.0, -0.0, 1.0, -1.0]), n), s)
    if name == "all-equal":
        return rng.integers(0, 9, 2000), np.full(2000, 3.0), 9
    if name == "one-group":  # a skewed broker: every row in group 0 of 4
        return np.zeros(3000, np.int64), rng.integers(0, 20, 3000) / 2.0, 4
    if name == "single-rows":
        n = 1500
        return rng.permutation(n), rng.standard_normal(n), n
    if name == "many-groups":  # above segment_row_index's 28,927 segments
        n, s = 60000, 40000
        return rng.integers(0, s, n), np.where(rng.random(n) < 0.5, 1.0, -BIG), s
    if name == "skewed":  # a tenth of the rows on one broker, the rest spread
        n, s = 8000, 100
        g = np.where(rng.random(n) < 0.1, 7, rng.integers(0, s, n))
        return g, rng.integers(0, 30, n).astype(np.float64), s
    raise KeyError(name)


CASES = ["brokers", "pairs", "signed-zeros", "all-equal", "one-group", "single-rows",
         "many-groups", "skewed"]


def _arrays(name):
    g, key, s = _case(name)
    return g.astype(np.int32), key.astype(np.float32), s


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    g, key, _ = _arrays(name)
    want = np.asarray(jk._within_group_rank(jnp.asarray(g), jnp.asarray(key)))
    got = tk.within_group_rank_plain(torch.from_numpy(g), torch.from_numpy(key))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# A numpy walk of cc_group_rank (csrc/group_rank.cu)
# ---------------------------------------------------------------------------

THREADS = 256


def _composite(key, rows):
    b = (key.astype(np.float32) + np.float32(0.0)).view(np.uint32)  # -0.0 -> +0.0
    u = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000)).astype(np.uint64)
    return (u << np.uint64(32)) | (~rows.astype(np.uint32)).astype(np.uint64)


def _walk(g, key, s, seed):
    n = g.size
    slot = np.where((g >= 0) & (g < s), g, s)
    counts = np.bincount(slot, minlength=s + 1)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    # The scatter's slots within a range come in whatever order the atomics
    # take: a seeded shuffle of the rows stands in for it.
    row_comp = _composite(key, np.arange(n))
    comp = np.zeros(n, np.uint64)
    slots = np.zeros(n, np.int64)
    fill = counts.copy()
    for i in np.random.default_rng(seed).permutation(n):
        fill[slot[i]] -= 1
        pos = offsets[slot[i]] + fill[slot[i]]
        comp[pos], slots[pos] = row_comp[i], slot[i]
    out = np.full(n, -1, np.int64)
    for first in range(0, n, THREADS):
        last = min(n, first + THREADS) - 1
        lo, hi = offsets[slots[last]], offsets[slots[last] + 1]
        tiled = slots[first] == slots[last] and hi - lo > THREADS
        for p in range(first, last + 1):
            lo, hi = offsets[slots[p]], offsets[slots[p] + 1]
            if tiled:  # the block's tiles of its group's range
                above = sum(int((comp[b:min(hi, b + THREADS)] > comp[p]).sum())
                            for b in range(lo, hi, THREADS))
            else:
                above = int((comp[lo:hi] > comp[p]).sum())
            out[int(~np.uint32(comp[p] & np.uint64(0xFFFFFFFF)))] = above
    assert (out >= 0).all()
    return out


@pytest.mark.parametrize("name", CASES)
def test_kernel_walk_equals_plain(name):
    g, key, s = _arrays(name)
    want = tk.within_group_rank_plain(torch.from_numpy(g), torch.from_numpy(key)).numpy()
    for seed in (0, 1):
        np.testing.assert_array_equal(_walk(g, key, s, seed), want)


# ---------------------------------------------------------------------------
# The wrapper on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["brokers", "pairs"])
def test_wrapper_equals_plain_twin(name):
    g, key, s = _arrays(name)
    args = torch.from_numpy(g), torch.from_numpy(key)
    form = "pair" if name == "pairs" else "broker"
    assert torch.equal(tk._within_group_rank(*args, s, form),
                       tk.within_group_rank_plain(*args))


def test_wrapper_refuses_bad_inputs():
    g, key = torch.zeros(10, dtype=torch.int32), torch.zeros(10)
    with pytest.raises(TypeError, match="group"):
        tk._within_group_rank(g.long(), key, 4)
    with pytest.raises(TypeError, match="key_desc"):
        tk._within_group_rank(g, key.double(), 4)
    with pytest.raises(ValueError, match="key_desc"):
        tk._within_group_rank(g, key[:9], 4)
    with pytest.raises(ValueError, match="groups"):
        tk._within_group_rank(g, key, -1)
