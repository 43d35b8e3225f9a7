"""K3 (``prefix_cut_admit`` / ``prefix_admit_safe``) of the PyTorch port
against the JAX package on inputs whose rounding order matters.

tests/test_torch_select.py draws K3's deltas from eighths, so every running
total is exact in float32 there.  Here the deltas are non-dyadic (normal
draws over four decades) and a share of the segments take a bound at their
own float64 running total at one of their positions, so a cut can turn on
the last bit of a sum: the running totals must be the JAX cumsum's
(``ops/order.py`` ``ordered_cumsum``, XLA's CPU scan of blocks of 16).  The
sizes sit on the scan's level edges (16, 17, 256, 257, 4,096, 4,097 and
65,537 positions); the cases add tied scores with +0 and -0, one segment
holding nine rows in ten, empty segments, no kept row and segments already
out of band at their first position.  Tolerance: exact (every lane).

The card's kernel (``csrc/prefix_cut.cu``) cannot run here, so its
decomposition is walked in numpy (``_card_walk``): one stable score sort,
the segment grouping of the row index's plain twin over the ids in score
order (or, above 4,096 segments, a second stable sort), the level-1 block
totals, their ordered scan, each position's running total rebuilt as its
in-block scan plus the level-1 value of the block before, the segment bases
and the first out-of-band position per segment.  It must give the plain
twin's lanes exactly.  On the card ``chip_smoke.py`` holds the kernel
against the plain twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.ops import order
from cruise_control_tpu_torch.ops.segment import segment_row_index_plain
from tests.torch_port_helpers import scan_blocks, scan_levels

EDGES = (16, 17, 256, 257, 4096, 4097, 65537)
CASES = ("ties", "dominant", "empty_segments", "none_kept", "out_of_band_first")


def _jax_order(score, seg):
    """The JAX function's two stable argsorts: segment-major, score
    descending (-0 equal to +0), ties by index."""
    return np.lexsort((-score + np.float32(0.0), seg))


def _fixture(k, s, c, seed, case="mixed"):
    """(score, seg, deltas, kept, cum_before, lo, hi, S) of one case."""
    rng = np.random.default_rng(seed)
    score = rng.integers(-6, 7, k).astype(np.float32)              # ties
    zero = score == 0
    score[zero & (rng.random(k) < 0.5)] = -0.0
    score[rng.random(k) < 0.02] = np.inf
    seg = rng.integers(0, s, k)
    if case == "empty_segments":                                   # odd ids hold nothing
        seg = 2 * rng.integers(0, (s + 1) // 2, k)
    elif case == "dominant":                                       # nine rows in ten
        seg[rng.random(k) < 0.9] = 0
    elif case == "ties":                                           # three scores, many zeros
        score = rng.choice(np.array([1.0, 0.0, -0.0], np.float32), k)
    seg = seg.astype(np.int32)
    deltas = (rng.normal(0.0, 1.0, (k, c)) * 10.0 ** rng.integers(-2, 2, (k, c))).astype(
        np.float32)
    kept = rng.random(k) < 0.8
    if case == "none_kept":
        kept[:] = False
    cum = rng.normal(0.0, 1.0, (s, c)).astype(np.float32)
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    # Bounds from each segment's float64 running totals: a share of the
    # channels take as a bound the highest (lowest) total up to a random
    # position, exactly or a little inside it.
    o = _jax_order(score, seg)
    d = np.where(kept[o][:, None], deltas[o], 0.0).astype(np.float64)
    cs = np.cumsum(d, axis=0)
    starts = np.searchsorted(seg[o], np.arange(s))
    ends = np.searchsorted(seg[o], np.arange(s), side="right")
    for g in range(s):
        if starts[g] == ends[g]:
            continue
        base = cs[starts[g] - 1] if starts[g] > 0 else 0.0
        run = cum[g].astype(np.float64) + cs[starts[g]:ends[g]] - base
        at = rng.integers(0, ends[g] - starts[g])
        for ch in range(c):
            u = rng.random()
            top, bottom = run[:at + 1, ch].max(), run[:at + 1, ch].min()
            if u < 0.3:    # at the highest total so far (rounding decides) or just under
                hi[g, ch] = np.float32(top - (u < 0.15) * 1e-3 * abs(top))
            elif u < 0.6:
                lo[g, ch] = np.float32(bottom + (u < 0.45) * 1e-3 * abs(bottom))
            elif u < 0.8:
                lo[g, ch] = np.float32(run[:, ch].min() - 1.0)
                hi[g, ch] = np.float32(run[:, ch].max() + 1.0)
    if case == "out_of_band_first":                               # a third start outside
        cum[rng.random(s) < 0.33] = 1e4
        hi[:, 0] = np.where(np.isinf(hi[:, 0]), 1e3, hi[:, 0])
    return score, seg, deltas, kept, cum, lo, hi, s


def _safe_inputs(score, seg, deltas, kept, cum, lo, hi, s):
    """``prefix_admit_safe``'s call of K3: the split channels."""
    inf = np.full_like(hi, np.inf)
    return (score, seg, np.concatenate([np.maximum(deltas, 0), np.minimum(deltas, 0)], 1),
            kept, np.concatenate([cum, cum], 1), np.concatenate([-inf, lo], 1),
            np.concatenate([hi, inf], 1), s)


def _near_bound(score, seg, deltas, kept, cum, lo, hi, s):
    """Positions whose float64 running total lies within 2 eps of a bound."""
    o = _jax_order(score, seg)
    d = np.where(kept[o][:, None], deltas[o], 0.0).astype(np.float64)
    cs = np.cumsum(d, axis=0)
    so = seg[o]
    starts = np.searchsorted(so, np.arange(s))
    base = np.where((starts > 0)[:, None], cs[np.maximum(starts - 1, 0)], 0.0)
    run = cum[so].astype(np.float64) + cs - base[so]
    h, l = hi[so].astype(np.float64), lo[so].astype(np.float64)
    eps = 1e-6 * np.maximum(1.0, np.maximum(np.where(np.isfinite(h), np.abs(h), 0.0),
                                            np.where(np.isfinite(l), np.abs(l), 0.0)))
    return int(((np.abs(run - h) <= 2 * eps) | (np.abs(run - l) <= 2 * eps)).any(1).sum())


def _port(fn, args):
    return getattr(tk, fn)(*[torch.from_numpy(a) for a in args[:-1]], args[-1]).numpy()


def _jax(fn, args):
    return np.asarray(getattr(jk, fn)(*[jnp.asarray(a) for a in args[:-1]], args[-1]))


def _same(got, want):
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (f"{bad.size} lanes differ, first {bad[0]}: got {got[bad[0]]}, "
                           f"want {want[bad[0]]}")


@pytest.mark.parametrize("fn", ["prefix_cut_admit", "prefix_admit_safe"])
@pytest.mark.parametrize("k", EDGES)
def test_level_edges_match_jax(fn, k):
    args = _fixture(k, max(3, k // 48), 3, k + 2)
    got = _port(fn, args)
    _same(got, _jax(fn, args))
    assert got.any() and (args[3] & ~got).any()
    if k >= 256:
        assert _near_bound(*args) > 0


@pytest.mark.parametrize("fn", ["prefix_cut_admit", "prefix_admit_safe"])
@pytest.mark.parametrize("case", CASES)
def test_cases_match_jax(fn, case):
    args = _fixture(4097, 40, 2, 7, case)
    got = _port(fn, args)
    _same(got, _jax(fn, args))
    if case == "none_kept":
        assert not got.any()
    else:
        assert got.any() and (args[3] & ~got).any()


# ---------------------------------------------------------------------------
# The card's decomposition, walked in numpy
# ---------------------------------------------------------------------------

def _grouping(seg, by_score, s, regroup):
    """(offsets, rows): the ids in score order grouped by segment — the row
    index's counting pass (its plain twin), or the second stable sort."""
    ids = seg[by_score]
    if not regroup:
        offsets, rows = segment_row_index_plain(torch.from_numpy(ids),
                                                torch.ones(ids.shape[0], dtype=torch.bool), s)
        return offsets.numpy(), rows.numpy()
    keys = np.where((ids >= 0) & (ids < s), ids, s)
    rows = np.argsort(keys, kind="stable").astype(np.int32)
    offsets = np.searchsorted(keys[rows], np.arange(s + 1)).astype(np.int32)
    return offsets, rows


def _card_walk(score, seg, deltas, kept, cum, lo, hi, s, regroup=False):
    """bool[K]: K3 as ``csrc/prefix_cut.cu`` computes it, in float32."""
    k, c = deltas.shape
    by_score = order.argsort(-torch.from_numpy(score)).numpy()
    offsets, rows = _grouping(seg, by_score, s, regroup)
    grouped = int(offsets[s])
    row_at = by_score[rows[:grouped]]
    x = np.zeros((k, c), np.float32)
    x[:grouped] = np.where(kept[row_at][:, None], deltas[row_at], np.float32(0.0))
    blocks = scan_blocks(x)                                   # (2)'s shuffle scans
    inblock = blocks.reshape(-1, c)[:k]
    level1 = scan_levels(blocks[:, 15])                       # (1): totals, levels
    cs = inblock.copy()
    cs[16:] = inblock[16:] + level1[np.arange(16, k) // 16 - 1]
    starts = offsets[:s].astype(np.int64)
    base = np.zeros((s, c), np.float32)
    has = (starts > 0) & (starts < offsets[1:])
    base[has] = cs[starts[has] - 1]                           # (1): the bases
    pos = np.arange(grouped)
    sid = seg[row_at]
    h, l = hi[sid], lo[sid]
    scale = np.maximum(np.maximum(np.where(np.isfinite(h), np.abs(h), 0),
                                  np.where(np.isfinite(l), np.abs(l), 0)), 1).astype(np.float32)
    eps = np.float32(1e-6) * scale
    prefix = (cum[sid] + cs[:grouped]) - base[sid]
    ok = ((prefix <= h + eps) & (prefix >= l - eps)).all(1)
    first_bad = np.full(s, np.iinfo(np.int32).max, np.int64)
    np.minimum.at(first_bad, sid[~ok], pos[~ok])              # (2): atomicMin
    out = np.zeros(k, bool)
    out[row_at] = kept[row_at] & (pos < first_bad[sid])       # (3)
    return out


WALKS = [(k, "mixed") for k in EDGES] + [(4097, case) for case in CASES]


@pytest.mark.parametrize("safe", [False, True], ids=["cut", "safe"])
@pytest.mark.parametrize("k,case", WALKS)
def test_card_walk_matches_plain_twin(k, case, safe):
    args = _fixture(k, max(3, k // 48), 3, k + 1, case)
    if safe:
        args = _safe_inputs(*args)
    got = _card_walk(*args)
    _same(got, tk.prefix_cut_admit_plain(*[torch.from_numpy(a) for a in args[:-1]],
                                         args[-1]).numpy())


@pytest.mark.parametrize("k,case", [(4097, "mixed"), (4097, "dominant"),
                                    (4097, "empty_segments")])
def test_both_groupings_agree(k, case):
    """The counting pass and the second stable sort group alike, and the
    walk cuts alike on either; the wrapper takes the sort above
    ``COUNTING_MAX_SEGMENTS`` (no counting-pass scratch)."""
    score, seg, deltas, kept, cum, lo, hi, s = _fixture(k, 60, 2, 3, case)
    by_score = order.argsort(-torch.from_numpy(score)).numpy()
    a, b = _grouping(seg, by_score, s, False), _grouping(seg, by_score, s, True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1][:a[0][-1]], b[1][:b[0][-1]])
    args = (score, seg, deltas, kept, cum, lo, hi, s)
    _same(_card_walk(*args, regroup=True), _card_walk(*args))
    limit = tk.COUNTING_MAX_SEGMENTS
    assert tk.prefix_cut_scratch(k, limit, 2)[4] > 0
    assert tk.prefix_cut_scratch(k, limit + 1, 2)[4] == 0
