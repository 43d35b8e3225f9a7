"""K2 (``_best_per_segment``) and K3 (``prefix_cut_admit`` /
``prefix_admit_safe``) of the PyTorch port against the JAX package, on
seeded fixtures with tied scores, ±inf scores and bounds, -0.0, an
out-of-band ``cum_before`` and empty segments.

Keep masks must be identical.  K3's fixtures draw its deltas and
``cum_before`` from multiples of 1/8 of small magnitude, so every prefix sum
is exact in float32 and the JAX package's cumsum and PyTorch's agree bit
for bit whatever order they add in; a lane then differs only on a real
fault.  (The card's kernel, which scans per segment, is held against the
plain version in ``chip_smoke.py``.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer.goals import kernels as jk
from cruise_control_tpu.analyzer.optimizer import _best_per_segment as jax_best
from cruise_control_tpu_torch.analyzer.goals import kernels as tk
from cruise_control_tpu_torch.analyzer.optimizer import _best_per_segment


def _best_fixture(seed, k=600, s=40):
    rng = np.random.default_rng(seed)
    score = rng.integers(-3, 4, k).astype(np.float32)  # many ties
    score[rng.random(k) < 0.05] = np.inf
    score[rng.random(k) < 0.05] = -np.inf
    zero = score == 0
    score[zero & (rng.random(k) < 0.5)] = -0.0
    seg = rng.choice(np.arange(0, s, 2), k).astype(np.int32)  # odd segments empty
    eligible = rng.random(k) < 0.7
    return score, seg, s, eligible


@pytest.mark.parametrize("seed", range(4))
def test_best_per_segment_matches(seed):
    score, seg, s, eligible = _best_fixture(seed)
    want = np.asarray(jax_best(jnp.asarray(score), jnp.asarray(seg), s, jnp.asarray(eligible)))
    got = _best_per_segment(torch.from_numpy(score), torch.from_numpy(seg), s,
                            torch.from_numpy(eligible)).numpy()
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"first differing lane {bad[0]}: got {got[bad[0]]}, want {want[bad[0]]}"
    assert got.any()


def test_best_per_segment_inf_segment_keeps_nothing():
    score = np.array([np.inf, 1.0, 2.0, 2.0], np.float32)
    seg = np.array([0, 0, 1, 1], np.int32)
    elig = np.ones(4, bool)
    got = _best_per_segment(torch.from_numpy(score), torch.from_numpy(seg), 2,
                            torch.from_numpy(elig)).numpy()
    np.testing.assert_array_equal(got, [False, False, True, False])


def _cut_fixture(seed, k=500, s=24, c=3):
    rng = np.random.default_rng(seed)
    score = rng.integers(0, 20, k).astype(np.float32)  # ties
    seg = rng.choice(np.arange(0, s, 3), k).astype(np.int32)  # empty segments
    deltas = (rng.integers(-16, 17, (k, c)) / 8.0).astype(np.float32)
    kept = rng.random(k) < 0.8
    cum = (rng.integers(-8, 9, (s, c)) / 8.0).astype(np.float32)
    lo = -rng.integers(2, 12, (s, c)).astype(np.float32)
    hi = rng.integers(2, 12, (s, c)).astype(np.float32)
    lo[rng.random((s, c)) < 0.2] = -np.inf
    hi[rng.random((s, c)) < 0.2] = np.inf
    cum[rng.random((s, c)) < 0.1] = 50.0  # out of band before any delta
    return score, seg, deltas, kept, cum, lo, hi, s


@pytest.mark.parametrize("fn", ["prefix_cut_admit", "prefix_admit_safe"])
@pytest.mark.parametrize("seed", range(4))
def test_prefix_cut_matches(fn, seed):
    args = _cut_fixture(seed)
    want = np.asarray(getattr(jk, fn)(*[jnp.asarray(a) for a in args[:-1]], args[-1]))
    got = getattr(tk, fn)(*[torch.from_numpy(a) for a in args[:-1]], args[-1]).numpy()
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"first differing lane {bad[0]}: got {got[bad[0]]}, want {want[bad[0]]}"
    assert got.any() and (args[3] & ~got).any()


def test_prefix_cut_counts_unkept_positions_out_of_band():
    """A segment whose cum_before is already out of band cuts at position 0:
    even its best kept lane is refused (kernels.py:1023 counts unkept
    positions too)."""
    score = np.array([3.0, 2.0, 1.0], np.float32)
    seg = np.zeros(3, np.int32)
    deltas = np.array([[1.0], [1.0], [1.0]], np.float32)
    kept = np.array([False, True, True])
    cum = np.array([[20.0]], np.float32)
    lo, hi = np.array([[-5.0]], np.float32), np.array([[5.0]], np.float32)
    got = tk.prefix_cut_admit(*[torch.from_numpy(a) for a in (score, seg, deltas, kept, cum,
                                                               lo, hi)], 1).numpy()
    np.testing.assert_array_equal(got, [False, False, False])
