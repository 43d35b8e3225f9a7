"""Ordering primitives with the JAX package's exact tie semantics.

- ``top_k`` matches ``jax.lax.top_k``: descending, ties keep the lower
  index first, and floats compare in IEEE total order (+0.0 ranks above
  -0.0).  ``torch.topk`` gives no order for ties, so this is a stable
  descending sort of an order-preserving integer key, then a slice.
- ``argsort`` matches ``jnp.argsort(..., stable=True)``: ascending, stable,
  -0.0 equal to +0.0 (float keys are canonicalised before the sort).
- ``lexsort2`` matches ``jnp.lexsort((minor, major))``.
- ``ordered_sum`` matches a float32 ``jnp.sum`` along the leading axis as
  the JAX package's compiled CPU programs add: XLA splits a reduction over
  more than 32 elements into windows of 32 (the input padded with zeros to
  a multiple of 32, the padding split evenly before and after, the odd
  element after), sums each window in order from 0 and reduces the window
  sums the same way, down to one ordered sum of at most 32.  It is built
  from elementwise adds only, so the CPU and the card give the same bits.
  On CUDA tensors it launches ``cc_ordered_sum`` (``csrc/ordered.cu``,
  the order of ``csrc/ordered.cuh``): the same adds in one launch.
- ``ordered_cumsum`` matches a float32 ``jnp.cumsum`` along the leading
  axis the same way: XLA scans more than 16 elements as blocks of 16 (the
  input padded with zeros at the end), each scanned in order, plus the
  inclusive scan of the block totals — itself scanned so — shifted by one
  block.  Elementwise adds only, the same bits on any device; K3 takes it
  on the card as ``cc_ordered_cumsum`` (``csrc/ordered.cu``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from cruise_control_tpu_torch.ops import cuda

_I32_MAX = 0x7FFFFFFF


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose integer order is the IEEE total order of float32 ``x``."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ _I32_MAX, bits)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the ``k`` largest entries of 1-D ``x``."""
    key = _total_order_key(x) if x.dtype == torch.float32 else x
    idx = torch.sort(key, descending=True, stable=True).indices[:k]
    return x[idx], idx.to(torch.int32)


def _canonical(x: torch.Tensor) -> torch.Tensor:
    return x + 0.0 if x.is_floating_point() else x  # -0.0 -> +0.0


def argsort(x: torch.Tensor, dim: int = -1, descending: bool = False) -> torch.Tensor:
    """Stable argsort (int64 indices) along ``dim``."""
    return torch.sort(_canonical(x), dim=dim, descending=descending,
                      stable=True).indices


def lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Indices sorting by ``major`` then ``minor``, both ascending, stable."""
    o1 = argsort(minor)
    o2 = argsort(major[o1])
    return o1[o2]


_SUM_WINDOW = 32
_SUM_MAX_ROWS = 32 * 512  # cc_ordered_sum: one window per thread of a block


@cuda.counted("ordered_sum")
def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` along dim 0, in XLA's windowed order (see the module
    docstring); the result has ``x.shape[1:]``.  Replaces the alive-broker
    sums of the band averages (``cruise_control_tpu/analyzer/goals/
    kernels.py:190``, ``analyzer/optimizer.py:311``).  Bound on the card:
    bytes (the input once).  CPU tensors take ``ordered_sum_plain``; CUDA
    tensors (float32, at most 16,384 rows) launch one block per column."""
    cuda.record("ordered_sum", (x,))
    if cuda.on_cpu(x):
        return ordered_sum_plain(x)
    n, rest = x.shape[0], tuple(x.shape[1:])
    if x.dtype != torch.float32 or n > _SUM_MAX_ROWS:
        raise ValueError(f"ordered_sum takes float32 with at most {_SUM_MAX_ROWS} rows, "
                         f"got {x.dtype} with {n}")
    out = torch.empty(rest, dtype=torch.float32, device=x.device)
    cuda.launch("ordered_sum", x.reshape(n, math.prod(rest)).contiguous(), out, n,
                math.prod(rest))
    ordered_sum.launches += 1
    return out


def ordered_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """``ordered_sum`` in elementwise torch ops: the CPU path and the
    kernel's plain twin."""
    rest = tuple(x.shape[1:])
    while x.shape[0] > _SUM_WINDOW:
        n = x.shape[0]
        m = -(-n // _SUM_WINDOW) * _SUM_WINDOW
        lo = (m - n) // 2
        x = torch.cat([x.new_zeros((lo,) + rest), x, x.new_zeros((m - n - lo,) + rest)])
        x = x.reshape((m // _SUM_WINDOW, _SUM_WINDOW) + rest)
        acc = x.new_zeros((m // _SUM_WINDOW,) + rest)
        for i in range(_SUM_WINDOW):
            acc = acc + x[:, i]
        x = acc
    acc = x.new_zeros(rest)
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


_SCAN_BLOCK = 16


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of ``x`` along dim 0, in XLA's blocked order
    (see the module docstring)."""
    n = x.shape[0]
    rest = tuple(x.shape[1:])
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[i] += out[i - 1]
        return out
    m = -(-n // _SCAN_BLOCK) * _SCAN_BLOCK
    xp = torch.cat([x, x.new_zeros((m - n,) + rest)]).reshape(
        (m // _SCAN_BLOCK, _SCAN_BLOCK) + rest)
    for j in range(1, _SCAN_BLOCK):
        xp[:, j] += xp[:, j - 1]
    totals = ordered_cumsum(xp[:, -1])
    xp[1:] += totals[:-1].unsqueeze(1)
    return xp.reshape((m,) + rest)[:n]
