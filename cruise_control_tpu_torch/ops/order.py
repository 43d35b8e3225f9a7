"""Ordering primitives with the JAX package's exact tie semantics.

- ``top_k`` matches ``jax.lax.top_k``: descending, ties keep the lower
  index first, and floats compare in IEEE total order (+0.0 ranks above
  -0.0).  ``torch.topk`` gives no order for ties, so this is a stable
  descending sort of an order-preserving integer key, then a slice.
- ``argsort`` matches ``jnp.argsort(..., stable=True)``: ascending, stable,
  -0.0 equal to +0.0 (float keys are canonicalised before the sort).
- ``lexsort2`` matches ``jnp.lexsort((minor, major))``.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
