"""Host-side table builders, numpy only.

The port's copy of the numpy paths of ``cruise_control_tpu/native/__init__.py``
(``build_partition_replicas`` and the proposal diff's partition walk).  The
JAX package's C++ fast path (``cc_native.cpp``) is host code and not part of
the port; these vectorized numpy versions give the same tables.
"""

from __future__ import annotations

import numpy as np


def build_partition_replicas(replica_partition: np.ndarray, num_partitions: int,
                             max_rf: int) -> np.ndarray:
    """[P, max_rf] replica-id table (-1 pad): row p lists the replicas of
    partition p in replica-index order."""
    rp = np.asarray(replica_partition, np.int64)
    out = np.full((num_partitions, max_rf), -1, np.int32)
    if rp.size == 0:
        return out
    order = np.argsort(rp, kind="stable")
    sorted_p = rp[order]
    start = np.searchsorted(sorted_p, sorted_p, side="left")
    slot = np.arange(rp.size) - start
    out[sorted_p, slot] = order.astype(np.int32)
    return out


def diff_partitions(partition_replicas: np.ndarray, rb0: np.ndarray, rb1: np.ndarray,
                    rd0: np.ndarray, rd1: np.ndarray, ld0: np.ndarray,
                    ld1: np.ndarray) -> np.ndarray:
    """Ids of the partitions whose broker, disk or leadership of any replica
    differs between the two placements."""
    pr = partition_replicas
    sl = pr >= 0
    safe = np.where(sl, pr, 0)
    b = np.where(sl, rb0[safe], -1) != np.where(sl, rb1[safe], -1)
    d = np.where(sl, rd0[safe], -1) != np.where(sl, rd1[safe], -1)
    lead = np.where(sl, ld0[safe], False) != np.where(sl, ld1[safe], False)
    return np.nonzero((b | d | lead).any(axis=1))[0]
