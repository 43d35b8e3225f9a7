"""Host-side table builders, numpy only.

The port's copy of the numpy paths of ``cruise_control_tpu/native/__init__.py``
(``build_partition_replicas``, the proposal diff's partition walk and the
aggregator's batched ``ingest_samples``).  The JAX package's C++ fast path
(``cc_native.cpp``) is host code and not part of the port; these vectorized
numpy versions give the same tables and window arrays.
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


def ingest_samples(sum_arr: np.ndarray, max_arr: np.ndarray, latest_arr: np.ndarray,
                   latest_ts: np.ndarray, count: np.ndarray, rows: np.ndarray,
                   slots: np.ndarray, times_ms: np.ndarray, values: np.ndarray,
                   value_mask: np.ndarray) -> None:
    """Batched aggregator ingestion into the [cap, W+1(, M)] window arrays, in
    place, with the sequential semantics of ``cc_native.cpp``
    ``ingest_samples``: samples apply in order; each masked metric adds to
    its cell's sum (``np.add.at`` adds in index order) and raises its max; a
    sample is the cell's newest when its time is at least the latest time
    seen so far (ties go to the later sample), and then sets the latest
    value of each of its masked metrics and the latest time."""
    for a in (sum_arr, max_arr, latest_arr, latest_ts, count):
        if not a.flags.c_contiguous:
            raise ValueError("ingest_samples updates its window arrays in place: "
                             "they must be C-contiguous")
    n = int(rows.shape[0])
    if n == 0:
        return
    w1, m = sum_arr.shape[1], sum_arr.shape[2]
    cell = np.asarray(rows, np.int64) * w1 + np.asarray(slots, np.int64)
    times = np.asarray(times_ms, np.int64)
    ts_flat = latest_ts.reshape(-1)
    np.add.at(count.reshape(-1), cell, 1)

    # newest[i]: times[i] >= the running max of the cell's latest time
    # (its stored value, then every earlier sample's).  Samples grouped by
    # cell in sample order; times and stored values replaced by their dense
    # ranks so that a per-group offset turns the grouped running max into
    # one maximum.accumulate.
    order = np.lexsort((np.arange(n), cell))
    c_sorted = cell[order]
    first = np.r_[True, c_sorted[1:] != c_sorted[:-1]]
    group = np.cumsum(first) - 1
    starts = np.nonzero(first)[0]
    init = ts_flat[c_sorted[starts]]
    ranks = np.unique(np.concatenate([times[order], init]), return_inverse=True)[1]
    t_rank, init_rank = ranks[:n], ranks[n:]
    span = int(ranks.max()) + 1
    seq = np.empty(n + len(starts), np.int64)
    pos = np.arange(n) + group + 1           # each group's stored value first
    seq[pos] = group * span + t_rank
    seq[starts + np.arange(len(starts))] = np.arange(len(starts)) * span + init_rank
    running = np.maximum.accumulate(seq)
    prior = running[pos - 1] - group * span  # the max before each sample
    newest = np.empty(n, bool)
    newest[order] = t_rank >= prior
    ts_flat[c_sorted[starts]] = np.maximum(np.maximum.reduceat(times[order], starts), init)

    ii, jj = np.nonzero(np.asarray(value_mask, bool))
    v = np.asarray(values, np.float64)[ii, jj]
    idx = cell[ii] * m + jj
    np.add.at(sum_arr.reshape(-1), idx, v)
    np.maximum.at(max_arr.reshape(-1), idx, v)
    keep = newest[ii]
    idx_new, v_new = idx[keep], v[keep]
    # The last newest sample of each (cell, metric) sets its latest value.
    uniq, rev_first = np.unique(idx_new[::-1], return_index=True)
    latest_arr.reshape(-1)[uniq] = v_new[len(v_new) - 1 - rev_first]
