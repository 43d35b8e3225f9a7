"""Windowed metric-sample aggregation.

Parity with the core cyclic-window aggregator
(`cruise-control-core/.../aggregator/MetricSampleAggregator.java:84`,
``RawMetricValues.java:29``): N time windows per entity, per-window sample
counts, validity thresholds, extrapolation for missing windows
(``Extrapolation.java:32``), generation stamps invalidating cached
aggregates, and completeness reporting
(``MetricSampleCompleteness``/``ValuesAndExtrapolations``).

Dense redesign: instead of one ring-buffer object per entity, ALL
entities' windows live in three dense tensors —

    sum   f32[E, W, M]   running sum per (entity, window, metric)
    count i32[E, W]      samples per (entity, window)
    max   f32[E, W, M] / latest f32[E, W, M]

Ingestion (``add_sample``) is a host-side numpy accumulation (streaming,
row-at-a-time; ``add_samples`` batches through the vectorized numpy ingest
of ``native.ingest_samples``); aggregation
(``aggregate``) — validity, extrapolation, and window collapse — is one
vectorized pass producing device-ready arrays.  The window axis is a cyclic
buffer indexed by ``window_index % num_windows`` with O(1) eviction,
exactly the reference's ``WindowIndexedArrays`` scheme.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from cruise_control_tpu_torch import native
from cruise_control_tpu_torch.monitor.metricdef import (KAFKA_METRIC_DEF, MetricDef,
                                                  ValueComputingStrategy)


class Extrapolation(enum.Enum):
    """Reference: aggregator/Extrapolation.java:32."""

    NONE = "none"
    AVG_AVAILABLE = "avg_available"
    AVG_ADJACENT = "avg_adjacent"
    FORCED_INSUFFICIENT = "forced_insufficient"
    NO_VALID_EXTRAPOLATION = "no_valid_extrapolation"


@dataclasses.dataclass
class AggregationResult:
    """ValuesAndExtrapolations analogue, for all entities at once."""

    values: np.ndarray          # f32[E, W, M] window values (extrapolated where needed)
    collapsed: np.ndarray       # f32[E, M] strategy-collapsed across windows
    entity_valid: np.ndarray    # bool[E]
    window_valid: np.ndarray    # bool[E, W]
    extrapolations: np.ndarray  # i8[E, W] Extrapolation ordinal
    window_starts_ms: np.ndarray  # i64[W] oldest → newest
    generation: int
    # Entity keys in row order, snapshotted under the aggregator lock so row
    # indices always match the arrays even with concurrent ingestion.
    entities: list = dataclasses.field(default_factory=list)

    def completeness(self) -> float:
        """Fraction of entities with a valid aggregate
        (MetricSampleCompleteness.validEntityRatio)."""
        e = self.entity_valid.shape[0]
        return float(self.entity_valid.sum()) / e if e else 0.0


_EXTRAPOLATION_ORD = {e: i for i, e in enumerate(Extrapolation)}


class MetricSampleAggregator:
    """Cyclic-window aggregator over a dense entity axis.

    Entities are registered by an opaque key (e.g. a (topic, partition)
    tuple or broker id) and mapped to dense row ids.  The *current* window
    accumulates samples; completed windows participate in aggregation.
    Thread-safe for concurrent ingestion (one lock — ingestion is cheap
    row-arithmetic; contention is not the bottleneck at sampler cadence).
    """

    def __init__(self, num_windows: int, window_ms: int,
                 min_samples_per_window: int = 1,
                 max_allowed_extrapolations_per_entity: int = 5,
                 metric_def: MetricDef = KAFKA_METRIC_DEF,
                 capacity: int = 64):
        self._w = int(num_windows)
        self._window_ms = int(window_ms)
        self._min_samples = int(min_samples_per_window)
        self._max_extrapolations = int(max_allowed_extrapolations_per_entity)
        self._metric_def = metric_def
        self._m = metric_def.num_metrics
        self._lock = threading.RLock()

        cap = max(capacity, 1)
        self._sum = np.zeros((cap, self._w + 1, self._m), np.float64)
        self._max = np.full((cap, self._w + 1, self._m), -np.inf, np.float64)
        self._latest_val = np.zeros((cap, self._w + 1, self._m), np.float64)
        self._latest_ts = np.full((cap, self._w + 1), -1, np.int64)
        self._count = np.zeros((cap, self._w + 1), np.int64)

        self._entities: Dict[object, int] = {}
        self._oldest_window_index = 0   # absolute index of oldest retained window
        self._current_window_index = 0  # absolute index of the in-progress window
        self._generation = 0

    # -- entity management -------------------------------------------------
    def _row(self, entity) -> int:
        row = self._entities.get(entity)
        if row is None:
            row = len(self._entities)
            if row >= self._sum.shape[0]:
                grow = max(row + 1, 2 * self._sum.shape[0])
                for name in ("_sum", "_max", "_latest_val"):
                    arr = getattr(self, name)
                    new = np.full((grow,) + arr.shape[1:],
                                  -np.inf if name == "_max" else 0.0, arr.dtype)
                    new[: arr.shape[0]] = arr
                    setattr(self, name, new)
                new_ts = np.full((grow, self._w + 1), -1, np.int64)
                new_ts[: self._latest_ts.shape[0]] = self._latest_ts
                self._latest_ts = new_ts
                new_c = np.zeros((grow, self._w + 1), np.int64)
                new_c[: self._count.shape[0]] = self._count
                self._count = new_c
            self._entities[entity] = row
            self._generation += 1
        return row

    @property
    def entities(self) -> List[object]:
        inv = sorted(self._entities.items(), key=lambda kv: kv[1])
        return [k for k, _ in inv]

    @property
    def generation(self) -> int:
        return self._generation

    @property
    def num_windows(self) -> int:
        return self._w

    @property
    def window_ms(self) -> int:
        return self._window_ms

    # -- ingestion ---------------------------------------------------------
    def _slot(self, window_index: int) -> int:
        return window_index % (self._w + 1)

    def _roll_to(self, window_index: int) -> None:
        """Advance the cyclic buffer so ``window_index`` is current; evicted
        slots are zeroed.  Bounded by the buffer size, not the gap: a jump
        larger than W+1 windows (e.g. the first real epoch-ms sample on a
        fresh aggregator) evicts every slot at once instead of iterating
        millions of empty windows."""
        gap = window_index - self._current_window_index
        if gap <= 0:
            return
        if gap > self._w + 1:
            self._sum[:] = 0.0
            self._max[:] = -np.inf
            self._latest_val[:] = 0.0
            self._latest_ts[:] = -1
            self._count[:] = 0
        else:
            for i in range(self._current_window_index + 1, window_index + 1):
                slot = self._slot(i)
                self._sum[:, slot] = 0.0
                self._max[:, slot] = -np.inf
                self._latest_val[:, slot] = 0.0
                self._latest_ts[:, slot] = -1
                self._count[:, slot] = 0
        self._current_window_index = window_index
        self._oldest_window_index = max(self._oldest_window_index,
                                        window_index - self._w)
        self._generation += 1

    def add_sample(self, entity, time_ms: int, values: Dict[str, float]) -> bool:
        """Record one sample.  Returns False for samples older than the
        retention horizon (silently dropped, like addSample's false path)."""
        window_index = time_ms // self._window_ms
        with self._lock:
            if window_index > self._current_window_index:
                self._roll_to(window_index)
            elif window_index < self._oldest_window_index:
                return False
            row = self._row(entity)
            slot = self._slot(window_index)
            for name, val in values.items():
                mid = self._metric_def.metric_info(name).metric_id
                self._sum[row, slot, mid] += val
                if val > self._max[row, slot, mid]:
                    self._max[row, slot, mid] = val
                if time_ms >= self._latest_ts[row, slot]:
                    self._latest_val[row, slot, mid] = val
            if time_ms >= self._latest_ts[row, slot]:
                self._latest_ts[row, slot] = time_ms
            self._count[row, slot] += 1
            self._generation += 1
            return True

    def add_samples(self, samples) -> int:
        """Batched ingestion of (entity, time_ms, {metric: value}) triples —
        the warm-start / bootstrap hot path — through the vectorized numpy
        ingest (the same arrays, in the same order, as the JAX package's C++
        ingest; one generation step per batch).  Returns the number of
        accepted samples."""
        if not samples:
            return 0
        with self._lock:
            max_window = max(t // self._window_ms for _, t, _ in samples)
            if max_window > self._current_window_index:
                self._roll_to(max_window)
            rows, slots, times = [], [], []
            vals = np.zeros((len(samples), self._m), np.float64)
            mask = np.zeros((len(samples), self._m), np.uint8)
            n = 0
            for entity, time_ms, values in samples:
                window_index = time_ms // self._window_ms
                if window_index < self._oldest_window_index:
                    continue
                rows.append(self._row(entity))
                slots.append(self._slot(window_index))
                times.append(time_ms)
                for name, val in values.items():
                    mid = self._metric_def.metric_info(name).metric_id
                    vals[n, mid] = val
                    mask[n, mid] = 1
                n += 1
            if n == 0:
                return 0
            native.ingest_samples(
                self._sum, self._max, self._latest_val, self._latest_ts,
                self._count,
                np.asarray(rows, np.int64), np.asarray(slots, np.int64),
                np.asarray(times, np.int64), vals[:n], mask[:n])
            self._generation += 1
            return n

    # -- aggregation -------------------------------------------------------
    def _completed_order(self) -> np.ndarray:
        """Slot indices of completed windows, oldest → newest."""
        hi = self._current_window_index  # current (in-progress) excluded
        lo = max(self._oldest_window_index, hi - self._w)
        return np.array([self._slot(i) for i in range(lo, hi)], np.int64), lo

    def aggregate(self) -> AggregationResult:
        """Validity + extrapolation + strategy collapse, vectorized.

        Window validity and extrapolation per (entity, window), mirroring
        RawMetricValues.java:303-328:
        - count >= min_samples          → valid, no extrapolation;
        - 0 < count < min_samples       → AVG_AVAILABLE (partial average);
        - count == 0, both neighbors have samples → AVG_ADJACENT;
        - count == 0 otherwise          → NO_VALID_EXTRAPOLATION (invalid).
        An entity is valid when its invalid windows ≤ max allowed
        extrapolations... strictly: when no window is NO_VALID_EXTRAPOLATION
        and the number of extrapolated windows ≤ the allowance.
        """
        with self._lock:
            e = len(self._entities)
            slots, lo = self._completed_order()
            w = len(slots)
            m = self._m
            if e == 0 or w == 0:
                return AggregationResult(
                    values=np.zeros((e, w, m), np.float32),
                    collapsed=np.zeros((e, m), np.float32),
                    entity_valid=np.zeros((e,), bool),
                    window_valid=np.zeros((e, w), bool),
                    extrapolations=np.zeros((e, w), np.int8),
                    window_starts_ms=np.arange(w, dtype=np.int64),
                    generation=self._generation,
                    entities=self.entities)

            s = self._sum[:e][:, slots]          # [E, W, M]
            mx = self._max[:e][:, slots]
            lt = self._latest_val[:e][:, slots]
            cnt = self._count[:e][:, slots]      # [E, W]

            avg = s / np.maximum(cnt, 1)[:, :, None]
            full = cnt >= self._min_samples
            partial = (cnt > 0) & ~full
            empty = cnt == 0

            # Neighbor availability for AVG_ADJACENT.
            has = cnt > 0
            left = np.zeros_like(has)
            right = np.zeros_like(has)
            left[:, 1:] = has[:, :-1]
            right[:, :-1] = has[:, 1:]
            adjacent = empty & left & right
            left_avg = np.zeros_like(avg)
            right_avg = np.zeros_like(avg)
            left_avg[:, 1:] = avg[:, :-1]
            right_avg[:, :-1] = avg[:, 1:]
            adj_val = (left_avg + right_avg) / 2.0

            values = np.where(adjacent[:, :, None], adj_val, avg)

            extrap = np.zeros((e, w), np.int8)
            extrap[partial] = _EXTRAPOLATION_ORD[Extrapolation.AVG_AVAILABLE]
            extrap[adjacent] = _EXTRAPOLATION_ORD[Extrapolation.AVG_ADJACENT]
            no_valid = empty & ~adjacent
            extrap[no_valid] = _EXTRAPOLATION_ORD[Extrapolation.NO_VALID_EXTRAPOLATION]

            window_valid = ~no_valid
            num_extrapolated = (extrap != 0).sum(axis=1)
            entity_valid = (~no_valid.any(axis=1)) & \
                (num_extrapolated <= self._max_extrapolations)

            # Strategy collapse (Load.java:81-95): AVG / MAX / LATEST across
            # valid windows.
            collapsed = np.zeros((e, m), np.float64)
            wv = window_valid[:, :, None]
            denom = np.maximum(window_valid.sum(axis=1), 1)[:, None]
            for info in self._metric_def.all_metric_infos():
                j = info.metric_id
                if info.strategy == ValueComputingStrategy.AVG:
                    collapsed[:, j] = np.where(window_valid, values[:, :, j], 0.0) \
                        .sum(axis=1) / denom[:, 0]
                elif info.strategy == ValueComputingStrategy.MAX:
                    filled = np.where(full | partial, mx[:, :, j], values[:, :, j])
                    masked = np.where(window_valid, filled, -np.inf)
                    best = masked.max(axis=1)
                    collapsed[:, j] = np.where(np.isfinite(best), best, 0.0)
                else:  # LATEST: newest valid window's latest sample
                    newest = np.zeros(e, np.float64)
                    found = np.zeros(e, bool)
                    for wi in range(w - 1, -1, -1):
                        pick = window_valid[:, wi] & ~found
                        src = np.where(cnt[:, wi] > 0, lt[:, wi, j], values[:, wi, j])
                        newest = np.where(pick, src, newest)
                        found |= pick
                    collapsed[:, j] = newest

            starts = (np.arange(lo, lo + w, dtype=np.int64)) * self._window_ms
            return AggregationResult(
                values=values.astype(np.float32),
                collapsed=collapsed.astype(np.float32),
                entity_valid=entity_valid,
                window_valid=window_valid,
                extrapolations=extrap,
                window_starts_ms=starts,
                generation=self._generation,
                entities=self.entities[:e])

    def valid_windows(self) -> int:
        """Number of completed windows currently retained."""
        with self._lock:
            return len(self._completed_order()[0])

    def clear(self) -> None:
        with self._lock:
            self._sum[:] = 0.0
            self._max[:] = -np.inf
            self._latest_val[:] = 0.0
            self._latest_ts[:] = -1
            self._count[:] = 0
            self._entities.clear()
            self._generation += 1
