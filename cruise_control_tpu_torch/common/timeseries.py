"""Telemetry time-series store: fixed-memory rings, staged downsampling,
an incremental stream log, and the SLA rollup engine.

Every other observability surface in this codebase is point-in-time — a
``/state`` read re-serializes whatever the sensors say *now*.  This module
is the retention layer underneath them: the cruise loop, the detector
manager, the executor ledger and the sensor registry publish scalar points
into :data:`TELEMETRY` on their **existing** tick/phase boundaries (the
store never fetches anything from a device — publishing is appending a
host float to a ring), and three read surfaces answer over time:

- ``GET /timeseries?series=&window=&step=`` — windowed aggregates from the
  downsample rungs (api/server.py);
- ``GET /stream?since=`` — the sequence-numbered event log, resumable by
  cursor (api/server.py);
- the ``Sla`` block of ``/state`` — :meth:`TimeSeriesStore.sla` windowed
  rollups (balancedness floor/percentiles, heal latency, task durations,
  replan churn, standing-hit ratio, fetches-per-boundary).

Memory model — the fixed-memory guarantee is the whole point:

- each series owns one **raw ring** (a bounded deque of ``(t_ms, value)``
  points) plus one bounded ring per **downsample rung** (default
  raw → 10 s → 1 m).  Rungs are *staged*: a sealed 10 s bucket feeds the
  1 m rung as an aggregate, so count/sum/min/max/last at every rung agree
  exactly with a naive recompute from the raw points that built them;
- one global **stream log** (bounded deque) assigns each accepted point a
  monotone sequence number; a reader that reconnects with its last-seen
  cursor gets every retained event exactly once;
- the **byte budget** caps the worst case: a write that would *create a
  new series* whose fully-populated rings no longer fit under the budget
  is dropped (and counted) instead of admitted.  Writes to existing series
  can never grow the store past its admitted worst case — the rings are
  bounded by construction.

Accounting sensors (the ``Executor.journal-bytes`` idiom):
``Telemetry.store-bytes`` (estimated resident bytes),
``Telemetry.points-total`` and ``Telemetry.points-dropped`` (budget
rejections + ring-retention evictions).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.common.sensors import SENSORS

#: Default downsample ladder: (step_ms, ring capacity in sealed buckets).
#: 10 s × 360 = 1 h; 60 s × 240 = 4 h of retention per series.
DEFAULT_RUNGS: Tuple[Tuple[int, int], ...] = ((10_000, 360), (60_000, 240))
#: Raw ring capacity (points per series).
DEFAULT_RAW_CAPACITY = 512
#: Stream log capacity (events, global).
DEFAULT_STREAM_CAPACITY = 4096
#: Default byte budget (~4 MB resident worst case — headroom for the ~16
#: series the full service publishes plus the stream log's worst case,
#: with room for a few dozen more before admission control kicks in).
DEFAULT_BYTE_BUDGET = 4_000_000

# Approximate per-entry heap costs for the byte accounting.  These are
# deliberately round overestimates of CPython's real footprint (tuple of
# two floats ≈ 56 B + float boxes; a 6-tuple bucket ≈ 96 B; an event dict
# interned to 4 keys ≈ 120 B) so the budget errs toward dropping early.
POINT_BYTES = 72
BUCKET_BYTES = 112
EVENT_BYTES = 160
SERIES_BYTES = 640  # fixed per-series overhead: dict slot, deques, rungs

# Canonical series names the publishers use (facade / detector manager /
# executor ledger) — the SLA engine reads these.  Kept here so publisher
# and consumer cannot drift apart.
BALANCEDNESS_SERIES = ("detector.balancedness", "executor.balancedness")
HEAL_DURATION_SERIES = "detector.heal-duration-s"
HEAL_STARTED_SERIES = "detector.heal-started"
TASK_DURATION_SERIES = "executor.task-duration-ms"
REPLAN_CANCELLED_SERIES = "executor.replan.cancelled"
REPLAN_KEPT_SERIES = "executor.replan.kept"
REPLAN_ADDED_SERIES = "executor.replan.added"
STANDING_HIT_SERIES = "cruise.standing-hit"
FETCHES_SERIES = "cruise.fetches-per-boundary"

#: Sensor-registry families the service's state-updater loop bridges into
#: the store (one ``sensor.<family>`` cumulative point per sample tick) —
#: see :meth:`TimeSeriesStore.sample_sensors`.
SENSOR_SAMPLE_FAMILIES = (
    "AnomalyDetector.heals-started",
    "AnomalyDetector.heals-failed",
    "CruiseControl.standing-hits",
    "CruiseControl.warm-solves",
    "CruiseControl.warm-fallbacks",
)


class _Rung:
    """One downsample stage: bounded ring of sealed buckets + the open one.

    A bucket is the 6-tuple ``(t_ms, count, sum, min, max, last)`` where
    ``t_ms`` is the bucket's aligned start.  ``feed`` merges an aggregate
    into the open bucket; when the incoming key advances past it, the open
    bucket seals into the ring and is returned so the caller can cascade
    it into the next (coarser) rung — staged downsampling keeps every
    aggregate exact (sums of sums, mins of mins)."""

    __slots__ = ("step_ms", "ring", "_open")

    def __init__(self, step_ms: int, capacity: int):
        self.step_ms = int(step_ms)
        self.ring: deque = deque(maxlen=max(2, capacity))
        self._open: Optional[list] = None  # [t, count, sum, min, max, last]

    def feed(self, t_ms: int, count: int, vsum: float, vmin: float,
             vmax: float, last: float) -> Optional[tuple]:
        key = (t_ms // self.step_ms) * self.step_ms
        o = self._open
        if o is None:
            self._open = [key, count, vsum, vmin, vmax, last]
            return None
        if key <= o[0]:
            # Same bucket — or a late point, merged into the open bucket
            # rather than reopening a sealed one (publishers are monotone
            # per series; batch-scored checkpoints may lag slightly).
            o[1] += count
            o[2] += vsum
            o[3] = min(o[3], vmin)
            o[4] = max(o[4], vmax)
            o[5] = last
            return None
        sealed = tuple(o)
        self.ring.append(sealed)
        self._open = [key, count, vsum, vmin, vmax, last]
        return sealed

    def buckets(self) -> List[tuple]:
        """Sealed buckets plus the open one (partial, still filling)."""
        out = list(self.ring)
        if self._open is not None:
            out.append(tuple(self._open))
        return out

    def resident(self) -> int:
        return len(self.ring) + (1 if self._open is not None else 0)


class _Series:
    __slots__ = ("raw", "rungs")

    def __init__(self, raw_capacity: int,
                 rungs: Sequence[Tuple[int, int]]):
        self.raw: deque = deque(maxlen=max(8, raw_capacity))
        self.rungs: List[_Rung] = [_Rung(s, c) for s, c in rungs]

    def add(self, t_ms: int, value: float) -> bool:
        """Append one point; cascade the downsample rungs.  Returns True
        when the raw ring evicted a point to make room."""
        evicted = len(self.raw) == self.raw.maxlen
        self.raw.append((t_ms, value))
        carry: Optional[tuple] = (t_ms, 1, value, value, value, value)
        for rung in self.rungs:
            if carry is None:
                break
            carry = rung.feed(*carry)
        return evicted


def _percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile: the smallest value with at least ``q`` of
    the sample at or below it (p99 of 6 samples is the 6th, not the 5th)."""
    if not values:
        return None
    ordered = sorted(values)
    rank = math.ceil(q * len(ordered))
    return ordered[max(0, rank - 1)]


class TimeSeriesStore:
    """Lock-guarded, fixed-memory telemetry store.  See the module doc."""

    def __init__(self, raw_capacity: int = DEFAULT_RAW_CAPACITY,
                 rungs: Sequence[Tuple[int, int]] = DEFAULT_RUNGS,
                 stream_capacity: int = DEFAULT_STREAM_CAPACITY,
                 byte_budget: int = DEFAULT_BYTE_BUDGET,
                 clock_ms: Optional[Callable[[], float]] = None,
                 register_sensors: bool = False):
        self._raw_capacity = max(8, int(raw_capacity))
        self._rung_spec = tuple((int(s), int(c)) for s, c in rungs)
        if any(b[0] >= a[0] for b, a in zip(self._rung_spec,
                                            self._rung_spec[1:])):
            raise ValueError("downsample rungs must have increasing steps")
        self._byte_budget = int(byte_budget)
        self._clock_ms = clock_ms or (lambda: time.time() * 1000.0)
        self._register = bool(register_sensors)
        self._lock = threading.Lock()
        self._series: Dict[str, _Series] = {}  # guarded-by: _lock
        self._log: deque = deque(maxlen=max(16, stream_capacity))  # guarded-by: _lock
        self._seq = 0          # guarded-by: _lock
        self._total = 0        # guarded-by: _lock
        self._dropped = 0      # guarded-by: _lock
        self._committed_bytes = self._stream_worst_bytes()  # guarded-by: _lock
        self._bytes_gauge = None  # identity probe for _ensure_sensors
        self._ensure_sensors()

    # -- configuration / accounting -----------------------------------------
    def _series_worst_bytes(self) -> int:
        return (SERIES_BYTES + self._raw_capacity * POINT_BYTES
                + sum((c + 1) * BUCKET_BYTES for _, c in self._rung_spec))

    def _stream_worst_bytes(self) -> int:
        return (self._log.maxlen or 0) * EVENT_BYTES

    def byte_budget(self) -> int:
        return self._byte_budget

    def store_bytes(self) -> int:
        """Estimated resident bytes (points/buckets/events actually held)."""
        with self._lock:
            total = len(self._log) * EVENT_BYTES
            for s in self._series.values():
                total += SERIES_BYTES + len(s.raw) * POINT_BYTES
                total += sum(r.resident() * BUCKET_BYTES for r in s.rungs)
            return total

    def committed_bytes(self) -> int:
        """Worst-case bytes of everything admitted so far — what the byte
        budget actually gates on (resident bytes only ever grow toward it)."""
        with self._lock:
            return self._committed_bytes

    @property
    def points_total(self) -> int:
        with self._lock:
            return self._total

    @property
    def points_dropped(self) -> int:
        with self._lock:
            return self._dropped

    def set_clock(self, clock_ms: Optional[Callable[[], float]]) -> None:
        """Swap the default timestamp source (the SLA soak pins it to the
        simulated fleet's virtual clock so series read in fleet time)."""
        self._clock_ms = clock_ms or (lambda: time.time() * 1000.0)

    def config_dict(self) -> Dict[str, object]:
        return {
            "rawCapacity": self._raw_capacity,
            "rungs": [{"stepMs": s, "capacity": c}
                      for s, c in self._rung_spec],
            "streamCapacity": self._log.maxlen,
            "byteBudget": self._byte_budget,
            "committedBytes": self.committed_bytes(),
            "storeBytes": self.store_bytes(),
            "pointsTotal": self.points_total,
            "pointsDropped": self.points_dropped,
        }

    def _ensure_sensors(self) -> None:
        """(Re-)register the accounting gauges.  Called on every record so
        a ``SENSORS.reset()`` between tests cannot silently un-catalog the
        family.  Probing first (identity check on the registered Gauge)
        keeps the common case to one dict lookup and avoids the registry's
        duplicate-callback warning; after a reset the probe materialises a
        callback-less gauge which the fn registration then upgrades."""
        if not self._register:
            return
        probe = SENSORS.gauge(
            "Telemetry.store-bytes",
            help="Estimated resident bytes of the telemetry "
                 "time-series store (rings + stream log)")
        if probe is self._bytes_gauge:
            return
        self._bytes_gauge = SENSORS.gauge("Telemetry.store-bytes",
                                          fn=self.store_bytes)
        SENSORS.gauge("Telemetry.points-total", fn=lambda: self.points_total,
                      help="Points accepted into the telemetry store")
        SENSORS.gauge("Telemetry.points-dropped",
                      fn=lambda: self.points_dropped,
                      help="Points dropped by the telemetry store: byte-"
                           "budget rejections plus ring-retention "
                           "evictions")

    # -- write path ----------------------------------------------------------
    def record(self, name: str, value: float,
               t_ms: Optional[float] = None) -> bool:
        """Publish one point.  Returns False when the byte budget rejected
        it (a new series no longer fits).  Pure host work — never touches
        a device."""
        self._ensure_sensors()
        t = int(t_ms if t_ms is not None else self._clock_ms())
        v = float(value)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                if (self._committed_bytes + self._series_worst_bytes()
                        > self._byte_budget):
                    self._dropped += 1
                    return False
                s = _Series(self._raw_capacity, self._rung_spec)
                self._series[name] = s
                self._committed_bytes += self._series_worst_bytes()
            if s.add(t, v):
                self._dropped += 1  # raw ring evicted its oldest point
            self._total += 1
            self._seq += 1
            self._log.append({"seq": self._seq, "tMs": t,
                              "series": name, "value": v})
            return True

    def sample_sensors(self, names: Sequence[str],
                       t_ms: Optional[float] = None,
                       prefix: str = "sensor.") -> int:
        """Publish selected sensor-registry counter/gauge families as
        series (one point per family, summed over label sets) — the sensor
        registry's bridge into the retention layer.  Returns #published."""
        snap = SENSORS.snapshot()
        wanted = tuple(names)
        totals: Dict[str, float] = {}
        for key, value in snap.items():
            if not isinstance(value, (int, float)):
                continue  # histogram/timer dicts summarize elsewhere
            family = key.split("{", 1)[0]
            if family in wanted:
                totals[family] = totals.get(family, 0.0) + float(value)
        for family, total in sorted(totals.items()):
            self.record(prefix + family, total, t_ms=t_ms)
        return len(totals)

    # -- read path -----------------------------------------------------------
    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def latest(self, name: str) -> Optional[Tuple[int, float]]:
        with self._lock:
            s = self._series.get(name)
            if s is None or not s.raw:
                return None
            return s.raw[-1]

    def _now_ms(self) -> int:
        return int(self._clock_ms())

    def query(self, name: str, window_ms: Optional[int] = None,
              step_ms: Optional[int] = None,
              now_ms: Optional[float] = None) -> List[Dict[str, object]]:
        """Windowed aggregates.  ``step_ms`` picks the source resolution:
        below the first rung's step the raw points are grouped directly;
        otherwise the finest rung whose step divides into the request is
        re-grouped (exact — staged aggregates merge losslessly).  Each
        point is ``{"tMs", "count", "sum", "min", "max", "last", "mean"}``
        for its aligned ``step_ms`` bucket."""
        step = int(step_ms) if step_ms else 0
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            raw = list(s.raw)
            source: List[tuple]
            if step <= 0 or not s.rungs or step < s.rungs[0].step_ms:
                source = [(t, 1, v, v, v, v) for t, v in raw]
                step = max(step, 1)
            else:
                idx = 0
                for i, r in enumerate(s.rungs):
                    if r.step_ms <= step:
                        idx = i
                source = s.rungs[idx].buckets()
                # Tail exactness: the newest points are still sitting in
                # finer rungs' OPEN buckets (they only cascade on seal).
                # Those opens are disjoint from the serving rung's
                # contents, so merging them in makes every bucket —
                # including the tail — agree with a naive recompute.
                # Appended last = newest, so the grouped "last" stays the
                # chronologically latest value.
                for r in s.rungs[:idx]:
                    if r._open is not None:
                        source.append(tuple(r._open))
        now = int(now_ms) if now_ms is not None else \
            (source[-1][0] if source else self._now_ms())
        lo = now - int(window_ms) if window_ms else None
        grouped: Dict[int, list] = {}
        for t, count, vsum, vmin, vmax, last in source:
            if lo is not None and t < lo:
                continue
            key = (t // step) * step
            g = grouped.get(key)
            if g is None:
                grouped[key] = [key, count, vsum, vmin, vmax, last]
            else:
                g[1] += count
                g[2] += vsum
                g[3] = min(g[3], vmin)
                g[4] = max(g[4], vmax)
                g[5] = last
        out = []
        for key in sorted(grouped):
            _, count, vsum, vmin, vmax, last = grouped[key]
            out.append({"tMs": key, "count": count, "sum": vsum,
                        "min": vmin, "max": vmax, "last": last,
                        "mean": vsum / count})
        return out

    def stream_since(self, since: int, limit: int = 1000
                     ) -> Tuple[List[dict], int, bool]:
        """Events with ``seq > since`` in order, capped at ``limit``.

        Returns ``(events, cursor, truncated)`` — ``cursor`` is the last
        returned seq (or ``since`` when nothing new), ``truncated`` is
        True when the log's ring already evicted events the cursor missed
        (the reader must re-sync from a full ``/timeseries`` read).
        Sequence numbers are assigned contiguously, so within retention a
        reconnect at its last cursor sees no gaps and no duplicates."""
        since = max(0, int(since))
        limit = max(1, int(limit))
        with self._lock:
            if not self._log:
                return [], since, False
            first = self._log[0]["seq"]
            truncated = since + 1 < first
            start = max(0, since + 1 - first)
            events = [dict(self._log[i])
                      for i in range(start,
                                     min(len(self._log), start + limit))]
        cursor = events[-1]["seq"] if events else since
        return events, cursor, truncated

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self._log.clear()
            self._seq = 0
            self._total = 0
            self._dropped = 0
            self._committed_bytes = self._stream_worst_bytes()

    # -- SLA rollup engine ---------------------------------------------------
    def _window_values(self, name: str, lo: int) -> List[float]:  # holds-lock: _lock
        s = self._series.get(name)
        if s is None:
            return []
        return [v for t, v in s.raw if t >= lo]

    def _window_floor(self, name: str, lo: int) -> Optional[float]:  # holds-lock: _lock
        """Exact minimum over the window: raw points plus every rung
        bucket's min, so the floor survives raw-ring aging."""
        s = self._series.get(name)
        if s is None:
            return None
        lows = [v for t, v in s.raw if t >= lo]
        if s.raw and s.raw[0][0] <= lo:
            # The raw ring still reaches past the window start: exact.
            return min(lows) if lows else None
        # Raw aged out: merge rung bucket minima, including the bucket
        # that straddles ``lo`` — conservative (the floor can only read
        # lower than the true in-window minimum, never higher).
        for rung in s.rungs:
            lows.extend(b[3] for b in rung.buckets()
                        if b[0] + rung.step_ms > lo)
        return min(lows) if lows else None

    @staticmethod
    def _dist(values: Sequence[float]) -> Optional[Dict[str, float]]:
        if not values:
            return None
        return {"count": len(values),
                "mean": sum(values) / len(values),
                "p50": _percentile(values, 0.50),
                "p99": _percentile(values, 0.99),
                "max": max(values),
                "min": min(values)}

    def sla(self, window_ms: int = 3_600_000,
            now_ms: Optional[float] = None) -> Dict[str, object]:
        """Windowed SLA rollups over the canonical series (see module doc).
        Blocks whose source series have no points in the window are None —
        the consumer distinguishes "no heals happened" from "heal latency
        was zero"."""
        now = int(now_ms) if now_ms is not None else self._now_ms()
        lo = now - int(window_ms)
        with self._lock:
            # The two balancedness series are different quantities on
            # different scales — the detector's 0–100 fleet-health score
            # vs the executor's 0–1 goal-distance-closed checkpoints — so
            # they roll up as separate blocks, never merged.
            det_name, ex_name = BALANCEDNESS_SERIES
            bal = self._window_values(det_name, lo)
            bal_floor = self._window_floor(det_name, lo)
            ex_bal = self._window_values(ex_name, lo)
            ex_floor = self._window_floor(ex_name, lo)
            heal_durations = self._window_values(HEAL_DURATION_SERIES, lo)
            heal_flags = self._window_values(HEAL_STARTED_SERIES, lo)
            task_durations = self._window_values(TASK_DURATION_SERIES, lo)
            cancelled = sum(self._window_values(REPLAN_CANCELLED_SERIES, lo))
            kept = sum(self._window_values(REPLAN_KEPT_SERIES, lo))
            added = sum(self._window_values(REPLAN_ADDED_SERIES, lo))
            replans = len(self._window_values(REPLAN_CANCELLED_SERIES, lo))
            hits = self._window_values(STANDING_HIT_SERIES, lo)
            fetches = self._window_values(FETCHES_SERIES, lo)
        def roll(values, floor):
            if not values:
                return None
            return {"floor": floor if floor is not None else min(values),
                    "p50": _percentile(values, 0.50),
                    "p99": _percentile(values, 0.99),
                    "last": values[-1],
                    "samples": len(values)}

        balancedness = roll(bal, bal_floor)
        executor_balancedness = roll(ex_bal, ex_floor)
        churn = None
        if replans:
            moves = cancelled + kept + added
            churn = {"replans": replans, "cancelled": cancelled,
                     "kept": kept, "added": added,
                     "churnRatio": (cancelled + added) / moves
                     if moves else 0.0}
        return {
            "windowMs": int(window_ms),
            "nowMs": now,
            "balancedness": balancedness,
            "executorBalancedness": executor_balancedness,
            "healLatencySeconds": self._dist(heal_durations),
            "healsStarted": int(sum(1 for f in heal_flags if f > 0)),
            "healsFailed": int(sum(1 for f in heal_flags if f <= 0)),
            "taskDurationMs": self._dist(task_durations),
            "replanChurn": churn,
            "standingHitRatio": (sum(hits) / len(hits)) if hits else None,
            "fetchesPerBoundary": self._dist(fetches),
            "store": {"bytes": self.store_bytes(),
                      "budget": self._byte_budget,
                      "dropped": self.points_dropped},
        }


#: The process-wide store every publisher writes into (the SENSORS/TRACE
#: singleton idiom).  Tests build private stores; the singleton's
#: accounting gauges are the cataloged ones.
TELEMETRY = TimeSeriesStore(register_sensors=True)
