"""Observability sensors: counters, gauges, timers, histograms.

Parity with the reference's Dropwizard MetricRegistry → JMX domain
``kafka.cruisecontrol`` (KafkaCruiseControlApp.java:39-41; sensor list in
docs/wiki/User Guide/Sensors.md; registrations at LoadMonitor.java:180-195,
Executor.registerGaugeSensors Executor.java:271, AnomalyDetectorState.java).
A JVM-free build has no JMX; sensors surface through ``/state`` JSON and a
``/metrics`` Prometheus text endpoint instead.

Sensor kinds:
- Counter: monotonically increasing count (anomaly counts, completed tasks).
- Gauge: instantaneous value, either set explicitly or computed by a
  callback at read time (valid-windows, in-progress movements).
- Timer: event durations — count, mean, max, and a decaying last-N
  percentile window (proposal-computation-timer).  Exposed to Prometheus
  as a summary (``{quantile="0.99"}`` + ``_sum`` + ``_count``).
- Histogram: fixed exponential buckets — the Prometheus-native duration
  sensor (``_bucket``/``_sum``/``_count`` series), used by the request
  latency and phase-duration instrumentation.

Every sensor accepts an optional ``labels`` dict; each distinct label set
is its own series under one metric family (one ``# HELP``/``# TYPE`` pair
in the exposition).  The exposition is text-format 0.0.4 compliant: label
values are escaped, histogram buckets are cumulative and close with
``+Inf``, and name mangling (``.``/``-`` → ``_``) is collision-checked at
registration time (``a.b`` vs ``a-b`` would otherwise silently overwrite
each other — the later family gets a numeric suffix instead).
"""

from __future__ import annotations

import logging
import math
import re
import threading
import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Tuple)

log = logging.getLogger(__name__)

#: A series key: (metric family name, sorted (label, value) pairs).
LabelKey = Tuple[Tuple[str, str], ...]

#: Default exponential bucket ladder: 1 ms × 4^i — spans sub-ms endpoint
#: hits up to multi-minute 1M-replica optimizations in 10 buckets.
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(0.001 * 4 ** i for i in range(10))


def _label_key(labels: Optional[Dict[str, object]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _render_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(key) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"'
                          for k, v in pairs) + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _series_name(name: str, key: LabelKey) -> str:
    """JSON snapshot key for one series: bare family name when unlabeled,
    ``name{k="v",...}`` otherwise (stable: labels are sorted)."""
    return name + _render_labels(key)


class Counter:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def count(self) -> int:
        return self._v


class Gauge:
    def __init__(self, fn: Optional[Callable[[], float]] = None):
        self._fn = fn
        self._v: float = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return self._v


class _TimeCtx:
    """Context manager timing a block into an ``update(seconds)`` sensor."""

    __slots__ = ("_sensor", "_t0")

    def __init__(self, sensor):
        self._sensor = sensor

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._sensor.update(time.monotonic() - self._t0)
        return False


class Timer:
    """Duration sensor with a bounded sample window for percentiles."""

    def __init__(self, window: int = 128):
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._max = 0.0
        self._samples: Deque[float] = deque(maxlen=window)

    def update(self, seconds: float) -> None:
        with self._lock:
            self._count += 1
            self._total += seconds
            self._max = max(self._max, seconds)
            self._samples.append(seconds)

    def time(self) -> _TimeCtx:
        return _TimeCtx(self)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            n = self._count
            mean = self._total / n if n else 0.0
            samples = sorted(self._samples)
            p99 = samples[int(0.99 * (len(samples) - 1))] if samples else 0.0
            return {"count": n, "mean_s": mean, "max_s": self._max,
                    "p99_s": p99, "sum_s": self._total}


class Histogram:
    """Cumulative-bucket duration/size sensor (Prometheus histogram type).

    Buckets are fixed upper bounds (sorted ascending); observations land in
    the first bucket whose bound is >= the value, with an implicit ``+Inf``
    bucket equal to the total count.  ``update`` aliases ``observe`` so
    ``Histogram`` is a drop-in for ``Timer`` under ``.time()``.
    """

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        bs = tuple(sorted(float(b) for b in buckets)) if buckets \
            else DEFAULT_BUCKETS
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self._buckets = bs
        self._counts = [0] * len(bs)  # per-bucket, non-cumulative
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._buckets

    def observe(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            for i, le in enumerate(self._buckets):
                if v <= le:
                    self._counts[i] += 1
                    break

    update = observe

    def time(self) -> _TimeCtx:
        return _TimeCtx(self)

    def snapshot(self) -> Dict[str, object]:
        """count / sum plus CUMULATIVE bucket counts keyed by bound."""
        with self._lock:
            cum, running = {}, 0
            for le, c in zip(self._buckets, self._counts):
                running += c
                cum[_fmt_value(le)] = running
            cum["+Inf"] = self._count
            return {"count": self._count, "sum_s": self._sum, "buckets": cum}


_CLEAN_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _clean(name: str) -> str:
    return _CLEAN_RE.sub("_", name)


class MetricRegistry:
    """Name → sensor registry; one per process (``SENSORS``).

    A metric *family* (one name, one kind, one optional help string) holds
    one series per distinct label set.  Families register on first use;
    the Prometheus exposition name is fixed then, with collision detection
    on the mangled form.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._timers: Dict[Tuple[str, LabelKey], Timer] = {}
        self._histograms: Dict[Tuple[str, LabelKey], Histogram] = {}
        # family name → (kind, help text); exposition-name bookkeeping.
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._expo: Dict[str, str] = {}           # family → mangled name
        self._mangled_owner: Dict[str, str] = {}  # mangled name → family

    # -- family registration (under self._lock) ----------------------------
    def _register_family(self, name: str, kind: str, help_text: str) -> None:
        existing = self._meta.get(name)
        if existing is not None:
            if existing[0] != kind:
                log.warning("sensor %r already registered as %s; ignoring "
                            "re-registration as %s", name, existing[0], kind)
            elif help_text and not existing[1]:
                self._meta[name] = (kind, help_text)
            return
        self._meta[name] = (kind, help_text)
        base = _clean(name)
        expo, n = base, 2
        while expo in self._mangled_owner and \
                self._mangled_owner[expo] != name:
            expo = f"{base}_{n}"
            n += 1
        if expo != base:
            # a.b and a-b both mangle to a_b: without this, the second
            # family silently overwrites the first in the exposition.
            log.warning("prometheus name collision: %r and %r both mangle "
                        "to %r; exposing %r as %r",
                        self._mangled_owner[base], name, base, name, expo)
        self._mangled_owner[expo] = name
        self._expo[name] = expo

    # -- sensor accessors ---------------------------------------------------
    def counter(self, name: str, labels: Optional[Dict[str, object]] = None,
                help: str = "") -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = Counter()
                self._counters[key] = c
                self._register_family(name, "counter", help)
            return c

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              labels: Optional[Dict[str, object]] = None,
              help: str = "") -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = Gauge(fn)
                self._gauges[key] = g
                self._register_family(name, "gauge", help)
            elif fn is not None:
                if g._fn is None:
                    g._fn = fn  # upgrade a set-style gauge to a callback
                elif g._fn is not fn:
                    # Keep the FIRST registration: replacing would let two
                    # subsystems silently shadow each other's gauge.
                    log.warning("gauge %r already has a callback; ignoring "
                                "duplicate registration", _series_name(*key))
            return g

    def timer(self, name: str, labels: Optional[Dict[str, object]] = None,
              help: str = "") -> Timer:
        key = (name, _label_key(labels))
        with self._lock:
            t = self._timers.get(key)
            if t is None:
                t = Timer()
                self._timers[key] = t
                self._register_family(name, "summary", help)
            return t

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  labels: Optional[Dict[str, object]] = None,
                  help: str = "") -> Histogram:
        """First registration of a family fixes its bucket ladder; later
        calls (any label set) reuse it so the family's series align."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                family = next((v for (n, _), v in self._histograms.items()
                               if n == name), None)
                h = Histogram(buckets if family is None else family.buckets)
                self._histograms[key] = h
                self._register_family(name, "histogram", help)
            return h

    # -- read surfaces ------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """All sensors as one JSON-able dict (the /state surface).  A gauge
        whose callback failed reports None — ``json.dumps`` would otherwise
        emit a bare ``NaN`` literal that strict parsers reject, letting one
        broken sensor break the whole /state payload."""
        out: Dict[str, object] = {}
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = dict(self._timers)
            histograms = dict(self._histograms)
        for (name, lk), c in sorted(counters.items()):
            out[_series_name(name, lk)] = c.count
        for (name, lk), g in sorted(gauges.items()):
            v = g.value
            out[_series_name(name, lk)] = v if math.isfinite(v) else None
        for (name, lk), t in sorted(timers.items()):
            out[_series_name(name, lk)] = t.snapshot()
        for (name, lk), h in sorted(histograms.items()):
            out[_series_name(name, lk)] = h.snapshot()
        return out

    def catalog(self) -> List[Dict[str, object]]:
        """Sensor-family inventory (the JAX package's docs/OBSERVABILITY.md
        is generated from the same method of its registry)."""
        with self._lock:
            meta = dict(self._meta)
            expo = dict(self._expo)
            keys = (list(self._counters) + list(self._gauges) +
                    list(self._timers) + list(self._histograms))
        label_names: Dict[str, set] = {}
        for name, lk in keys:
            label_names.setdefault(name, set()).update(k for k, _ in lk)
        return [{"name": name, "kind": kind,
                 "prometheus": expo.get(name, _clean(name)),
                 "labels": sorted(label_names.get(name, ())),
                 "help": help_text}
                for name, (kind, help_text) in sorted(meta.items())]

    def prometheus_text(self, prefix: str = "kafka_cruisecontrol") -> str:
        """Prometheus text-format 0.0.4 exposition (the /metrics surface):
        ``# HELP``/``# TYPE`` per family, label-rendered series, histogram
        ``_bucket``/``_sum``/``_count``, timer summaries."""
        with self._lock:
            meta = dict(self._meta)
            expo = dict(self._expo)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            timers = dict(self._timers)
            histograms = dict(self._histograms)

        def series_of(table, family):
            return sorted((lk, s) for (n, lk), s in table.items()
                          if n == family)

        lines: List[str] = []
        for name, (kind, help_text) in sorted(meta.items()):
            metric = f"{prefix}_{expo.get(name, _clean(name))}"
            body: List[str] = []
            if kind == "counter":
                for lk, c in series_of(counters, name):
                    body.append(f"{metric}{_render_labels(lk)} {c.count}")
            elif kind == "gauge":
                for lk, g in series_of(gauges, name):
                    v = g.value
                    if math.isfinite(v):  # failed callbacks are omitted
                        body.append(f"{metric}{_render_labels(lk)} "
                                    f"{_fmt_value(v)}")
            elif kind == "summary":
                for lk, t in series_of(timers, name):
                    s = t.snapshot()
                    body.append(
                        f"{metric}{_render_labels(lk, [('quantile', '0.99')])}"
                        f" {_fmt_value(s['p99_s'])}")
                    body.append(f"{metric}_sum{_render_labels(lk)} "
                                f"{_fmt_value(s['sum_s'])}")
                    body.append(f"{metric}_count{_render_labels(lk)} "
                                f"{s['count']}")
            elif kind == "histogram":
                for lk, h in series_of(histograms, name):
                    s = h.snapshot()
                    for le, cum in s["buckets"].items():
                        body.append(
                            f"{metric}_bucket{_render_labels(lk, [('le', le)])}"
                            f" {cum}")
                    body.append(f"{metric}_sum{_render_labels(lk)} "
                                f"{_fmt_value(s['sum_s'])}")
                    body.append(f"{metric}_count{_render_labels(lk)} "
                                f"{s['count']}")
            if not body:
                continue
            lines.append(f"# HELP {metric} "
                         f"{(help_text or name).replace(chr(10), ' ')}")
            lines.append(f"# TYPE {metric} {kind}")
            lines.extend(body)
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timers.clear()
            self._histograms.clear()
            self._meta.clear()
            self._expo.clear()
            self._mangled_owner.clear()


#: Process-wide registry (the reference's shared Dropwizard registry).
SENSORS = MetricRegistry()
