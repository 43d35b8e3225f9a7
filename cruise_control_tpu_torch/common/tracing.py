"""Lightweight span tracing for admin operations.

The reference logs operation progress through ``OperationLogger`` and
exposes step durations via per-sensor timers; debugging a slow rebalance
still means correlating log lines by hand.  Here every admin operation
builds one *trace*: a tree of named spans (monitor snapshot → model build →
per-goal fixpoint → proposal materialization → executor phases) with wall
durations and small attribute dicts (steps, actions, fresh_compile, task
counts).

Design constraints:
- Zero hard dependencies, no background thread, O(1) per span.
- Thread-local span stack: concurrent operations (one per UserTask worker
  thread) never interleave spans.
- Bounded memory: finished ROOT traces land in a ring buffer
  (``maxlen=256``); children live only inside their root's tree.
- Post-hoc children via ``record()``: the fused goal-stack optimizer gets
  per-goal durations back from a single device dispatch AFTER the fact, so
  per-goal spans are recorded retroactively rather than via ``with``.

Surfaces: ``GET /trace?task_id=...`` (api/server.py), per-task attachment
in ``UserTaskManager``, and a rollup inside ``/state``'s Sensors block.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

_TRACE_RING = 256


class Span:
    """One timed node in a trace tree."""

    __slots__ = ("name", "start_ms", "duration_ms", "attrs", "children",
                 "trace_id", "_t0")

    def __init__(self, name: str, start_ms: float,
                 attrs: Dict[str, Any]):
        self.name = name
        self.start_ms = start_ms
        self.duration_ms: float = 0.0
        self.attrs = attrs
        self.children: List["Span"] = []
        self.trace_id: Optional[str] = None  # set on roots at finish

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "startMs": round(self.start_ms, 3),
            "durationMs": round(self.duration_ms, 3),
        }
        if self.trace_id is not None:
            d["traceId"] = self.trace_id
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _SpanCtx:
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def annotate(self, **attrs: Any) -> None:
        self._span.attrs.update(attrs)

    @property
    def trace_id(self) -> Optional[str]:
        """The trace id, set at exit when this span turned out to be a
        root; None while open or for child spans."""
        return self._span.trace_id

    def __enter__(self) -> "_SpanCtx":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._finish(self._span)
        return False


class Tracer:
    """Thread-local span stack + bounded ring of finished root traces."""

    def __init__(self, ring: int = _TRACE_RING):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._finished: Deque[Dict[str, Any]] = deque(maxlen=ring)
        self._by_id: Dict[str, Dict[str, Any]] = {}
        self._seq = 0

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- span lifecycle -----------------------------------------------------
    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        s = Span(name, time.time() * 1000.0, attrs)
        st = self._stack()
        s._t0 = time.monotonic()
        if st:
            st[-1].children.append(s)
        st.append(s)
        return _SpanCtx(self, s)

    def _finish(self, span: Span) -> None:
        span.duration_ms = (time.monotonic() - span._t0) * 1000.0
        st = self._stack()
        # Pop through any orphans left by mispaired exits.
        while st and st[-1] is not span:
            st.pop()
        if st:
            st.pop()
        if not st:  # root finished → into the ring
            with self._lock:
                self._seq += 1
                span.trace_id = f"t{self._seq:06d}"
                d = span.to_dict()
                if len(self._finished) == self._finished.maxlen:
                    evicted = self._finished[0]
                    self._by_id.pop(evicted.get("traceId", ""), None)
                self._finished.append(d)
                self._by_id[span.trace_id] = d

    def record(self, name: str, duration_s: float, **attrs: Any) -> None:
        """Attach an already-measured child span to the current span (or as
        a degenerate root when none is active).  Used where durations come
        back in bulk after one fused device dispatch."""
        now_ms = time.time() * 1000.0
        s = Span(name, now_ms - duration_s * 1000.0, attrs)
        s.duration_ms = duration_s * 1000.0
        st = self._stack()
        if st:
            st[-1].children.append(s)
        else:
            with self._lock:
                self._seq += 1
                s.trace_id = f"t{self._seq:06d}"
                d = s.to_dict()
                if len(self._finished) == self._finished.maxlen:
                    evicted = self._finished[0]
                    self._by_id.pop(evicted.get("traceId", ""), None)
                self._finished.append(d)
                self._by_id[s.trace_id] = d

    def annotate(self, **attrs: Any) -> None:
        """Add attributes to the innermost active span; no-op outside one."""
        st = self._stack()
        if st:
            st[-1].attrs.update(attrs)

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # -- read surfaces ------------------------------------------------------
    def recent(self, n: int = 20) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self._finished)
        return items[-n:][::-1]

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._by_id.get(trace_id)

    def rollup(self) -> Dict[str, Dict[str, float]]:
        """Per-root-name {count, totalMs, maxMs} summary for /state."""
        with self._lock:
            items = list(self._finished)
        out: Dict[str, Dict[str, float]] = {}
        for t in items:
            r = out.setdefault(t["name"],
                               {"count": 0, "totalMs": 0.0, "maxMs": 0.0})
            r["count"] += 1
            r["totalMs"] = round(r["totalMs"] + t["durationMs"], 3)
            r["maxMs"] = max(r["maxMs"], t["durationMs"])
        return out

    def reset(self) -> None:
        with self._lock:
            self._finished.clear()
            self._by_id.clear()
            self._seq = 0
        self._local = threading.local()


#: Process-wide tracer, mirroring ``SENSORS`` in common/sensors.py.
TRACE = Tracer()
