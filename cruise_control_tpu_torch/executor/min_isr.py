"""Topic min.insync.replicas cache + (At/Under)MinISR pressure check.

Parity with ``TopicMinIsrCache`` (common/TopicMinIsrCache.java) and the
ConcurrencyAdjuster's MinISR gate (Executor.java:335-447 halves movement
concurrency while any partition sits at/under its topic's min ISR): topic
configs are fetched through the ClusterAdmin with a TTL so the wait loop
doesn't hammer DescribeConfigs every poll.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

from cruise_control_tpu_torch.monitor.metadata import ClusterMetadata


class TopicMinIsrCache:
    def __init__(self, admin, ttl_ms: int = 300_000):
        self._admin = admin
        self._ttl_s = ttl_ms / 1000.0
        self._lock = threading.Lock()
        self._cache: Dict[str, Tuple[int, float]] = {}  # topic → (min_isr, at)

    def min_isr(self, topic: str) -> int:
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(topic)
            if hit is not None and now - hit[1] < self._ttl_s:
                return hit[0]
        try:
            value = int(self._admin.min_isr(topic))
        except Exception:  # noqa: BLE001 — config fetch failure: assume 1
            value = 1
        with self._lock:
            self._cache[topic] = (value, now)
        return value


def min_isr_pressure(cluster: ClusterMetadata, cache: TopicMinIsrCache) -> bool:
    """True when any partition is under — or, for partitions whose RF leaves
    headroom, at — its topic's min ISR; the adjuster then halves concurrency
    instead of doubling it.  A partition whose RF equals min ISR (e.g. any
    RF=1 topic) is *always* at-min and must not count as standing pressure
    (the reference's AtMinIsr set excludes nothing less)."""
    alive = set(cluster.alive_broker_ids())
    for p in cluster.partitions:
        in_sync = sum(1 for b in p.replicas
                      if b in alive and b not in p.offline_replicas)
        min_isr = cache.min_isr(p.topic)
        if in_sync < min_isr:
            return True
        if len(p.replicas) > min_isr and in_sync <= min_isr:
            return True
    return False
