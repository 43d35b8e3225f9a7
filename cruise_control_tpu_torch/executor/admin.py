"""Cluster administration backend SPI + in-memory fake.

The reference mutates the cluster through Kafka AdminClient + ZooKeeper
(ExecutorUtils.scala:21 — /admin/reassign_partitions znode merges,
ExecutorAdminUtils.java — electLeaders/describeLogDirs,
ReplicationThrottleHelper.java — throttle configs).  Here every mutation
funnels through this ``ClusterAdmin`` SPI; production binds a Kafka admin
adapter at the edge, tests bind ``InMemoryClusterAdmin`` — the pure
in-memory fake cluster-state backend that replaces the reference's
embedded-Kafka harness (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, ClusterMetadata,
                                                 MetadataClient, PartitionInfo)

Tp = Tuple[str, int]


class TransientAdminError(RuntimeError):
    """A retryable admin-layer failure (network blip, controller handover,
    request timeout).  The executor's retry/backoff envelope retries these;
    anything else propagates."""


@dataclasses.dataclass
class ReassignmentRequest:
    tp: Tp
    new_replicas: Tuple[int, ...]  # preferred order, leader first


class ClusterAdmin:
    """SPI over the cluster's mutation + inspection surface."""

    def alter_partition_reassignments(self, requests: Sequence[ReassignmentRequest]) -> None:
        raise NotImplementedError

    def ongoing_reassignments(self) -> Set[Tp]:
        raise NotImplementedError

    def cancel_reassignments(self, tps: Optional[Sequence[Tp]] = None) -> None:
        """Cancel ongoing reassignments (force-stop path; the reference
        deletes the reassignment znode, Executor.java:1137-1139)."""
        raise NotImplementedError

    def elect_leaders(self, tps: Sequence[Tp]) -> None:
        """Preferred leader election (ExecutorUtils PLE path)."""
        raise NotImplementedError

    def alter_replica_logdirs(self, moves: Sequence[Tuple[Tp, int, str]]) -> None:
        """(tp, broker, target logdir) intra-broker moves."""
        raise NotImplementedError

    def set_replication_throttles(self, rate_bytes_per_sec: int,
                                  brokers: Sequence[int],
                                  throttled_replicas: Dict[str, List[str]]) -> None:
        raise NotImplementedError

    def clear_replication_throttles(self, brokers: Sequence[int],
                                    throttled_replicas: Dict[str, List[str]]) -> None:
        """Remove exactly the given throttle entries (and the rate on the
        given brokers when no entries remain), leaving operator-set throttle
        config untouched — ReplicationThrottleHelper's diff-based cleanup."""
        raise NotImplementedError

    def min_isr(self, topic: str) -> int:
        return 1

    def describe_logdirs(self) -> Dict[int, Dict[str, bool]]:
        """broker → {logdir → is_online} (ExecutorAdminUtils/DiskFailureDetector
        describeLogDirs path)."""
        return {}


class InMemoryClusterAdmin(ClusterAdmin):
    """Applies reassignments against a ``MetadataClient``-held metadata
    snapshot, completing each after ``latency_polls`` calls to
    ``ongoing_reassignments`` — modelling Kafka's asynchronous data movement
    so executor wait/poll loops and concurrency gates are actually
    exercised."""

    def __init__(self, metadata_client: MetadataClient, latency_polls: int = 1):
        self._md = metadata_client
        self._latency = max(int(latency_polls), 0)
        self._lock = threading.Lock()
        self._inflight: Dict[Tp, Tuple[ReassignmentRequest, int]] = {}
        self._logdir_moves: List[Tuple[Tp, int, str]] = []
        self.throttle_state: Dict[str, object] = {}
        self.throttle_history: List[Dict[str, object]] = []
        # broker → {logdir → online}; tests flip entries to simulate disk death.
        self.logdir_health: Dict[int, Dict[str, bool]] = {}

    @property
    def metadata_client(self) -> MetadataClient:
        """The metadata backend this admin mutates (resume harnesses build
        a fresh Executor against the same admin + metadata pair)."""
        return self._md

    # -- reassignment ------------------------------------------------------
    def alter_partition_reassignments(self, requests: Sequence[ReassignmentRequest]) -> None:
        with self._lock:
            cluster = self._md.cluster()
            known = {p.tp for p in cluster.partitions}
            for r in requests:
                if tuple(r.tp) in self._inflight:
                    raise RuntimeError(f"reassignment already in progress for {r.tp}")
                if tuple(r.tp) not in known:
                    raise ValueError(f"unknown partition {r.tp}")
                self._inflight[tuple(r.tp)] = (r, self._latency)

    def ongoing_reassignments(self) -> Set[Tp]:
        with self._lock:
            done: List[Tp] = []
            for tp, (req, remaining) in list(self._inflight.items()):
                if remaining <= 0:
                    self._apply(req)
                    done.append(tp)
                else:
                    self._inflight[tp] = (req, remaining - 1)
            for tp in done:
                del self._inflight[tp]
            return set(self._inflight)

    def _apply(self, req: ReassignmentRequest) -> None:
        cluster = self._md.cluster()
        parts = []
        for p in cluster.partitions:
            if p.tp == tuple(req.tp):
                leader = p.leader if p.leader in req.new_replicas else req.new_replicas[0]
                parts.append(dataclasses.replace(
                    p, replicas=tuple(req.new_replicas), leader=leader,
                    offline_replicas=tuple(b for b in p.offline_replicas
                                           if b in req.new_replicas)))
            else:
                parts.append(p)
        self._md.refresh(dataclasses.replace(cluster, partitions=tuple(parts)))

    def cancel_reassignments(self, tps: Optional[Sequence[Tp]] = None) -> None:
        with self._lock:
            if tps is None:
                self._inflight.clear()
            else:
                for tp in tps:
                    self._inflight.pop(tuple(tp), None)

    # -- leadership --------------------------------------------------------
    def elect_leaders(self, tps: Sequence[Tp]) -> None:
        cluster = self._md.cluster()
        want = {tuple(tp) for tp in tps}
        parts = []
        for p in cluster.partitions:
            if p.tp in want and p.replicas:
                parts.append(dataclasses.replace(p, leader=p.replicas[0]))
            else:
                parts.append(p)
        self._md.refresh(dataclasses.replace(cluster, partitions=tuple(parts)))

    # -- logdirs -----------------------------------------------------------
    def alter_replica_logdirs(self, moves: Sequence[Tuple[Tp, int, str]]) -> None:
        with self._lock:
            self._logdir_moves.extend(moves)

    @property
    def logdir_moves(self) -> List[Tuple[Tp, int, str]]:
        with self._lock:
            return list(self._logdir_moves)

    # -- throttles ---------------------------------------------------------
    def set_replication_throttles(self, rate_bytes_per_sec, brokers,
                                  throttled_replicas) -> None:
        state = self.throttle_state or {"rate": None, "brokers": set(),
                                        "replicas": {}}
        state["rate"] = rate_bytes_per_sec
        state["brokers"] = set(state["brokers"]) | set(brokers)
        for topic, entries in throttled_replicas.items():
            cur = set(state["replicas"].get(topic, ()))
            state["replicas"][topic] = cur | set(entries)
        self.throttle_state = state
        self.throttle_history.append({"rate": rate_bytes_per_sec,
                                      "brokers": sorted(brokers),
                                      "replicas": {t: sorted(e) for t, e in
                                                   throttled_replicas.items()}})

    def describe_logdirs(self) -> Dict[int, Dict[str, bool]]:
        if self.logdir_health:
            return {b: dict(d) for b, d in self.logdir_health.items()}
        return {b.broker_id: {ld: True for ld in b.logdirs}
                for b in self._md.cluster().brokers}

    def clear_replication_throttles(self, brokers, throttled_replicas) -> None:
        state = self.throttle_state
        if not state:
            return
        for topic, entries in throttled_replicas.items():
            cur = set(state["replicas"].get(topic, ()))
            cur -= set(entries)
            if cur:
                state["replicas"][topic] = cur
            else:
                state["replicas"].pop(topic, None)
        if not state["replicas"]:
            state["brokers"] = set(state["brokers"]) - set(brokers)
            if not state["brokers"]:
                self.throttle_state = {}


class SimulatedClusterAdmin(InMemoryClusterAdmin):
    """Byte-accurate fleet simulation under a virtual clock.

    ``InMemoryClusterAdmin`` completes every reassignment after a fixed
    number of polls — fine for exercising wait loops, useless for measuring
    time-to-balanced.  This subclass models the data plane: each
    reassignment must drain ``replica size × new destinations`` bytes at the
    replication-throttle rate, and a broker's rate is SHARED across its
    concurrent inbound transfers (the bottleneck broker paces each
    transfer), so concurrency limits and the adjuster visibly change the
    wall-to-balanced outcome.  The virtual clock advances ``tick_ms`` per
    ``ongoing_reassignments()`` poll; executors built with
    ``clock_ms=admin.now_ms`` record ledger time in fleet seconds.  Scales
    to the ROADMAP's 7k-broker fleet: state is one dict entry per in-flight
    transfer, not per broker.
    """

    def __init__(self, metadata_client: MetadataClient,
                 bytes_by_tp: Optional[Dict[Tp, int]] = None,
                 tick_ms: int = 1000,
                 rate_bytes_per_sec: float = 50_000_000.0):
        super().__init__(metadata_client, latency_polls=0)
        self._bytes_by_tp: Dict[Tp, int] = dict(bytes_by_tp or {})
        self._tick_ms = max(1, int(tick_ms))
        self._rate = float(rate_bytes_per_sec)
        self._now_ms = 0
        # tp → [remaining_bytes, destination brokers receiving data]
        self._transfers: Dict[Tp, list] = {}

    def now_ms(self) -> int:
        return self._now_ms

    @property
    def rate_bytes_per_sec(self) -> float:
        return self._rate

    # -- reassignment ------------------------------------------------------
    def alter_partition_reassignments(self, requests: Sequence[ReassignmentRequest]) -> None:
        with self._lock:
            cluster = self._md.cluster()
            current = {p.tp: set(p.replicas) for p in cluster.partitions}
            for r in requests:
                tp = tuple(r.tp)
                if tp in self._inflight:
                    raise RuntimeError(f"reassignment already in progress for {r.tp}")
                if tp not in current:
                    raise ValueError(f"unknown partition {r.tp}")
                dests = frozenset(b for b in r.new_replicas
                                  if b not in current[tp])
                size = self._bytes_by_tp.get(tp, 0) * len(dests)
                self._inflight[tp] = (r, 0)
                self._transfers[tp] = [float(size), dests]

    def ongoing_reassignments(self) -> Set[Tp]:
        with self._lock:
            self._now_ms += self._tick_ms
            # Per-destination-broker inbound transfer counts: a broker
            # receiving N partitions splits its throttle rate N ways.
            inbound: Dict[int, int] = {}
            for _remaining, dests in self._transfers.values():
                for b in dests:
                    inbound[b] = inbound.get(b, 0) + 1
            tick_s = self._tick_ms / 1000.0
            done: List[Tp] = []
            for tp, entry in self._transfers.items():
                remaining, dests = entry
                if dests:
                    bottleneck = max(inbound[b] for b in dests)
                    remaining -= self._rate / bottleneck * tick_s
                    entry[0] = remaining
                if not dests or remaining <= 0:
                    done.append(tp)
            for tp in done:
                req, _ = self._inflight.pop(tp)
                del self._transfers[tp]
                self._apply(req)
            return set(self._inflight)

    def cancel_reassignments(self, tps: Optional[Sequence[Tp]] = None) -> None:
        with self._lock:
            if tps is None:
                self._inflight.clear()
                self._transfers.clear()
            else:
                for tp in tps:
                    self._inflight.pop(tuple(tp), None)
                    self._transfers.pop(tuple(tp), None)

    # -- throttles ---------------------------------------------------------
    def set_replication_throttles(self, rate_bytes_per_sec, brokers,
                                  throttled_replicas) -> None:
        super().set_replication_throttles(rate_bytes_per_sec, brokers,
                                          throttled_replicas)
        # Adopt the executor's throttle as the simulation's transfer rate so
        # per-replica transfer times derive from size + throttle.
        self._rate = float(rate_bytes_per_sec)
