"""Simulated-fleet execution harness.

Bridges the tensor world to the executor's cluster protocol so a REAL
proposal plan (e.g. a mid-rung optimization's diff) can be executed against
``SimulatedClusterAdmin``'s byte-accurate virtual fleet — the measurement
rig behind the JAX package's ``bench.py --execute``, and of the port's
execution phase in ``chip_smoke.py``.  Everything here is host-side glue:
one device fetch pulls the placement arrays, after which metadata synthesis
is pure Python.

The seam invariants (matching ``api.facade``): brokers in the synthesized
metadata are the model's dense indices 0..B-1 (so proposals from
``proposals.diff`` need no renumbering), and ``partition_names[dense_pid]``
maps the proposal's dense partition id to its ``(topic, partition)``.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from cruise_control_tpu_torch.analyzer.proposals import (ExecutionProposal,
                                                   ReplicaPlacement)
from cruise_control_tpu_torch.executor.admin import (ReassignmentRequest,
                                               SimulatedClusterAdmin,
                                               TransientAdminError, Tp)
from cruise_control_tpu_torch.executor.executor import Executor
from cruise_control_tpu_torch.executor.task_manager import ConcurrencyLimits
from cruise_control_tpu_torch.monitor.metadata import (BrokerInfo, ClusterMetadata,
                                                 MetadataClient, PartitionInfo)


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Host copies of ``tensors`` in one device-to-host transfer: the
    tensors are viewed as bytes, concatenated on their device, fetched
    once and cut apart again."""
    if not tensors:
        return []
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(host[at:at + n].view(dtype).reshape(tuple(t.shape)))
        at += n
    return out


def metadata_from_model(model) -> Tuple[MetadataClient, List[Tp]]:
    """Synthesize cluster metadata from a tensor model's placement.

    Topics are named ``t<tid>``; partition numbers count up per topic in
    dense-partition-id order; replica lists are leader-first (the executor's
    completion check compares replica SETS, but leader-first keeps the
    synthesized metadata shaped like the reference's).
    Returns (metadata client, dense partition id → (topic, partition)).
    """
    (pr, rb, lead, ptopic, pvalid, bvalid, brack) = _fetch(
        model.partition_replicas, model.replica_broker,
        model.replica_is_leader, model.partition_topic,
        model.partition_valid, model.broker_valid, model.broker_rack)
    brokers = tuple(BrokerInfo(int(b), rack=f"rack{int(brack[b])}",
                               host=f"host{int(b)}")
                    for b in range(model.num_brokers) if bvalid[b])
    parts: List[PartitionInfo] = []
    partition_names: List[Tp] = []
    next_index: Dict[int, int] = {}
    for p in range(pr.shape[0]):
        tid = int(ptopic[p])
        topic = f"t{tid}"
        idx = next_index.get(tid, 0)
        next_index[tid] = idx + 1
        partition_names.append((topic, idx))
        if not pvalid[p]:
            continue
        slots = pr[p][pr[p] >= 0]
        if slots.size == 0:
            continue
        placements = [int(rb[r]) for r in slots]
        leader_pos = next((i for i, r in enumerate(slots) if lead[r]), 0)
        if leader_pos:
            placements = [placements[leader_pos]] + \
                placements[:leader_pos] + placements[leader_pos + 1:]
        parts.append(PartitionInfo(topic, idx, leader=placements[0],
                                   replicas=tuple(placements)))
    mc = MetadataClient(ClusterMetadata(brokers=brokers,
                                        partitions=tuple(parts)))
    return mc, partition_names


def proposal_bytes_by_tp(proposals: Sequence[ExecutionProposal],
                         partition_names: Sequence[Tp]) -> Dict[Tp, int]:
    """Per-partition transfer size for the simulated admin (bytes; the
    proposal's partition_size is MB)."""
    return {tuple(partition_names[p.partition]): int(p.partition_size * 1e6)
            for p in proposals}


def sample_move_proposals(model, moves: int = 2,
                          leadership: int = 1) -> List[ExecutionProposal]:
    """Small synthetic proposal set for exercising the executor without an
    optimizer run: ``moves`` replica relocations (last replica of the first
    eligible partitions moved to the lowest absent broker) plus
    ``leadership`` leader flips (replica order reversed) on the following
    partitions.  Placements reflect the model's current state, so they
    execute cleanly against ``metadata_from_model``'s metadata."""
    (pr, rb, rd, lead, ptopic, pvalid, bvalid) = _fetch(
        model.partition_replicas, model.replica_broker, model.replica_disk,
        model.replica_is_leader, model.partition_topic,
        model.partition_valid, model.broker_valid)
    alive = [b for b in range(model.num_brokers) if bvalid[b]]
    out: List[ExecutionProposal] = []
    want_moves, want_leads = moves, leadership
    for p in range(pr.shape[0]):
        if want_moves <= 0 and want_leads <= 0:
            break
        if not pvalid[p]:
            continue
        slots = pr[p][pr[p] >= 0]
        if slots.size == 0:
            continue
        placements = [ReplicaPlacement(int(rb[r]), int(rd[r])) for r in slots]
        leader_pos = next((i for i, r in enumerate(slots) if lead[r]), 0)
        if leader_pos:
            placements = [placements[leader_pos]] + \
                placements[:leader_pos] + placements[leader_pos + 1:]
        old = tuple(placements)
        size = 100.0
        if want_moves > 0:
            used = {pl.broker for pl in old}
            dest = next((b for b in alive if b not in used), None)
            if dest is None:
                continue
            new = old[:-1] + (ReplicaPlacement(dest, old[-1].disk),)
            want_moves -= 1
        elif len(old) > 1:
            new = tuple(reversed(old))
            want_leads -= 1
        else:
            continue
        out.append(ExecutionProposal(
            partition=p, topic=int(ptopic[p]), partition_size=size,
            old_leader=old[0], old_replicas=old, new_replicas=new))
    return out


def synthetic_health_metrics(stressed_polls=range(6, 12)):
    """Deterministic broker-health feed for the concurrency adjuster: deep
    request queues during ``stressed_polls`` (forcing halving), healthy
    otherwise (doubling back toward the cap) — so simulated executions
    exercise both adjuster directions reproducibly."""
    calls = {"n": 0}

    def fn() -> Dict[int, Dict[str, float]]:
        n = calls["n"]
        calls["n"] += 1
        stressed = n in stressed_polls
        return {0: {
            "BROKER_REQUEST_QUEUE_SIZE": 5000.0 if stressed else 10.0,
            "BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT": 0.9,
        }}
    return fn


@dataclasses.dataclass
class FaultInjection:
    """Knobs for :class:`ChaosClusterAdmin`.  All randomness is seeded, so
    a given (faults, plan) pair replays identically — the chaos tests and
    the bench's kill/resume legs are deterministic.

    - ``transient_failure_rate``: probability that any admin mutation
      (reassign / elect / logdir move) raises :class:`TransientAdminError`.
    - ``failing_broker``: submissions whose destinations include this broker
      ALWAYS raise (models a persistently unreachable broker — drives the
      retry envelope to give-up and the circuit breaker to open).
    - ``latency_spike_rate`` / ``latency_spike_factor``: per-poll chance an
      in-flight transfer's remaining bytes inflate by the factor (a stuck
      or rate-starved task, visible to stuck-partition detection).
    - ``broker_death_ms`` + ``dead_broker``: at the given virtual time the
      broker drops from the alive set, so in-flight moves targeting it hit
      the executor's dead-broker path.
    """

    transient_failure_rate: float = 0.0
    failing_broker: Optional[int] = None
    latency_spike_rate: float = 0.0
    latency_spike_factor: float = 4.0
    broker_death_ms: Optional[int] = None
    dead_broker: Optional[int] = None
    seed: int = 0


class ChaosClusterAdmin(SimulatedClusterAdmin):
    """``SimulatedClusterAdmin`` with seeded fault injection.  ``injected``
    counts what actually fired, so tests can assert the fault surface was
    exercised rather than silently dormant."""

    def __init__(self, metadata_client: MetadataClient,
                 bytes_by_tp: Optional[Dict[Tp, int]] = None,
                 tick_ms: int = 1000,
                 rate_bytes_per_sec: float = 50_000_000.0,
                 faults: Optional[FaultInjection] = None):
        super().__init__(metadata_client, bytes_by_tp, tick_ms=tick_ms,
                         rate_bytes_per_sec=rate_bytes_per_sec)
        self._faults = faults or FaultInjection()
        self._rng = random.Random(self._faults.seed)
        self._broker_killed = False
        self._spiked: set = set()
        self.injected = {"transient": 0, "failing_broker": 0,
                         "latency_spikes": 0, "broker_deaths": 0}

    def _maybe_transient(self) -> None:
        f = self._faults
        if f.transient_failure_rate > 0 and \
                self._rng.random() < f.transient_failure_rate:
            self.injected["transient"] += 1
            raise TransientAdminError("injected transient admin failure")

    # -- mutation surface (fault-injected) ----------------------------------
    def alter_partition_reassignments(self, requests: Sequence[ReassignmentRequest]) -> None:
        f = self._faults
        if f.failing_broker is not None and any(
                f.failing_broker in r.new_replicas for r in requests):
            self.injected["failing_broker"] += 1
            raise TransientAdminError(
                f"injected failure: broker {f.failing_broker} unreachable")
        self._maybe_transient()
        super().alter_partition_reassignments(requests)

    def elect_leaders(self, tps: Sequence[Tp]) -> None:
        self._maybe_transient()
        super().elect_leaders(tps)

    def alter_replica_logdirs(self, moves: Sequence[Tuple[Tp, int, str]]) -> None:
        self._maybe_transient()
        super().alter_replica_logdirs(moves)

    # -- data plane (spikes + broker death ride the poll tick) ---------------
    def ongoing_reassignments(self) -> Set[Tp]:
        f = self._faults
        if f.latency_spike_rate > 0:
            with self._lock:
                for tp, entry in self._transfers.items():
                    # At most one spike per transfer: a spike models the
                    # task getting stuck ONCE, not compounding divergence.
                    if entry[0] > 0 and entry[1] and tp not in self._spiked \
                            and self._rng.random() < f.latency_spike_rate:
                        entry[0] *= f.latency_spike_factor
                        self._spiked.add(tp)
                        self.injected["latency_spikes"] += 1
        out = super().ongoing_reassignments()
        if f.broker_death_ms is not None and f.dead_broker is not None \
                and not self._broker_killed and self._now_ms >= f.broker_death_ms:
            self._kill_broker(f.dead_broker)
        return out

    def _kill_broker(self, broker: int) -> None:
        cluster = self._md.cluster()
        self._md.refresh(dataclasses.replace(cluster, brokers=tuple(
            dataclasses.replace(b, is_alive=False)
            if b.broker_id == broker else b for b in cluster.brokers)))
        self._broker_killed = True
        self.injected["broker_deaths"] += 1


def build_simulated_execution(model_before,
                              proposals: Sequence[ExecutionProposal],
                              *,
                              model_after=None,
                              goal_names: Optional[Sequence[str]] = None,
                              constraint=None,
                              balancedness_weights: Tuple[float, float] = (1.1, 1.5),
                              tick_ms: int = 1000,
                              rate_bytes_per_sec: float = 50_000_000.0,
                              limits: Optional[ConcurrencyLimits] = None,
                              ledger_enabled: bool = True,
                              faults: Optional[FaultInjection] = None):
    """Build the (executor, admin, partition_names, scorer) rig for a
    simulated execution without running it — crash/resume flows need the
    executor and admin to SURVIVE the (simulated) process death, so the
    harness hands them out before the run starts."""
    mc, partition_names = metadata_from_model(model_before)
    admin_cls = ChaosClusterAdmin if faults is not None else SimulatedClusterAdmin
    kwargs = dict(tick_ms=tick_ms, rate_bytes_per_sec=rate_bytes_per_sec)
    if faults is not None:
        kwargs["faults"] = faults
    admin = admin_cls(mc, proposal_bytes_by_tp(proposals, partition_names),
                      **kwargs)
    scorer = None
    if model_after is not None and goal_names:
        from cruise_control_tpu_torch.analyzer.optimizer import PlacementScorer
        scorer = PlacementScorer(model_before, model_after, goal_names,
                                 constraint, *balancedness_weights)
    ex = Executor(admin, mc, limits=limits,
                  clock_ms=admin.now_ms,
                  ledger_enabled=ledger_enabled,
                  concurrency_adjuster_interval_ms=0,
                  admin_retry_backoff_s=0.0)
    return ex, admin, partition_names, scorer


def run_simulated_execution(model_before, proposals: Sequence[ExecutionProposal],
                            *,
                            model_after=None,
                            goal_names: Optional[Sequence[str]] = None,
                            constraint=None,
                            balancedness_weights: Tuple[float, float] = (1.1, 1.5),
                            tick_ms: int = 1000,
                            rate_bytes_per_sec: float = 50_000_000.0,
                            limits: Optional[ConcurrencyLimits] = None,
                            adjuster_churn: bool = True,
                            ledger_enabled: bool = True,
                            max_polls: int = 200_000,
                            faults: Optional[FaultInjection] = None,
                            journal_path: Optional[str] = None,
                            replanner=None,
                            replan_interval_polls: int = 0,
                            crash_after_polls: Optional[int] = None):
    """Execute ``proposals`` against a simulated fleet derived from
    ``model_before``.  With ``model_after`` + ``goal_names``, a
    ``PlacementScorer`` rides along so the ledger records the
    balancedness-over-time curve.  Returns ``(result, executor, admin)`` —
    the ledger is ``executor.progress(verbose=True)``; wall-to-balanced is
    fleet time (``admin.now_ms()``), not host time.

    ``faults`` swaps in :class:`ChaosClusterAdmin`; ``journal_path`` /
    ``replanner`` / ``replan_interval_polls`` / ``crash_after_polls`` pass
    through to :meth:`Executor.execute_proposals` (a ``crash_after_polls``
    run raises :class:`SimulatedCrash` — use
    :func:`build_simulated_execution` when you need the executor afterwards
    to ``resume()``)."""
    ex, admin, partition_names, scorer = build_simulated_execution(
        model_before, proposals, model_after=model_after,
        goal_names=goal_names, constraint=constraint,
        balancedness_weights=balancedness_weights, tick_ms=tick_ms,
        rate_bytes_per_sec=rate_bytes_per_sec, limits=limits,
        ledger_enabled=ledger_enabled, faults=faults)
    result = ex.execute_proposals(
        proposals, partition_names, max_polls=max_polls, poll_interval_s=0.0,
        replication_throttle=int(rate_bytes_per_sec),
        concurrency_adjust_metrics=(synthetic_health_metrics()
                                    if adjuster_churn else None),
        balancedness_scorer=scorer,
        replanner=replanner, replan_interval_polls=replan_interval_polls,
        journal_path=journal_path, crash_after_polls=crash_after_polls)
    return result, ex, admin
