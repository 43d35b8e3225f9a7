"""Execution ledger: per-task lifecycle event log + live progress accounting.

The reference answers "how is the rebalance going?" through
``ExecutorState``'s executor substate (in-progress/finished data movement,
per-phase task counts — ExecutorState.java:331-389).  The ledger is that
surface plus the measurement substrate the executor perf work is judged
against: every task transition lands here (via ``ExecutionTask.observer``),
and once per wait-loop poll the executor calls :meth:`poll` so the ledger
can checkpoint bytes-moved / in-flight / per-broker occupancy over time.

Time is whatever clock the executor runs on (``Executor(clock_ms=...)``) —
wall time against a real cluster, virtual time against
``SimulatedClusterAdmin`` — so time-to-balanced curves from a simulated
7k-broker fleet read in fleet seconds, not host microseconds.

Balancedness over time: when a :class:`PlacementScorer
<cruise_control_tpu_torch.analyzer.optimizer.PlacementScorer>` is attached, each
checkpoint snapshots the *landed-partition* mask (all of a partition's
tasks completed).  Scoring is deferred and batched: one compile-cached
dispatch over all unscored checkpoints at phase boundaries
(:meth:`score_checkpoints`), never per poll.

The ledger is purely observational — with it off the executor produces a
bit-identical ``ExecutionResult`` (pinned in tests/test_execution_ledger).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.common.timeseries import (REPLAN_ADDED_SERIES,
                                                  REPLAN_CANCELLED_SERIES,
                                                  REPLAN_KEPT_SERIES,
                                                  TASK_DURATION_SERIES,
                                                  TELEMETRY)
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskState, TaskType

#: Checkpoint ring target: when full, thin to every other checkpoint and
#: double the sampling stride — bounded memory at any execution length
#: while keeping the curve's shape.
MAX_CHECKPOINTS = 256

#: to_dict(verbose=True) caps the event log it returns (the full log stays
#: in memory for the lifetime of the ledger).
MAX_EVENTS_IN_DUMP = 2048


class ExecutionLedger:
    def __init__(self, clock_ms, throttle_rate_bytes_per_sec: Optional[int] = None,
                 scorer=None, max_checkpoints: int = MAX_CHECKPOINTS,
                 event_sink=None):
        self._clock_ms = clock_ms
        self._throttle_rate = throttle_rate_bytes_per_sec
        self._scorer = scorer
        self._max_checkpoints = max(8, max_checkpoints)
        self._stride = 1          # checkpoint every Nth eligible poll
        self._polls_since_checkpoint = 0
        # Optional pass-through of every task transition (the execution
        # journal's hook; None costs nothing).
        self._event_sink = event_sink

        self.events: List[dict] = []
        self.checkpoints: List[dict] = []
        self.phases: List[dict] = []
        self.replans: List[dict] = []
        self.adjuster_decisions: Dict[str, int] = {
            "halve": 0, "double": 0, "hold": 0}
        self.task_durations_ms: Dict[str, List[int]] = {
            t.value: [] for t in TaskType}

        self.total_tasks = 0
        self.total_bytes = 0
        self.bytes_moved = 0
        self.bytes_in_flight = 0
        self.counts: Dict[str, int] = {s.value: 0 for s in TaskState}
        self.started_ms: Optional[int] = None
        self.last_event_ms: Optional[int] = None
        self.finished_ms: Optional[int] = None
        self.inflight_by_broker: Dict[int, int] = {}
        self.polls = 0

        # Landed-partition tracking for the balancedness curve: a partition
        # "lands" when every task referencing it completed; dead/aborted
        # tasks pin theirs at the pre-execution placement forever.
        self._outstanding_by_partition: Dict[int, int] = {}
        self._landed: set = set()
        self._stuck: set = set()
        # Partitions whose task was cancelled before it started (replan /
        # force-stop): they never moved, so draining their outstanding count
        # must not land them at the "after" placement.
        self._cancelled: set = set()

    # -- wiring --------------------------------------------------------------
    def attach(self, plan) -> None:
        """Hook every task of the plan and seed the totals."""
        now = self._clock_ms()
        self.started_ms = now
        tasks = (plan.inter_broker_tasks + plan.intra_broker_tasks
                 + plan.leadership_tasks)
        self.total_tasks = len(tasks)
        self.total_bytes = plan.total_bytes
        for t in tasks:
            t.observer = self.observe
            self.counts[t.state.value] += 1
            p = t.proposal.partition
            self._outstanding_by_partition[p] = \
                self._outstanding_by_partition.get(p, 0) + 1

    def set_event_sink(self, sink) -> None:
        """Attach/detach the per-transition pass-through (journal hook)."""
        self._event_sink = sink

    def set_clock(self, clock_ms) -> None:
        """Swap the clock source (resume replaces the journal-replay clock
        with the executor's live clock once replay is done)."""
        self._clock_ms = clock_ms

    def set_scorer(self, scorer) -> None:
        """Swap the balancedness scorer.  Replan rebasing swaps in a scorer
        whose "before" is the partially-moved cluster and whose "after" is
        the re-solved target, so post-replan checkpoints score against the
        plan actually being executed."""
        self._scorer = scorer

    def replan_rebase(self, added_tasks, cancelled: int, kept: int,
                      scorer=None) -> None:
        """Rebase the ledger on a live replan: hook the added tasks, grow
        the totals, and re-dirty their partitions (a landed/stuck/cancelled
        partition that the new plan moves again is live work once more).
        Cancellations arrive separately through observe() as
        PENDING→ABORTED transitions."""
        now = self._clock_ms()
        self.replans.append({"tMs": now, "poll": self.polls,
                             "cancelled": cancelled, "kept": kept,
                             "added": len(added_tasks)})
        # Replan publish boundary: the churn triple the SLA rollup's
        # cancelled/kept/added ratio is computed from.
        TELEMETRY.record(REPLAN_CANCELLED_SERIES, cancelled, t_ms=now)
        TELEMETRY.record(REPLAN_KEPT_SERIES, kept, t_ms=now)
        TELEMETRY.record(REPLAN_ADDED_SERIES, len(added_tasks), t_ms=now)
        if scorer is not None:
            self._scorer = scorer
        for t in added_tasks:
            t.observer = self.observe
            self.counts[t.state.value] += 1
            self.total_tasks += 1
            self.total_bytes += t.bytes_to_move
            p = t.proposal.partition
            self._outstanding_by_partition[p] = max(
                0, self._outstanding_by_partition.get(p, 0)) + 1
            self._landed.discard(p)
            self._stuck.discard(p)
            self._cancelled.discard(p)

    # -- event intake --------------------------------------------------------
    def observe(self, task: ExecutionTask, old_state: TaskState,
                new_state: TaskState, now_ms: int) -> None:
        self.counts[old_state.value] -= 1
        self.counts[new_state.value] += 1
        self.last_event_ms = now_ms
        b = task.bytes_to_move
        if new_state == TaskState.IN_PROGRESS:
            self.bytes_in_flight += b
        elif new_state == TaskState.COMPLETED:
            self.bytes_in_flight -= b
            self.bytes_moved += b
            self.task_durations_ms[task.task_type.value].append(
                max(0, task.end_time_ms - task.start_time_ms))
            SENSORS.histogram(
                "Executor.task-duration-seconds",
                labels={"type": task.task_type.value},
                help="Completed execution task duration, by task type"
            ).observe(max(0, task.end_time_ms - task.start_time_ms) / 1000.0)
            TELEMETRY.record(TASK_DURATION_SERIES,
                             max(0, task.end_time_ms - task.start_time_ms),
                             t_ms=now_ms)
            self._land(task.proposal.partition)
        elif new_state in (TaskState.ABORTED, TaskState.DEAD):
            if old_state in (TaskState.IN_PROGRESS, TaskState.ABORTING):
                # ABORTING→ABORTED: in-flight bytes were added at IN_PROGRESS
                # and not yet released (ABORTING releases nothing).
                self.bytes_in_flight -= b
                self._stuck.add(task.proposal.partition)
            else:
                # PENDING→ABORTED cancellation: the task never carried
                # in-flight bytes and its work leaves the plan entirely —
                # shrink the plan total so offTargetBytes still converges.
                self.total_bytes -= b
                self._cancelled.add(task.proposal.partition)
                self._land(task.proposal.partition)
        self.events.append({
            "id": task.execution_id, "type": task.task_type.value,
            "partition": task.proposal.partition,
            "from": old_state.value, "to": new_state.value,
            "tMs": now_ms, "bytes": b})
        if self._event_sink is not None:
            self._event_sink(task, old_state, new_state, now_ms)

    def _land(self, partition: int) -> None:
        n = self._outstanding_by_partition.get(partition, 0) - 1
        self._outstanding_by_partition[partition] = n
        if n <= 0 and partition not in self._stuck \
                and partition not in self._cancelled:
            self._landed.add(partition)

    def adjuster_decision(self, decision: str) -> None:
        self.adjuster_decisions[decision] = \
            self.adjuster_decisions.get(decision, 0) + 1

    # -- phases --------------------------------------------------------------
    def phase_started(self, phase: str) -> None:
        self.phases.append({"phase": phase, "startMs": self._clock_ms(),
                            "endMs": None, "polls": 0, "batches": 0})

    def phase_finished(self, polls: int = 0, batches: int = 0) -> None:
        if self.phases and self.phases[-1]["endMs"] is None:
            self.phases[-1].update(endMs=self._clock_ms(), polls=polls,
                                   batches=batches)

    def finished(self) -> None:
        self.finished_ms = self._clock_ms()

    # -- per-poll checkpointing ----------------------------------------------
    def poll(self, task_manager=None, force: bool = False) -> None:
        """Called once per executor wait-loop iteration.  Snapshots the
        in-flight broker map; appends a curve checkpoint when progress was
        made since the last one (stride-sampled so long executions thin
        themselves instead of growing without bound).  ``force`` bypasses
        the stride so the terminal state always lands on the curve."""
        self.polls += 1
        if task_manager is not None:
            self.inflight_by_broker = task_manager.inflight_by_broker()
        last = self.checkpoints[-1] if self.checkpoints else None
        progressed = last is None or (
            last["completed"] != self.counts[TaskState.COMPLETED.value]
            or last["dead"] != self.counts[TaskState.DEAD.value]
            or last["aborted"] != self.counts[TaskState.ABORTED.value])
        if not progressed:
            return
        self._polls_since_checkpoint += 1
        if self._polls_since_checkpoint < self._stride and not force:
            return
        self._polls_since_checkpoint = 0
        self._checkpoint()

    def _checkpoint(self) -> None:
        cp = {
            "tMs": self._clock_ms(),
            "poll": self.polls,
            "completed": self.counts[TaskState.COMPLETED.value],
            "dead": self.counts[TaskState.DEAD.value],
            "aborted": self.counts[TaskState.ABORTED.value],
            "inProgress": self.counts[TaskState.IN_PROGRESS.value],
            "bytesMoved": self.bytes_moved,
            "bytesInFlight": self.bytes_in_flight,
            "offTargetBytes": self.total_bytes - self.bytes_moved,
            "landedPartitions": len(self._landed),
            "maxBrokerInFlight": max(self.inflight_by_broker.values(),
                                     default=0),
            "balancedness": None,
        }
        if self._scorer is not None:
            cp["_landed_set"] = frozenset(self._landed)
        self.checkpoints.append(cp)
        # Checkpoint publish boundary: the progress curve's host scalars
        # (the balancedness point lands later, in score_checkpoints — the
        # batched phase-boundary scoring keeps this path fetch-free).
        TELEMETRY.record("executor.bytes-moved", self.bytes_moved,
                         t_ms=cp["tMs"])
        TELEMETRY.record("executor.off-target-bytes", cp["offTargetBytes"],
                         t_ms=cp["tMs"])
        if len(self.checkpoints) > self._max_checkpoints:
            self.checkpoints = self.checkpoints[::2]
            self._stride *= 2

    def score_checkpoints(self) -> None:
        """Batch-score every unscored checkpoint's balancedness — ONE
        compile-cached device dispatch for the whole batch (called at phase
        boundaries and end-of-execution, never per poll)."""
        if self._scorer is None:
            return
        pending = [cp for cp in self.checkpoints
                   if cp["balancedness"] is None and "_landed_set" in cp]
        if not pending:
            return
        scores = self._scorer.score_landed([cp["_landed_set"]
                                            for cp in pending])
        for cp, s in zip(pending, scores):
            cp["balancedness"] = float(s)
            del cp["_landed_set"]
            # Scored at the phase boundary, stamped with the checkpoint's
            # own (possibly virtual) time — the SLA balancedness series'
            # executor-side source.
            TELEMETRY.record("executor.balancedness", float(s),
                             t_ms=cp["tMs"])

    # -- derived metrics -----------------------------------------------------
    @property
    def elapsed_ms(self) -> int:
        if self.started_ms is None:
            return 0
        end = self.finished_ms if self.finished_ms is not None \
            else self.last_event_ms
        return max(0, (end or self.started_ms) - self.started_ms)

    @property
    def movement_rate_bytes_per_sec(self) -> float:
        """Observed rate from bytes completed over elapsed time (0 until the
        first completion)."""
        ms = self.elapsed_ms
        return self.bytes_moved / (ms / 1000.0) if ms > 0 else 0.0

    @property
    def eta_seconds(self) -> float:
        """Remaining bytes at the observed rate; -1 while rate is unknown."""
        rate = self.movement_rate_bytes_per_sec
        if rate <= 0:
            return -1.0
        return (self.total_bytes - self.bytes_moved) / rate

    @property
    def throttle_utilization(self) -> float:
        """Observed movement rate over the throttle-implied ceiling: the
        throttle caps each busy broker at the configured rate, so ceiling =
        rate × brokers-with-in-flight-work.  -1 when unthrottled/idle."""
        if not self._throttle_rate:
            return -1.0
        busy = len(self.inflight_by_broker)
        if busy == 0:
            return -1.0
        return self.movement_rate_bytes_per_sec / \
            (self._throttle_rate * busy)

    @property
    def max_broker_in_flight(self) -> int:
        return max(self.inflight_by_broker.values(), default=0)

    @property
    def balancedness(self) -> float:
        """Latest scored checkpoint's balancedness (-1 until one exists)."""
        for cp in reversed(self.checkpoints):
            if cp["balancedness"] is not None:
                return float(cp["balancedness"])
        return -1.0

    # -- dump ----------------------------------------------------------------
    def _duration_summary(self) -> Dict[str, dict]:
        out = {}
        for t, ds in self.task_durations_ms.items():
            if not ds:
                continue
            out[t] = {"count": len(ds),
                      "meanMs": sum(ds) / len(ds),
                      "maxMs": max(ds),
                      "minMs": min(ds)}
        return out

    def to_dict(self, verbose: bool = False) -> Dict[str, object]:
        out: Dict[str, object] = {
            "totalTasks": self.total_tasks,
            "taskCounts": dict(self.counts),
            "totalBytes": self.total_bytes,
            "bytesMoved": self.bytes_moved,
            "bytesInFlight": self.bytes_in_flight,
            "movementRateBytesPerSec": self.movement_rate_bytes_per_sec,
            "etaSeconds": self.eta_seconds,
            "throttleRateBytesPerSec": self._throttle_rate,
            "throttleUtilization": self.throttle_utilization,
            "adjusterDecisions": dict(self.adjuster_decisions),
            "startedMs": self.started_ms,
            "finishedMs": self.finished_ms,
            "elapsedMs": self.elapsed_ms,
            "polls": self.polls,
            "landedPartitions": len(self._landed),
            "balancedness": self.balancedness,
            "phases": [dict(p) for p in self.phases],
            "replans": [dict(r) for r in self.replans],
            "taskDurations": self._duration_summary(),
        }
        if verbose:
            out["perBrokerInFlight"] = {
                str(b): n for b, n in sorted(self.inflight_by_broker.items())}
            out["checkpoints"] = [
                {k: v for k, v in cp.items() if not k.startswith("_")}
                for cp in self.checkpoints]
            out["events"] = self.events[-MAX_EVENTS_IN_DUMP:]
        return out
