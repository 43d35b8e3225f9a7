"""The Executor: applies proposals to the cluster with admission control.

Parity with ``Executor`` (executor/Executor.java:76): owns the execution
lifecycle — phases inter-broker → intra-broker → leadership
(ProposalExecutionRunnable, Executor.java:1079-1148), per-batch reassignment
submission + wait loop (interBrokerMoveReplicas :1255-1318,
waitForExecutionTaskToFinish :1431), replication throttling around batches
(ReplicationThrottleHelper), dead-broker task handling (:1548), graceful
stop and force-stop (:91-96, znode deletion → ``cancel_reassignments``),
recently-removed/demoted broker history (:113-117), the
generating-proposals reservation handshake (:828), metric-sampling pause
during execution (adjustSamplingModeBeforeExecution :1051-1067), and the
concurrency auto-adjuster (:335-447).

The executor is deliberately synchronous and poll-driven ("keep it boring"),
driving any ``ClusterAdmin`` backend; the REST layer runs it on a worker
thread.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.analyzer.proposals import ExecutionProposal
from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.common.tracing import TRACE
from cruise_control_tpu_torch.executor.admin import (ClusterAdmin,
                                               ReassignmentRequest,
                                               TransientAdminError, Tp)
from cruise_control_tpu_torch.executor.journal import (ExecutionJournal,
                                                 JournalError, ResumeState,
                                                 rebuild as rebuild_journal)
from cruise_control_tpu_torch.executor.ledger import ExecutionLedger
from cruise_control_tpu_torch.executor.planner import ExecutionPlan, ExecutionTaskPlanner
from cruise_control_tpu_torch.executor.strategy import ReplicaMovementStrategy, StrategyContext
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskState, TaskType
from cruise_control_tpu_torch.executor.task_manager import (ConcurrencyLimits,
                                                      ExecutionTaskManager)
from cruise_control_tpu_torch.executor.throttle import ReplicationThrottleHelper


class ExecutorState(enum.Enum):
    """executor/ExecutorState.java state machine."""

    NO_TASK_IN_PROGRESS = "no_task_in_progress"
    STARTING_EXECUTION = "starting_execution"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = "inter_broker_replica_movement"
    INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = "intra_broker_replica_movement"
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "leader_movement"
    STOPPING_EXECUTION = "stopping_execution"
    GENERATING_PROPOSALS_FOR_EXECUTION = "generating_proposals_for_execution"


class OngoingExecutionError(RuntimeError):
    pass


class SimulatedCrash(RuntimeError):
    """Raised by the ``crash_after_polls`` fault hook: models a process
    death mid-execution.  The journal (if enabled) is left exactly as a
    real kill would leave it; ``Executor.resume()`` picks it up."""


def replan_enabled() -> bool:
    """CRUISE_REPLAN=0 kill-switch for replan-while-executing."""
    return os.environ.get("CRUISE_REPLAN", "1").lower() not in (
        "0", "false", "no", "off")


@dataclasses.dataclass
class ReplanDirective:
    """What a replanner callback hands back to the executor at a phase
    boundary: the re-solved proposal set for the partially-moved cluster
    (the executor patches the live queue against it: cancel-what-changed,
    keep-what-still-helps) plus an optional replacement ``PlacementScorer``
    whose before/after match the new plan."""

    proposals: List[ExecutionProposal]
    scorer: object = None
    info: Optional[Dict[str, object]] = None


#: Replanner signature: (landed_partitions, in_flight_partitions) →
#: ReplanDirective, or None to keep the current (static) plan.
Replanner = Callable[[frozenset, frozenset], Optional[ReplanDirective]]


@dataclasses.dataclass
class ExecutionResult:
    completed: int
    dead: int
    aborted: int
    polls: int
    stopped: bool

    @property
    def ok(self) -> bool:
        return not self.stopped and self.dead == 0 and self.aborted == 0


class ConcurrencyAdjuster:
    """Auto-scales movement concurrency from live broker metrics
    (Executor.java:335-447 + ExecutionUtils thresholds): halves concurrency
    when any broker looks stressed (deep request queue / low idle ratio or
    (At/Under)MinISR partitions), doubles it (up to the configured cap) when
    all brokers look healthy."""

    REQUEST_QUEUE_SIZE_CAP = 1000.0
    MIN_IDLE_RATIO = 0.3

    def __init__(self, base: ConcurrencyLimits,
                 min_per_broker: int = 1,
                 max_per_broker: Optional[int] = None,
                 interval_ms: int = 0):
        # concurrency.adjuster.{min,max}.partition.movements.per.broker +
        # .interval.ms (ExecutorConfig): the floor/ceiling of auto-scaling
        # and how often it re-evaluates (0 = every poll).
        self._base = base
        self._min = max(1, min_per_broker)
        self._max = max_per_broker or base.inter_broker_per_broker
        self._interval_ms = interval_ms
        self._last_adjust_ms = 0.0

    def adjust(self, limits: ConcurrencyLimits,
               broker_metrics: Dict[int, Dict[str, float]],
               has_min_isr_pressure: bool = False) -> ConcurrencyLimits:
        now_ms = time.monotonic() * 1000
        if self._interval_ms and now_ms - self._last_adjust_ms < self._interval_ms:
            return limits
        self._last_adjust_ms = now_ms
        stressed = has_min_isr_pressure
        for m in broker_metrics.values():
            if m.get("BROKER_REQUEST_QUEUE_SIZE", 0.0) > self.REQUEST_QUEUE_SIZE_CAP:
                stressed = True
            if m.get("BROKER_REQUEST_HANDLER_POOL_IDLE_PERCENT", 1.0) < self.MIN_IDLE_RATIO:
                stressed = True
        cur = limits.inter_broker_per_broker
        if stressed:
            new = max(self._min, cur // 2)
        else:
            new = min(self._max, self._base.inter_broker_per_broker, cur * 2)
        return dataclasses.replace(limits, inter_broker_per_broker=new)


class Executor:
    def __init__(self, admin: ClusterAdmin,
                 metadata_client,
                 limits: Optional[ConcurrencyLimits] = None,
                 strategy: Optional[ReplicaMovementStrategy] = None,
                 throttle_rate_bytes_per_sec: Optional[int] = None,
                 removed_broker_retention_ms: int = 12 * 3600 * 1000,
                 demoted_broker_retention_ms: Optional[int] = None,
                 on_sampling_pause: Optional[Callable[[str], None]] = None,
                 on_sampling_resume: Optional[Callable[[], None]] = None,
                 logdir_by_disk: Optional[Dict[int, str]] = None,
                 min_isr_pressure_fn: Optional[Callable[[], bool]] = None,
                 progress_check_interval_ms: int = 0,
                 leader_movement_timeout_ms: int = 180_000,
                 concurrency_adjuster_enabled: bool = True,
                 concurrency_adjuster_interval_ms: int = 0,
                 concurrency_adjuster_min_per_broker: int = 1,
                 concurrency_adjuster_max_per_broker: Optional[int] = None,
                 ledger_enabled: bool = True,
                 clock_ms: Optional[Callable[[], int]] = None,
                 admin_max_retries: int = 3,
                 admin_retry_backoff_s: float = 0.05,
                 breaker_failure_threshold: int = 3,
                 breaker_cooldown_ms: int = 60_000):
        self._admin = admin
        self._metadata = metadata_client
        self._limits = limits or ConcurrencyLimits()
        self._strategy = strategy
        self._throttle = ReplicationThrottleHelper(admin, throttle_rate_bytes_per_sec)
        self._lock = threading.RLock()
        self._state = ExecutorState.NO_TASK_IN_PROGRESS  # guarded-by: _lock
        self._stop_requested = False  # guarded-by: _lock
        self._force_stop = False  # guarded-by: _lock
        self._reserved_for_proposals = False  # guarded-by: _lock
        self._retention_ms = removed_broker_retention_ms
        # demoted.broker.retention.time.ms may differ from removed
        # (ExecutorConfig: two distinct retention knobs).
        self._demoted_retention_ms = (demoted_broker_retention_ms
                                      if demoted_broker_retention_ms is not None
                                      else removed_broker_retention_ms)
        self._recently_removed: Dict[int, int] = {}  # broker → time_ms  # guarded-by: _lock
        self._recently_demoted: Dict[int, int] = {}  # guarded-by: _lock
        self._on_pause = on_sampling_pause
        self._on_resume = on_sampling_resume
        self._logdir_by_disk = logdir_by_disk or {}
        self._min_isr_pressure_fn = min_isr_pressure_fn or (lambda: False)
        # execution.progress.check.interval.ms / leader.movement.timeout.ms:
        # the wait-loop cadence and the leadership phase's wall-clock bound.
        self._progress_check_interval_s = progress_check_interval_ms / 1000.0
        self._leader_movement_timeout_ms = leader_movement_timeout_ms
        self._adjuster_enabled = concurrency_adjuster_enabled
        self._adjuster_args = (concurrency_adjuster_min_per_broker,
                               concurrency_adjuster_max_per_broker,
                               concurrency_adjuster_interval_ms)
        self._task_manager: Optional[ExecutionTaskManager] = None  # guarded-by: _lock
        self._adjuster = ConcurrencyAdjuster(self._limits, *self._adjuster_args)
        # Execution ledger (per-task lifecycle log + progress accounting).
        # The clock is pluggable so simulated executions record fleet time;
        # the ledger of the latest execution persists for post-run queries.
        self._ledger_enabled = ledger_enabled
        self._clock_ms = clock_ms or (lambda: int(time.time() * 1000))
        self._ledger: Optional[ExecutionLedger] = None  # guarded-by: _lock
        # Fault-tolerant dispatch: retry/backoff envelope around admin
        # calls + per-broker circuit breaker (broker → [consecutive
        # failures, open-until clock]).
        self._admin_max_retries = max(0, admin_max_retries)
        self._admin_retry_backoff_s = max(0.0, admin_retry_backoff_s)
        self._breaker_threshold = max(1, breaker_failure_threshold)
        self._breaker_cooldown_ms = max(0, breaker_cooldown_ms)
        self._breaker: Dict[int, List[float]] = {}  # guarded-by: _lock
        # Sensor registrations (Executor.registerGaugeSensors,
        # Executor.java:271; Sensors.md execution gauges).
        from cruise_control_tpu_torch.executor.task import TaskType as _TT

        def _in_progress(task_type):
            def read() -> int:
                with self._lock:
                    tm = self._task_manager
                if tm is None:
                    return 0
                return sum(1 for t in tm.tasks_by_state()[TaskState.IN_PROGRESS]
                           if t.task_type == task_type)
            return read

        SENSORS.gauge("Executor.inter-broker-partition-movements-in-progress",
                      _in_progress(_TT.INTER_BROKER_REPLICA_ACTION),
                      help="Inter-broker replica movements currently in flight")
        SENSORS.gauge("Executor.intra-broker-partition-movements-in-progress",
                      _in_progress(_TT.INTRA_BROKER_REPLICA_ACTION),
                      help="Intra-broker (logdir) movements currently in flight")
        SENSORS.gauge("Executor.leadership-movements-in-progress",
                      _in_progress(_TT.LEADER_ACTION),
                      help="Leadership transfers currently in flight")
        SENSORS.gauge("Executor.execution-in-progress",
                      lambda: float(self.has_ongoing_execution),
                      help="1 while a proposal execution is running")
        self._sensor_started = SENSORS.counter(
            "Executor.executions-started",
            help="Proposal executions started since boot")
        self._sensor_stopped = SENSORS.counter(
            "Executor.executions-stopped",
            help="Proposal executions stopped by user request")
        self._sensor_completed = SENSORS.counter(
            "Executor.tasks-completed",
            help="Execution tasks finished in COMPLETED state")
        self._sensor_dead = SENSORS.counter(
            "Executor.tasks-dead",
            help="Execution tasks abandoned in DEAD state")

        # Ledger-driven progress gauges.  All read the latest execution's
        # ledger (live or finished); sentinel values cover the no-ledger
        # case so the families register deterministically at boot.
        def _ledger_read(fn, default=0.0):
            def read() -> float:
                led = self._ledger
                return default if led is None else float(fn(led))
            return read

        SENSORS.gauge("Executor.bytes-moved",
                      _ledger_read(lambda led: led.bytes_moved),
                      help="Bytes moved so far by the latest execution")
        SENSORS.gauge("Executor.bytes-total",
                      _ledger_read(lambda led: led.total_bytes),
                      help="Total bytes the latest execution plan moves")
        SENSORS.gauge("Executor.bytes-in-flight",
                      _ledger_read(lambda led: led.bytes_in_flight),
                      help="Bytes of movement currently in flight")
        SENSORS.gauge("Executor.movement-rate-bytes-per-sec",
                      _ledger_read(
                          lambda led: led.movement_rate_bytes_per_sec),
                      help="Observed data movement rate of the latest "
                           "execution")
        SENSORS.gauge("Executor.eta-seconds",
                      _ledger_read(lambda led: led.eta_seconds, -1.0),
                      help="Remaining bytes over the observed movement rate "
                           "(-1 while unknown)")
        SENSORS.gauge("Executor.throttle-utilization",
                      _ledger_read(lambda led: led.throttle_utilization, -1.0),
                      help="Observed movement rate over the replication-"
                           "throttle ceiling (-1 when unthrottled or idle)")
        SENSORS.gauge("Executor.max-broker-in-flight",
                      _ledger_read(lambda led: led.max_broker_in_flight),
                      help="Largest per-broker in-flight movement count")
        SENSORS.gauge("Executor.balancedness-score",
                      _ledger_read(lambda led: led.balancedness, -1.0),
                      help="Balancedness at the latest scored execution "
                           "checkpoint (-1 until one is scored)")
        self._sensor_adjuster = {
            d: SENSORS.counter(
                "Executor.adjuster-decisions", labels={"decision": d},
                help="Concurrency-adjuster decisions by outcome")
            for d in ("halve", "double", "hold")}
        for tt in _TT:
            SENSORS.histogram(
                "Executor.task-duration-seconds", labels={"type": tt.value},
                help="Completed execution task duration, by task type")

        # Interruptible-execution families: live replanning, crash resume,
        # and the admin retry/backoff + circuit-breaker envelope.
        self._sensor_replan = {
            "rounds": SENSORS.counter(
                "Executor.replan-rounds",
                help="Replan-while-executing rounds that produced a patch"),
            "cancelled": SENSORS.counter(
                "Executor.replan-tasks-cancelled",
                help="Pending tasks cancelled because the re-solve changed "
                     "their target"),
            "kept": SENSORS.counter(
                "Executor.replan-tasks-kept",
                help="Pending tasks kept verbatim across a replan round"),
            "added": SENSORS.counter(
                "Executor.replan-tasks-added",
                help="Tasks added by replan rounds for newly-needed moves"),
            "fallbacks": SENSORS.counter(
                "Executor.replan-fallbacks",
                help="Replan rounds that kept the static plan (replanner "
                     "declined, failed verification, or raised)"),
        }
        self._sensor_resume_started = SENSORS.counter(
            "Executor.resume-started",
            help="Journal resumes attempted")
        self._sensor_resume_completed = SENSORS.counter(
            "Executor.resume-completed",
            help="Journal resumes that reconstructed state and re-entered "
                 "the phase loop")
        self._sensor_resume_adopted = SENSORS.counter(
            "Executor.resume-tasks-adopted",
            help="In-flight tasks adopted from the journal on resume")
        self._sensor_resume_errors = SENSORS.counter(
            "Executor.resume-journal-errors",
            help="Resumes that hit a corrupt journal and fell back to a "
                 "clean abort")
        self._sensor_retries = SENSORS.counter(
            "Executor.admin-retries",
            help="Transient admin failures retried with exponential backoff")
        self._sensor_retry_giveups = SENSORS.counter(
            "Executor.admin-retry-giveups",
            help="Admin calls abandoned after exhausting the retry budget "
                 "(their tasks abort and await replan)")
        self._sensor_breaker_opens = SENSORS.counter(
            "Executor.admin-breaker-opens",
            help="Per-broker circuit-breaker trips after consecutive admin "
                 "failures")
        SENSORS.gauge(
            "Executor.admin-breaker-open-brokers",
            lambda: float(sum(
                1 for st in self._breaker.values()
                if st[1] > self._clock_ms())),
            help="Brokers whose admin circuit is currently open")

    # -- state -------------------------------------------------------------
    def state(self) -> ExecutorState:
        with self._lock:
            return self._state

    @property
    def limits(self) -> ConcurrencyLimits:
        with self._lock:
            return self._limits

    def set_concurrency(self, limits: ConcurrencyLimits) -> None:
        """Dynamically change movement concurrency (ADMIN endpoint;
        KafkaCruiseControl.setConcurrency analogue).  Updates the configured
        limits, the adjuster's base (so auto-adjustment re-expands to the new
        cap, not the stale one), and any live execution's task manager."""
        with self._lock:
            self._limits = limits
            self._adjuster = ConcurrencyAdjuster(limits, *self._adjuster_args)
            if self._task_manager is not None:
                self._task_manager.set_limits(limits)

    @property
    def has_ongoing_execution(self) -> bool:
        return self.state() not in (ExecutorState.NO_TASK_IN_PROGRESS,
                                    ExecutorState.GENERATING_PROPOSALS_FOR_EXECUTION)

    def state_summary(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {"state": self._state.value}
            if self._task_manager is not None:
                out["tasks"] = self._task_manager.counts()
            out["recentlyRemovedBrokers"] = sorted(self.recently_removed_brokers())
            out["recentlyDemotedBrokers"] = sorted(self.recently_demoted_brokers())
            return out

    def progress(self, verbose: bool = False) -> Dict[str, object]:
        """Execution-ledger progress of the latest (or live) execution —
        the ``GET /executor_state`` payload (the reference's executor
        substate, ExecutorState.java:331-389, plus the ledger's bytes/ETA/
        curve accounting)."""
        with self._lock:
            out: Dict[str, object] = {"state": self._state.value,
                                      "ledgerEnabled": self._ledger_enabled}
            led = self._ledger
        if led is not None:
            out.update(led.to_dict(verbose=verbose))
        return out

    # -- reservation handshake (Executor.java:828) --------------------------
    def set_generating_proposals_for_execution(self) -> None:
        with self._lock:
            if self._state != ExecutorState.NO_TASK_IN_PROGRESS:
                raise OngoingExecutionError(
                    f"cannot reserve executor in state {self._state}")
            self._state = ExecutorState.GENERATING_PROPOSALS_FOR_EXECUTION
            self._reserved_for_proposals = True

    def failed_generating_proposals_for_execution(self) -> None:
        with self._lock:
            if self._reserved_for_proposals:
                self._reserved_for_proposals = False
                self._state = ExecutorState.NO_TASK_IN_PROGRESS

    # -- stop signals -------------------------------------------------------
    def stop_execution(self, force: bool = False) -> None:
        with self._lock:
            if self.has_ongoing_execution:
                self._stop_requested = True
                self._force_stop = force
                self._state = ExecutorState.STOPPING_EXECUTION
        if force:
            self._admin.cancel_reassignments()

    # -- broker history ------------------------------------------------------
    def _gc_history(self, history: Dict[int, int], now_ms: int,
                    retention_ms: Optional[int] = None) -> None:
        keep_ms = retention_ms if retention_ms is not None else self._retention_ms
        expired = [b for b, t in history.items() if now_ms - t > keep_ms]
        for b in expired:
            del history[b]

    def add_recently_removed_brokers(self, brokers: Sequence[int],
                                     now_ms: Optional[int] = None) -> None:
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        with self._lock:
            for b in brokers:
                self._recently_removed[b] = now

    def add_recently_demoted_brokers(self, brokers: Sequence[int],
                                     now_ms: Optional[int] = None) -> None:
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        with self._lock:
            for b in brokers:
                self._recently_demoted[b] = now

    def drop_recently_removed_brokers(self, brokers: Sequence[int]) -> None:
        with self._lock:
            for b in brokers:
                self._recently_removed.pop(b, None)

    def recently_removed_brokers(self, now_ms: Optional[int] = None) -> Set[int]:
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        with self._lock:
            self._gc_history(self._recently_removed, now)
            return set(self._recently_removed)

    def recently_demoted_brokers(self, now_ms: Optional[int] = None) -> Set[int]:
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        with self._lock:
            self._gc_history(self._recently_demoted, now,
                             self._demoted_retention_ms)
            return set(self._recently_demoted)

    @contextmanager
    def _phase_probe(self, phase: str, tasks: int,
                     ledger: Optional[ExecutionLedger] = None,
                     journal: Optional[ExecutionJournal] = None):
        """Span + duration histogram around one execution phase.  Yields the
        span so the phase runner can annotate polls/batches/bytes onto it."""
        hist = SENSORS.histogram(
            "Executor.phase-duration-seconds", labels={"phase": phase},
            help="Wall time spent in each execution phase")
        if ledger is not None:
            ledger.phase_started(phase)
        if journal is not None:
            journal.phase(phase, self._clock_ms())
        with TRACE.span(f"executor.{phase}", tasks=tasks) as sp, hist.time():
            yield sp

    # -- fault-tolerant dispatch (retry/backoff + per-broker breaker) --------
    def _circuit_open(self, brokers, now_ms: int) -> bool:
        """True when any involved broker's admin circuit is open.  An
        elapsed cooldown resets the entry (half-open: the next call gets a
        fresh retry budget)."""
        with self._lock:
            for b in brokers:
                st = self._breaker.get(b)
                if st is None:
                    continue
                if st[1] > now_ms:
                    return True
                if st[1]:
                    self._breaker.pop(b, None)
        return False

    def _record_admin_failure(self, brokers) -> None:
        now = self._clock_ms()
        with self._lock:
            for b in brokers:
                st = self._breaker.setdefault(b, [0, 0])
                st[0] += 1
                if st[0] >= self._breaker_threshold and st[1] <= now:
                    st[1] = now + self._breaker_cooldown_ms
                    self._sensor_breaker_opens.inc()

    def _record_admin_success(self, brokers) -> None:
        with self._lock:
            for b in brokers:
                self._breaker.pop(b, None)

    def _call_admin(self, fn: Callable[[], None], brokers) -> bool:
        """Retry/timeout envelope around one ClusterAdmin call: transient
        failures retry with exponential backoff; exhausting the budget
        records a per-broker failure (tripping the circuit breaker at the
        threshold) and returns False so the caller aborts the affected
        tasks instead of wedging the phase loop."""
        delay = self._admin_retry_backoff_s
        attempts = self._admin_max_retries
        while True:
            try:
                fn()
            except TransientAdminError:
                if attempts <= 0:
                    self._sensor_retry_giveups.inc()
                    self._record_admin_failure(brokers)
                    return False
                attempts -= 1
                self._sensor_retries.inc()
                if delay:
                    time.sleep(delay)
                    delay *= 2
                continue
            self._record_admin_success(brokers)
            return True

    # -- main entry ----------------------------------------------------------
    def execute_proposals(self, proposals: Sequence[ExecutionProposal],
                          partition_names: Sequence[Tp],
                          context: Optional[StrategyContext] = None,
                          max_polls: int = 10_000,
                          poll_interval_s: Optional[float] = None,
                          concurrency_adjust_metrics: Optional[
                              Callable[[], Dict[int, Dict[str, float]]]] = None,
                          strategy: Optional[ReplicaMovementStrategy] = None,
                          replication_throttle: Optional[int] = None,
                          balancedness_scorer=None,
                          replanner: Optional[Replanner] = None,
                          replan_interval_polls: int = 0,
                          journal_path: Optional[str] = None,
                          crash_after_polls: Optional[int] = None
                          ) -> ExecutionResult:
        """Run the full three-phase execution to completion.

        ``partition_names[p.partition]`` maps a proposal's dense partition id
        to its (topic, partition) — the naming seam between the tensor world
        and the cluster protocol.  ``poll_interval_s=None`` uses the
        configured execution.progress.check.interval.ms cadence.
        ``strategy`` / ``replication_throttle`` override the boot-time
        movement strategy and throttle rate for THIS execution only (the
        reference accepts both per request,
        ParameterUtils.java:418 + :733; KafkaCruiseControl.java:465-495).
        ``balancedness_scorer`` (a ``PlacementScorer``) attaches goal-distance
        re-scoring to the ledger's checkpoints — batched at phase boundaries,
        never per poll.

        Interruptible execution: ``journal_path`` appends the in-flight plan
        + every transition to a sidecar JSONL file (flushed once per ledger
        poll, host-side only) so :meth:`resume` can continue after a crash.
        ``replanner`` + ``replan_interval_polls`` N re-solve against the
        partially-moved cluster every N polls (at the same boundaries
        ``score_checkpoints`` dispatches) and patch the live queue —
        cancel-what-changed, keep-what-still-helps; the ``CRUISE_REPLAN=0``
        env kill-switch disables it.  ``crash_after_polls`` is the fault
        hook: raise :class:`SimulatedCrash` once the ledger's cumulative
        poll count reaches the given value (tests/bench kill-resume legs).
        """
        if poll_interval_s is None:
            poll_interval_s = self._progress_check_interval_s
        if journal_path is not None and not self._ledger_enabled:
            raise ValueError("journaling requires ledger_enabled=True")
        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError("an execution is already in progress")
            if self._admin.ongoing_reassignments():
                raise OngoingExecutionError(
                    "ongoing partition reassignments detected (started by another "
                    "tool or a previous run) — refusing to execute; force-stop to adopt")
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested = False
            self._force_stop = False
            self._reserved_for_proposals = False
        self._sensor_started.inc()

        if self._on_pause:
            self._on_pause("ongoing execution")
        try:
            effective_strategy = strategy if strategy is not None else self._strategy
            planner = ExecutionTaskPlanner(effective_strategy)
            throttle = (ReplicationThrottleHelper(self._admin, replication_throttle)
                        if replication_throttle is not None else self._throttle)
            plan = planner.plan(proposals, context)
            tm = ExecutionTaskManager(plan, self._limits)
            ledger: Optional[ExecutionLedger] = None
            journal: Optional[ExecutionJournal] = None
            if self._ledger_enabled:
                rate = (replication_throttle if replication_throttle is not None
                        else self._throttle.rate_bytes_per_sec)
                ledger = ExecutionLedger(self._clock_ms,
                                         throttle_rate_bytes_per_sec=rate,
                                         scorer=balancedness_scorer)
                ledger.attach(plan)
                if journal_path is not None:
                    journal = ExecutionJournal(journal_path)
                    journal.start(plan, partition_names, tm.limits, max_polls,
                                  replication_throttle, ledger.started_ms)
                    ledger.set_event_sink(journal.event)
            with self._lock:
                self._task_manager = tm
                self._ledger = ledger
            ctx = _ExecutionCtx(
                plan=plan, tm=tm, ledger=ledger, journal=journal,
                throttle=throttle, partition_names=partition_names,
                max_polls=max_polls, poll_interval_s=poll_interval_s,
                metrics_fn=concurrency_adjust_metrics,
                strategy=effective_strategy, replanner=replanner,
                replan_interval_polls=replan_interval_polls,
                crash_after_polls=crash_after_polls)
            return self._drive(ctx, n_proposals=len(proposals))
        finally:
            with self._lock:
                self._state = ExecutorState.NO_TASK_IN_PROGRESS
            if self._on_resume:
                self._on_resume()

    def resume(self, journal_path: str,
               balancedness_scorer=None,
               poll_interval_s: Optional[float] = None,
               concurrency_adjust_metrics: Optional[
                   Callable[[], Dict[int, Dict[str, float]]]] = None,
               replanner: Optional[Replanner] = None,
               replan_interval_polls: int = 0,
               max_polls: Optional[int] = None,
               crash_after_polls: Optional[int] = None) -> ExecutionResult:
        """Continue a journaled execution after a crash or stop.

        Replays the journal into a fresh plan/task-manager/ledger (see
        :mod:`cruise_control_tpu_torch.executor.journal`), adopts the tasks that
        were in flight at the kill point (their reassignments persist in
        the cluster), and re-enters the phase loop mid-phase; completed
        phases are skipped.  The final placement and ledger totals are
        bit-identical to an uninterrupted run.

        A corrupt journal falls back to a clean abort: ongoing
        reassignments are cancelled, ``ongoing_execution`` is cleared, and
        the :class:`JournalError` propagates.
        """
        if poll_interval_s is None:
            poll_interval_s = self._progress_check_interval_s
        with self._lock:
            if self.has_ongoing_execution:
                raise OngoingExecutionError("an execution is already in progress")
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested = False
            self._force_stop = False
            self._reserved_for_proposals = False
        self._sensor_resume_started.inc()
        try:
            st = rebuild_journal(journal_path, scorer=balancedness_scorer)
        except JournalError:
            self._sensor_resume_errors.inc()
            # Clean abort: drop orphaned reassignments, clear state, let the
            # caller see the corruption.
            self._admin.cancel_reassignments()
            with self._lock:
                self._state = ExecutorState.NO_TASK_IN_PROGRESS
            raise
        journal = ExecutionJournal(journal_path, append=True)
        st.ledger.set_clock(self._clock_ms)
        st.ledger.set_event_sink(journal.event)
        throttle = (ReplicationThrottleHelper(self._admin,
                                              st.replication_throttle)
                    if st.replication_throttle is not None else self._throttle)
        with self._lock:
            self._task_manager = st.task_manager
            self._ledger = st.ledger
        self._sensor_resume_adopted.inc(len(st.in_flight))
        self._sensor_resume_completed.inc()
        if self._on_pause:
            self._on_pause("resumed execution")
        try:
            ctx = _ExecutionCtx(
                plan=st.plan, tm=st.task_manager, ledger=st.ledger,
                journal=journal, throttle=throttle,
                partition_names=st.partition_names,
                max_polls=(max_polls if max_polls is not None
                           else st.max_polls),
                poll_interval_s=poll_interval_s,
                metrics_fn=concurrency_adjust_metrics,
                strategy=self._strategy, replanner=replanner,
                replan_interval_polls=replan_interval_polls,
                crash_after_polls=crash_after_polls)
            return self._drive(ctx, n_proposals=st.plan.total_tasks,
                               done_phases=st.done_phases,
                               adopted=st.in_flight, polls_start=st.polls)
        finally:
            with self._lock:
                self._state = ExecutorState.NO_TASK_IN_PROGRESS
            if self._on_resume:
                self._on_resume()

    # -- the shared phase driver ---------------------------------------------
    def _drive(self, ctx: "_ExecutionCtx", n_proposals: int,
               done_phases: frozenset = frozenset(),
               adopted: Optional[Dict[int, ExecutionTask]] = None,
               polls_start: int = 0) -> ExecutionResult:
        plan, tm, ledger, journal = ctx.plan, ctx.tm, ctx.ledger, ctx.journal
        partition_names = ctx.partition_names
        polls = polls_start
        stopped = False
        try:
            with TRACE.span("executor.execute", proposals=n_proposals,
                            inter_broker_tasks=len(plan.inter_broker_tasks),
                            intra_broker_tasks=len(plan.intra_broker_tasks),
                            leadership_tasks=len(plan.leadership_tasks),
                            resumed=bool(polls_start)) as sp:
                # Phase 1: inter-broker replica movement (throttled).
                if plan.inter_broker_tasks and "inter_broker" not in done_phases:
                    with self._lock:
                        self._state = ExecutorState.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
                    ctx.throttle.set_throttles(plan.inter_broker_tasks,
                                               partition_names)
                    try:
                        with self._phase_probe("inter_broker",
                                               len(plan.inter_broker_tasks),
                                               ledger, journal) as psp:
                            phase_polls, stopped = self._run_inter_broker_phase(
                                ctx, psp, adopted=adopted,
                                polls_budget=max(1, ctx.max_polls - polls_start))
                            polls += phase_polls
                    finally:
                        ctx.throttle.clear_throttles(plan.inter_broker_tasks,
                                                     partition_names)
                    if ledger is not None:
                        ledger.score_checkpoints()

                # Phase 2: intra-broker (logdir) movement.
                if plan.intra_broker_tasks and "intra_broker" not in done_phases \
                        and not stopped and not self._stop_requested:
                    with self._lock:
                        self._state = ExecutorState.INTRA_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
                    with self._phase_probe("intra_broker",
                                           len(plan.intra_broker_tasks),
                                           ledger, journal) as psp:
                        self._run_intra_broker_phase(ctx, psp)

                # Phase 3: leadership movement (batched preferred elections).
                if plan.leadership_tasks and "leadership" not in done_phases \
                        and not stopped and not self._stop_requested:
                    with self._lock:
                        self._state = ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS
                    with self._phase_probe("leadership",
                                           len(plan.leadership_tasks),
                                           ledger, journal) as psp:
                        self._run_leadership_phase(ctx, psp, adopted=adopted)

                stopped = stopped or self._stop_requested
                if stopped and self._force_stop:
                    # Terminal-ize everything through the ledger observer so
                    # gauges and the curve reflect the abort instead of
                    # counting dead work as in-flight/pending forever.
                    self._finalize_force_stop(plan, tm)
                buckets = tm.tasks_by_state()
                if stopped:
                    self._sensor_stopped.inc()
                self._sensor_completed.inc(len(buckets[TaskState.COMPLETED]))
                self._sensor_dead.inc(len(buckets[TaskState.DEAD]))
                if ledger is not None:
                    ledger.finished()
                    ledger.poll(tm, force=True)
                    ledger.score_checkpoints()
                    sp.annotate(bytes_total=ledger.total_bytes,
                                bytes_moved=ledger.bytes_moved)
                sp.annotate(completed=len(buckets[TaskState.COMPLETED]),
                            dead=len(buckets[TaskState.DEAD]),
                            stopped=stopped, polls=polls)
                if journal is not None:
                    journal.close()
                return ExecutionResult(
                    completed=len(buckets[TaskState.COMPLETED]),
                    dead=len(buckets[TaskState.DEAD]),
                    aborted=len(buckets[TaskState.ABORTED]),
                    polls=polls, stopped=stopped)
        except SimulatedCrash:
            # A process death runs no finalization: the journal stays torn
            # at its last flushed poll line and the admin keeps its
            # in-flight reassignments — exactly what resume() expects.
            if journal is not None:
                journal.close()
            raise

    def _finalize_force_stop(self, plan: ExecutionPlan,
                             tm: ExecutionTaskManager) -> None:
        """Force-stop epilogue: every non-terminal task reaches a terminal
        state through its observer (in-flight → ABORTING → ABORTED, pending
        → cancelled), releasing in-flight accounting so ``Executor.*``
        gauges and the time-to-balanced curve record the abort."""
        now = self._clock_ms()
        for t in (plan.inter_broker_tasks + plan.intra_broker_tasks
                  + plan.leadership_tasks):
            if t.state == TaskState.IN_PROGRESS:
                t.aborting(now)
                t.aborted(now)
                tm.finished(t)
            elif t.state == TaskState.ABORTING:
                t.aborted(now)
                tm.finished(t)
            elif t.state == TaskState.PENDING:
                t.cancel(now)
                tm.finished(t)

    # -- phases --------------------------------------------------------------
    def _target_replicas(self, task: ExecutionTask) -> Tuple[int, ...]:
        return tuple(r.broker for r in task.proposal.new_replicas)

    def _poll_tick(self, ctx: "_ExecutionCtx") -> None:
        """One ledger poll + journal flush + crash fault hook (the journal
        write serializes host-side Python state only — no device fetch)."""
        if ctx.ledger is None:
            return
        ctx.ledger.poll(ctx.tm)
        if ctx.journal is not None:
            ctx.journal.poll(self._clock_ms())
        if ctx.crash_after_polls is not None \
                and ctx.ledger.polls >= ctx.crash_after_polls:
            raise SimulatedCrash(
                f"injected crash at ledger poll {ctx.ledger.polls}")

    def _adjust_concurrency(self, tm: ExecutionTaskManager, metrics_fn,
                            ledger: Optional[ExecutionLedger],
                            journal: Optional[ExecutionJournal] = None) -> None:
        """One adjuster evaluation; classifies the decision (halve / double /
        hold) by comparing the per-broker limit before and after, since the
        adjuster itself is interval-gated and may return the input."""
        before = tm.limits.inter_broker_per_broker
        tm.set_limits(self._adjuster.adjust(
            tm.limits, metrics_fn(),
            has_min_isr_pressure=self._min_isr_pressure_fn()))
        after = tm.limits.inter_broker_per_broker
        decision = ("halve" if after < before
                    else "double" if after > before else "hold")
        self._sensor_adjuster[decision].inc()
        if ledger is not None:
            ledger.adjuster_decision(decision)
        if decision != "hold" and journal is not None:
            journal.limits(tm.limits)

    # -- replan-while-executing ----------------------------------------------
    def _replan_round(self, ctx: "_ExecutionCtx",
                      submitted: Dict[int, ExecutionTask]) -> None:
        """One phase-boundary replan: score the curve (the same boundary
        where ``score_checkpoints`` dispatches), hand the landed/in-flight
        partition sets to the replanner, and patch the live queue against
        the directive — cancel-what-changed, keep-what-still-helps, add
        what's newly needed.  Any failure keeps the static plan."""
        ledger = ctx.ledger
        if ledger is not None:
            ledger.score_checkpoints()
        landed = frozenset(ledger._landed) if ledger is not None else frozenset()
        inflight = frozenset(t.proposal.partition for t in submitted.values())
        try:
            directive = ctx.replanner(landed, inflight)
        except Exception:
            self._sensor_replan["fallbacks"].inc()
            return
        if directive is None or directive.proposals is None:
            self._sensor_replan["fallbacks"].inc()
            return

        now = self._clock_ms()
        new_by_part = {p.partition: p for p in directive.proposals}
        all_tasks = (ctx.plan.inter_broker_tasks + ctx.plan.intra_broker_tasks
                     + ctx.plan.leadership_tasks)
        pending_by_part: Dict[int, List[ExecutionTask]] = {}
        for t in all_tasks:
            if t.state == TaskState.PENDING:
                pending_by_part.setdefault(t.proposal.partition, []).append(t)
        cancelled = kept = 0
        covered = set()
        for part, tasks in pending_by_part.items():
            np_ = new_by_part.get(part)
            if np_ is not None and np_.new_replicas == tasks[0].proposal.new_replicas:
                kept += len(tasks)
                covered.add(part)
            else:
                for t in tasks:
                    t.cancel(now)
                    ctx.tm.finished(t)
                    cancelled += 1
        add_props = [p for part, p in new_by_part.items()
                     if part not in covered and part not in inflight]
        added_tasks: List[ExecutionTask] = []
        if add_props:
            next_id = max((t.execution_id for t in all_tasks), default=-1) + 1
            planner = ExecutionTaskPlanner(ctx.strategy,
                                           first_execution_id=next_id)
            addition = planner.plan(add_props, None)
            added_tasks = (addition.inter_broker_tasks
                           + addition.intra_broker_tasks
                           + addition.leadership_tasks)
            ctx.plan.inter_broker_tasks.extend(addition.inter_broker_tasks)
            ctx.plan.intra_broker_tasks.extend(addition.intra_broker_tasks)
            ctx.plan.leadership_tasks.extend(addition.leadership_tasks)
            for b, ts in addition.tasks_by_broker.items():
                ctx.plan.tasks_by_broker.setdefault(b, []).extend(ts)
        if ledger is not None:
            ledger.replan_rebase(added_tasks, cancelled, kept,
                                 scorer=directive.scorer)
        if ctx.journal is not None:
            ctx.journal.replan(added_tasks, cancelled, kept, now)
        self._sensor_replan["rounds"].inc()
        self._sensor_replan["cancelled"].inc(cancelled)
        self._sensor_replan["kept"].inc(kept)
        self._sensor_replan["added"].inc(len(added_tasks))
        TRACE.annotate(replan_cancelled=cancelled, replan_kept=kept,
                       replan_added=len(added_tasks))

    def _run_inter_broker_phase(self, ctx: "_ExecutionCtx", span=None,
                                adopted: Optional[Dict[int, ExecutionTask]] = None,
                                polls_budget: Optional[int] = None
                                ) -> Tuple[int, bool]:
        tm, ledger, journal = ctx.tm, ctx.ledger, ctx.journal
        partition_names = ctx.partition_names
        max_polls = polls_budget if polls_budget is not None else ctx.max_polls
        # Resume path: adopt the tasks that were in flight at the crash —
        # their reassignments persist in the cluster, so the ordinary
        # completion checks below pick them up.
        submitted: Dict[int, ExecutionTask] = {
            eid: t for eid, t in (adopted or {}).items()
            if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION}
        polls = 0
        batches = 0
        can_replan = (ctx.replanner is not None
                      and ctx.replan_interval_polls > 0 and replan_enabled())
        crashed = False
        try:
            while polls < max_polls:
                if self._stop_requested:
                    # Graceful stop: let in-flight tasks finish, admit no more;
                    # force-stop also cancels in-flight (handled via admin above).
                    for t in list(submitted.values()):
                        if self._force_stop and t.state == TaskState.IN_PROGRESS:
                            now = self._clock_ms()
                            t.aborting(now)
                            t.aborted(now)
                            tm.finished(t)
                            del submitted[t.execution_id]
                    if self._force_stop:
                        return polls, True
                else:
                    new_tasks = tm.next_inter_broker_tasks()
                    if new_tasks:
                        batches += 1
                        now = self._clock_ms()
                        runnable: List[ExecutionTask] = []
                        for t in new_tasks:
                            if self._circuit_open(t.brokers_involved(), now):
                                # Circuit open on a destination: abort the
                                # task now (a later replan round re-plans
                                # the partition) instead of wedging.
                                t.cancel(now)
                                tm.finished(t)
                            else:
                                runnable.append(t)
                        if runnable:
                            reqs = []
                            for t in runnable:
                                t.in_progress(now)
                                reqs.append(ReassignmentRequest(
                                    tp=partition_names[t.proposal.partition],
                                    new_replicas=self._target_replicas(t)))
                            batch_brokers = {b for t in runnable
                                             for b in t.brokers_involved()}
                            if self._call_admin(
                                    lambda: self._admin.alter_partition_reassignments(reqs),
                                    batch_brokers):
                                for t in runnable:
                                    submitted[t.execution_id] = t
                                if journal is not None:
                                    journal.flush()
                            else:
                                now2 = self._clock_ms()
                                for t in runnable:
                                    t.aborting(now2)
                                    t.aborted(now2)
                                    tm.finished(t)

                ongoing = self._admin.ongoing_reassignments()
                cluster = self._metadata.cluster()
                by_tp = {p.tp: p for p in cluster.partitions}
                alive = set(cluster.alive_broker_ids())
                for t in list(submitted.values()):
                    tp = tuple(partition_names[t.proposal.partition])
                    target = set(self._target_replicas(t))
                    part = by_tp.get(tp)
                    if tp not in ongoing and part is not None and \
                            set(part.replicas) == target:
                        t.completed(self._clock_ms())
                        tm.finished(t)
                        del submitted[t.execution_id]
                    elif not target <= alive:
                        # Destination broker died mid-move (Executor.java:1548).
                        if t.state == TaskState.IN_PROGRESS:
                            t.kill(self._clock_ms())
                            tm.finished(t)
                            self._admin.cancel_reassignments([tp])
                            del submitted[t.execution_id]
                polls += 1
                self._poll_tick(ctx)
                if ctx.metrics_fn is not None and self._adjuster_enabled:
                    self._adjust_concurrency(tm, ctx.metrics_fn, ledger, journal)
                if can_replan and polls % ctx.replan_interval_polls == 0 \
                        and not self._stop_requested:
                    self._replan_round(ctx, submitted)
                if not submitted:
                    pending = [t for t in ctx.plan.inter_broker_tasks
                               if t.state == TaskState.PENDING]
                    if not pending or self._stop_requested:
                        return polls, False
                if ctx.poll_interval_s:
                    time.sleep(ctx.poll_interval_s)
            return polls, True
        except SimulatedCrash:
            crashed = True
            raise
        finally:
            # A (simulated) process death runs no phase finalization.
            if not crashed:
                if ledger is not None:
                    ledger.phase_finished(polls=polls, batches=batches)
                if journal is not None:
                    journal.phase_end("inter_broker", self._clock_ms(),
                                      polls, batches)
                if span is not None:
                    span.annotate(polls=polls, batches=batches)
                    if ledger is not None:
                        span.annotate(bytes_moved=ledger.bytes_moved)

    def _run_intra_broker_phase(self, ctx: "_ExecutionCtx", span=None) -> None:
        tm, ledger, journal = ctx.tm, ctx.ledger, ctx.journal
        partition_names = ctx.partition_names
        batches = 0
        crashed = False
        try:
            while True:
                tasks = tm.next_intra_broker_tasks()
                if not tasks:
                    break
                batches += 1
                moves = []
                now = self._clock_ms()
                for t in tasks:
                    t.in_progress(now)
                    for broker, _old_disk, new_disk in t.proposal._intra_broker_moves():
                        logdir = self._logdir_by_disk.get(new_disk, f"/logdir-{new_disk}")
                        moves.append((partition_names[t.proposal.partition], broker, logdir))
                batch_brokers = {b for t in tasks for b in t.brokers_involved()}
                ok = self._call_admin(
                    lambda: self._admin.alter_replica_logdirs(moves),
                    batch_brokers)
                now = self._clock_ms()
                for t in tasks:
                    if ok:
                        t.completed(now)
                    else:
                        t.aborting(now)
                        t.aborted(now)
                    tm.finished(t)
                self._poll_tick(ctx)
        except SimulatedCrash:
            crashed = True
            raise
        finally:
            if not crashed:
                if ledger is not None:
                    ledger.phase_finished(batches=batches)
                if journal is not None:
                    journal.phase_end("intra_broker", self._clock_ms(),
                                      0, batches)
                if span is not None:
                    span.annotate(batches=batches)

    def _run_leadership_phase(self, ctx: "_ExecutionCtx", span=None,
                              adopted: Optional[Dict[int, ExecutionTask]] = None
                              ) -> None:
        tm, ledger, journal = ctx.tm, ctx.ledger, ctx.journal
        partition_names = ctx.partition_names
        batches = 0
        total_polls = 0
        # Resume path: leadership tasks that were in flight at the crash
        # already have their preferred-order reassignments submitted (or
        # applied) — drive them through the wait/elect cycle WITHOUT
        # re-submitting.
        carried = [t for t in (adopted or {}).values()
                   if t.task_type == TaskType.LEADER_ACTION
                   and t.state == TaskState.IN_PROGRESS]
        crashed = False
        try:
            while not self._stop_requested:
                resubmit = not carried
                if carried:
                    tasks, carried = carried, []
                else:
                    tasks = tm.next_leadership_tasks()
                    if not tasks:
                        break
                batches += 1
                # Make the proposal's leader the preferred replica then trigger a
                # batched preferred-leader election (moveLeaderships,
                # Executor.java:1373-1399).
                now = self._clock_ms()
                if resubmit:
                    reqs = [ReassignmentRequest(
                        tp=partition_names[t.proposal.partition],
                        new_replicas=self._target_replicas(t))
                        for t in tasks]
                    for t in tasks:
                        t.in_progress(now)
                    batch_brokers = {b for t in tasks
                                     for b in t.brokers_involved()}
                    if not self._call_admin(
                            lambda: self._admin.alter_partition_reassignments(reqs),
                            batch_brokers):
                        now2 = self._clock_ms()
                        for t in tasks:
                            t.aborting(now2)
                            t.aborted(now2)
                            tm.finished(t)
                        self._poll_tick(ctx)
                        continue
                    if journal is not None:
                        journal.flush()
                polls = 0
                deadline = time.monotonic() + self._leader_movement_timeout_ms / 1000.0
                while self._admin.ongoing_reassignments() and polls < ctx.max_polls \
                        and not self._force_stop and time.monotonic() < deadline:
                    polls += 1
                    if ctx.poll_interval_s:
                        time.sleep(ctx.poll_interval_s)
                total_polls += polls
                timed_out = (polls >= ctx.max_polls or self._force_stop
                             or (self._admin.ongoing_reassignments()
                                 and time.monotonic() >= deadline))
                if not timed_out:
                    self._call_admin(
                        lambda: self._admin.elect_leaders(
                            [partition_names[t.proposal.partition]
                             for t in tasks]),
                        {b for t in tasks for b in t.brokers_involved()})
                else:
                    # Don't leave the preferred-order reassignments of killed
                    # tasks in flight (same cleanup as the inter-broker DEAD
                    # path; the reference deletes the reassignment znodes).
                    self._admin.cancel_reassignments(
                        [partition_names[t.proposal.partition] for t in tasks])
                now = self._clock_ms()
                for t in tasks:
                    if timed_out:
                        t.kill(now)
                    else:
                        t.completed(now)
                    tm.finished(t)
                self._poll_tick(ctx)
                if timed_out:
                    break
        except SimulatedCrash:
            crashed = True
            raise
        finally:
            if not crashed:
                if ledger is not None:
                    ledger.phase_finished(polls=total_polls, batches=batches)
                if journal is not None:
                    journal.phase_end("leadership", self._clock_ms(),
                                      total_polls, batches)
                if span is not None:
                    span.annotate(polls=total_polls, batches=batches)


@dataclasses.dataclass
class _ExecutionCtx:
    """Everything one execution's phase loop threads through — built once
    by ``execute_proposals`` (fresh run) or ``resume`` (journal replay),
    consumed by ``_drive`` and the phase runners."""

    plan: ExecutionPlan
    tm: ExecutionTaskManager
    ledger: Optional[ExecutionLedger]
    journal: Optional[ExecutionJournal]
    throttle: ReplicationThrottleHelper
    partition_names: Sequence[Tp]
    max_polls: int
    poll_interval_s: float
    metrics_fn: Optional[Callable[[], Dict[int, Dict[str, float]]]]
    strategy: Optional[ReplicaMovementStrategy]
    replanner: Optional[Replanner]
    replan_interval_polls: int
    crash_after_polls: Optional[int]
