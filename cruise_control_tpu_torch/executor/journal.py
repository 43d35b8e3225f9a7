"""Execution journal: crash-exact resume for in-flight executions.

The `sharded_fixpoint` resume pattern applied to the executor: the live
execution appends its full mutable state to a sidecar JSONL file — the plan
(proposals + task order), every task transition, concurrency-limit changes,
replan patches, phase markers, and one line per ledger poll — and flushes
once per poll.  ``Executor.resume()`` replays the journal through a fresh
``ExecutionTaskManager`` + ``ExecutionLedger`` and continues mid-phase: the
replayed ledger is rebuilt by driving the *same* observer/poll code paths
with the recorded clock, so counts, bytes, landed sets, stride-sampled
checkpoints, and phase records come out bit-identical to the live run's at
the crash point.

Line kinds (one JSON object per line):

- ``header``  — version, partition names, limits, throttle, poll budget,
  start clock.  Always the first line.
- ``task``    — one per planned task, in plan (strategy) order:
  execution id, type, full proposal.
- ``event``   — a task transition (id, from, to, tMs).
- ``poll``    — one ledger poll (cumulative count + clock); the flush point.
- ``phase`` / ``phase_end`` — phase cursor.
- ``limits``  — a concurrency-adjuster change.
- ``replan``  — a live replan patch: tasks it ADDED (cancellations arrive
  as ordinary PENDING→ABORTED event lines) plus cancelled/kept counts.

Crash semantics: a torn final line is the normal signature of a kill and is
ignored; a corrupt header or mid-file garbage raises :class:`JournalError`
(the caller falls back to a clean abort).  Everything here is host-side
Python — journal writes never touch the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cruise_control_tpu_torch.analyzer.proposals import (ExecutionProposal,
                                                   ReplicaPlacement)
from cruise_control_tpu_torch.executor.ledger import ExecutionLedger
from cruise_control_tpu_torch.executor.planner import ExecutionPlan
from cruise_control_tpu_torch.executor.task import ExecutionTask, TaskState, TaskType
from cruise_control_tpu_torch.executor.task_manager import (ConcurrencyLimits,
                                                      ExecutionTaskManager)

JOURNAL_VERSION = 1


class JournalError(RuntimeError):
    """Unrecoverable journal corruption (missing/garbled header or mid-file
    garbage) — resume must fall back to a clean abort."""


# -- proposal (de)serialization ----------------------------------------------

def _placement_to_json(p: ReplicaPlacement) -> List[int]:
    return [int(p.broker), int(p.disk)]


def proposal_to_json(p: ExecutionProposal) -> dict:
    return {
        "p": int(p.partition),
        "t": int(p.topic),
        "sz": float(p.partition_size),
        "ol": _placement_to_json(p.old_leader),
        "or": [_placement_to_json(x) for x in p.old_replicas],
        "nr": [_placement_to_json(x) for x in p.new_replicas],
    }


def proposal_from_json(d: dict) -> ExecutionProposal:
    return ExecutionProposal(
        partition=int(d["p"]), topic=int(d["t"]), partition_size=float(d["sz"]),
        old_leader=ReplicaPlacement(*d["ol"]),
        old_replicas=tuple(ReplicaPlacement(*x) for x in d["or"]),
        new_replicas=tuple(ReplicaPlacement(*x) for x in d["nr"]))


def _limits_to_json(limits: ConcurrencyLimits) -> dict:
    return dataclasses.asdict(limits)


def _limits_from_json(d: dict) -> ConcurrencyLimits:
    return ConcurrencyLimits(**d)


def _task_to_json(t: ExecutionTask) -> dict:
    return {"kind": "task", "id": t.execution_id, "type": t.task_type.value,
            "proposal": proposal_to_json(t.proposal)}


def _task_from_json(d: dict) -> ExecutionTask:
    return ExecutionTask(int(d["id"]), proposal_from_json(d["proposal"]),
                         TaskType(d["type"]))


# -- writer -------------------------------------------------------------------

class ExecutionJournal:
    """Append-only JSONL writer for one execution.  ``start()`` writes the
    header + plan; transition events buffer and hit the disk at the next
    ``poll()`` flush (so journal I/O amortizes to one small write + flush
    per executor wait-loop iteration)."""

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self._f = open(path, "a" if append else "w", encoding="utf-8")

    def _line(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, separators=(",", ":")) + "\n")

    def start(self, plan: ExecutionPlan, partition_names: Sequence[Tuple[str, int]],
              limits: ConcurrencyLimits, max_polls: int,
              replication_throttle: Optional[int], started_ms: int) -> None:
        self._line({"kind": "header", "version": JOURNAL_VERSION,
                    "partitionNames": [[t, i] for t, i in partition_names],
                    "limits": _limits_to_json(limits),
                    "maxPolls": int(max_polls),
                    "replicationThrottle": replication_throttle,
                    "startedMs": int(started_ms)})
        for t in (plan.inter_broker_tasks + plan.intra_broker_tasks
                  + plan.leadership_tasks):
            self._line(_task_to_json(t))
        self.flush()

    def event(self, task: ExecutionTask, old_state: TaskState,
              new_state: TaskState, now_ms: int) -> None:
        self._line({"kind": "event", "id": task.execution_id,
                    "from": old_state.value, "to": new_state.value,
                    "tMs": int(now_ms)})

    def poll(self, t_ms: int) -> None:
        self._line({"kind": "poll", "tMs": int(t_ms)})
        self.flush()

    def phase(self, name: str, t_ms: int) -> None:
        self._line({"kind": "phase", "phase": name, "tMs": int(t_ms)})
        self.flush()

    def phase_end(self, name: str, t_ms: int, polls: int, batches: int) -> None:
        self._line({"kind": "phase_end", "phase": name, "tMs": int(t_ms),
                    "polls": int(polls), "batches": int(batches)})
        self.flush()

    def limits(self, limits: ConcurrencyLimits) -> None:
        self._line({"kind": "limits", "limits": _limits_to_json(limits)})

    def replan(self, added: Sequence[ExecutionTask], cancelled: int,
               kept: int, t_ms: int) -> None:
        self._line({"kind": "replan", "tMs": int(t_ms),
                    "cancelled": int(cancelled), "kept": int(kept),
                    "added": [_task_to_json(t) for t in added]})
        self.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.flush()
            self._f.close()
        except ValueError:
            pass


# -- reader / replay ----------------------------------------------------------

class _ReplayClock:
    """Settable clock the replay drives so the rebuilt ledger records the
    journaled timestamps, not wall time."""

    def __init__(self, t_ms: int = 0):
        self.t_ms = int(t_ms)

    def __call__(self) -> int:
        return self.t_ms


@dataclasses.dataclass
class ResumeState:
    """Everything ``Executor.resume()`` needs to continue mid-phase."""

    plan: ExecutionPlan
    task_manager: ExecutionTaskManager
    ledger: ExecutionLedger
    partition_names: List[Tuple[str, int]]
    limits: ConcurrencyLimits
    max_polls: int
    replication_throttle: Optional[int]
    done_phases: Set[str]
    current_phase: Optional[str]
    in_flight: Dict[int, ExecutionTask]   # adopted (IN_PROGRESS at crash)
    polls: int
    clock: _ReplayClock


def _read_lines(path: str) -> List[dict]:
    """Parse the journal, tolerating exactly one torn line at the tail
    (the crash signature).  Garbage anywhere else is corruption."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read().split("\n")
    except OSError as e:
        raise JournalError(f"cannot read journal {path}: {e}")
    if raw and raw[-1] == "":
        raw.pop()
    lines: List[dict] = []
    for i, text in enumerate(raw):
        try:
            obj = json.loads(text)
            if not isinstance(obj, dict) or "kind" not in obj:
                raise ValueError("not a journal line")
        except ValueError:
            if i == len(raw) - 1:
                break  # torn tail: normal crash artifact
            raise JournalError(f"corrupt journal line {i + 1} in {path}")
        lines.append(obj)
    if not lines or lines[0].get("kind") != "header":
        raise JournalError(f"journal {path} has no header")
    if lines[0].get("version") != JOURNAL_VERSION:
        raise JournalError(
            f"journal {path} version {lines[0].get('version')} unsupported")
    return lines


_PHASE_OF_TYPE = {
    TaskType.INTER_BROKER_REPLICA_ACTION: "inter_broker",
    TaskType.INTRA_BROKER_REPLICA_ACTION: "intra_broker",
    TaskType.LEADER_ACTION: "leadership",
}


def _extend_plan(plan: ExecutionPlan, tasks: Sequence[ExecutionTask]) -> None:
    for t in tasks:
        if t.task_type == TaskType.INTER_BROKER_REPLICA_ACTION:
            plan.inter_broker_tasks.append(t)
            for b in t.brokers_involved():
                plan.tasks_by_broker.setdefault(b, []).append(t)
        elif t.task_type == TaskType.INTRA_BROKER_REPLICA_ACTION:
            plan.intra_broker_tasks.append(t)
        else:
            plan.leadership_tasks.append(t)


def rebuild(path: str, scorer=None) -> ResumeState:
    """Replay the journal into a fresh plan/task-manager/ledger.

    The replay drives the real transition + poll code paths under the
    recorded clock, so every derived quantity (counts, bytes, landed set,
    checkpoint curve incl. stride thinning, phase records) is rebuilt by
    construction rather than deserialized — identical logic, identical
    state.  Raises :class:`JournalError` on corruption."""
    lines = _read_lines(path)
    header = lines[0]
    partition_names = [(t, int(i)) for t, i in header["partitionNames"]]
    limits = _limits_from_json(header["limits"])
    clock = _ReplayClock(header["startedMs"])

    plan = ExecutionPlan(inter_broker_tasks=[], intra_broker_tasks=[],
                         leadership_tasks=[], tasks_by_broker={})
    by_id: Dict[int, ExecutionTask] = {}
    idx = 1
    while idx < len(lines) and lines[idx]["kind"] == "task":
        t = _task_from_json(lines[idx])
        by_id[t.execution_id] = t
        _extend_plan(plan, [t])
        idx += 1

    ledger = ExecutionLedger(clock, throttle_rate_bytes_per_sec=header.get(
        "replicationThrottle"), scorer=scorer)
    ledger.attach(plan)
    tm = ExecutionTaskManager(plan, limits)
    done_phases: Set[str] = set()
    current_phase: Optional[str] = None

    try:
        for line in lines[idx:]:
            kind = line["kind"]
            if kind == "event":
                t = by_id[line["id"]]
                to = TaskState(line["to"])
                clock.t_ms = line["tMs"]
                t._transition(to, now_ms=line["tMs"])
                # Mirror the task manager's live admission bookkeeping.
                if to == TaskState.IN_PROGRESS:
                    tm._inflight.add(t.execution_id)
                    if t.task_type != TaskType.LEADER_ACTION:
                        for b in t.brokers_involved():
                            tm._inflight_by_broker[b] = \
                                tm._inflight_by_broker.get(b, 0) + 1
                elif to in (TaskState.COMPLETED, TaskState.ABORTED,
                            TaskState.DEAD):
                    tm.finished(t)
            elif kind == "poll":
                clock.t_ms = line["tMs"]
                ledger.poll(tm)
            elif kind == "phase":
                clock.t_ms = line["tMs"]
                ledger.phase_started(line["phase"])
                current_phase = line["phase"]
            elif kind == "phase_end":
                clock.t_ms = line["tMs"]
                ledger.phase_finished(polls=line["polls"],
                                      batches=line["batches"])
                done_phases.add(line["phase"])
                current_phase = None
            elif kind == "limits":
                limits = _limits_from_json(line["limits"])
                tm.set_limits(limits)
            elif kind == "replan":
                added = [_task_from_json(d) for d in line["added"]]
                for t in added:
                    by_id[t.execution_id] = t
                _extend_plan(plan, added)
                clock.t_ms = line["tMs"]
                ledger.replan_rebase(added, cancelled=line["cancelled"],
                                     kept=line["kept"])
            elif kind == "task":
                raise JournalError(f"stray task line after events in {path}")
    except (KeyError, ValueError, TypeError) as e:
        raise JournalError(f"journal {path} replay failed: {e}")

    in_flight = {t.execution_id: t for t in by_id.values()
                 if t.state == TaskState.IN_PROGRESS}
    return ResumeState(
        plan=plan, task_manager=tm, ledger=ledger,
        partition_names=partition_names, limits=limits,
        max_polls=int(header["maxPolls"]),
        replication_throttle=header.get("replicationThrottle"),
        done_phases=done_phases, current_phase=current_phase,
        in_flight=in_flight, polls=ledger.polls, clock=clock)


def remove_journal(path: str) -> None:
    """Best-effort cleanup once an execution fully completes."""
    try:
        os.remove(path)
    except OSError:
        pass
