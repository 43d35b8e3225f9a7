"""Async user-task tracking.

Counterpart of ``cruise_control_tpu/api/user_tasks.py`` (host code, copied, on
the port's ``TRACE``).

Parity with ``UserTaskManager`` (servlet/UserTaskManager.java:55-67):
operations run on worker threads under a UUID; re-requesting the same
(method, path, query, session) returns the in-flight task's progress or the
completed result; completed tasks are retained for a TTL and listed by
``/user_tasks``; per-step ``OperationProgress`` mirrors
async/progress/OperationProgress.java.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from cruise_control_tpu_torch.common.tracing import TRACE


@dataclasses.dataclass
class OperationStep:
    name: str
    start_ms: int
    end_ms: int = -1


class OperationProgress:
    """async/progress/OperationProgress.java: ordered step list."""

    def __init__(self):
        self._lock = threading.Lock()
        self._steps: List[OperationStep] = []

    def add_step(self, name: str) -> None:
        now = int(time.time() * 1000)
        with self._lock:
            if self._steps and self._steps[-1].end_ms < 0:
                self._steps[-1].end_ms = now
            self._steps.append(OperationStep(name, now))

    def finish(self) -> None:
        now = int(time.time() * 1000)
        with self._lock:
            if self._steps and self._steps[-1].end_ms < 0:
                self._steps[-1].end_ms = now

    def to_list(self) -> List[Dict[str, object]]:
        with self._lock:
            return [{"step": s.name, "startMs": s.start_ms,
                     "durationMs": (s.end_ms if s.end_ms >= 0
                                    else int(time.time() * 1000)) - s.start_ms}
                    for s in self._steps]


class TaskStatus:
    ACTIVE = "Active"
    COMPLETED = "Completed"
    COMPLETED_WITH_ERROR = "CompletedWithError"
    KILLED = "Killed"


@dataclasses.dataclass
class UserTask:
    task_id: str
    endpoint: str
    request_key: Tuple
    status: str
    start_ms: int
    progress: OperationProgress
    result: Optional[object] = None
    error: Optional[str] = None
    end_ms: int = -1
    #: Finished span tree for this operation (set when the worker thread
    #: completes); served by GET /trace?task_id=<task_id>.
    trace: Optional[Dict[str, object]] = None

    def summary(self) -> Dict[str, object]:
        return {"UserTaskId": self.task_id, "RequestURL": self.endpoint,
                "Status": self.status, "StartMs": self.start_ms,
                "Progress": self.progress.to_list()}


class UserTaskManager:
    def __init__(self, completed_retention_ms: int = 6 * 3600 * 1000,
                 max_active_tasks: int = 25,
                 max_cached_completed: int = 100):
        # max.active.user.tasks / completed.user.task.retention.time.ms /
        # max.cached.completed.user.tasks (UserTaskManagerConfig).
        self._lock = threading.Lock()
        self._tasks: Dict[str, UserTask] = {}
        self._by_key: Dict[Tuple, str] = {}
        self._retention_ms = completed_retention_ms
        self._max_active = max_active_tasks
        self._max_cached_completed = max_cached_completed

    def _gc(self, now_ms: int) -> None:
        expired = [tid for tid, t in self._tasks.items()
                   if t.status != TaskStatus.ACTIVE
                   and now_ms - t.end_ms > self._retention_ms]
        for tid in expired:
            t = self._tasks.pop(tid)
            # Only drop the key mapping if it still points at THIS task — a
            # resubmitted identical request may own the key by now, and
            # popping it would break duplicate-request joining.
            if self._by_key.get(t.request_key) == t.task_id:
                self._by_key.pop(t.request_key, None)
        completed = sorted((t for t in self._tasks.values()
                            if t.status != TaskStatus.ACTIVE),
                           key=lambda t: t.end_ms)
        for t in completed[:max(0, len(completed) - self._max_cached_completed)]:
            self._tasks.pop(t.task_id, None)
            if self._by_key.get(t.request_key) == t.task_id:
                self._by_key.pop(t.request_key, None)

    def submit(self, endpoint: str, request_key: Tuple,
               fn: Callable[[OperationProgress], object],
               join_completed: bool = False) -> UserTask:
        """Start (or join) the task for this request.  An identical request
        joins the task only while it is ACTIVE (a repeat after completion
        re-executes — returning hours-stale results for a mutating operation
        would be wrong); ``join_completed`` opts into returning the finished
        result instead (the purgatory flow, where a review id must execute
        exactly once)."""
        now = int(time.time() * 1000)
        with self._lock:
            self._gc(now)
            existing = self._by_key.get(request_key)
            if existing is not None and existing in self._tasks:
                task = self._tasks[existing]
                if task.status == TaskStatus.ACTIVE or join_completed:
                    return task
            active = sum(1 for t in self._tasks.values()
                         if t.status == TaskStatus.ACTIVE)
            if active >= self._max_active:
                raise RuntimeError("too many active user tasks")
            task = UserTask(task_id=str(uuid.uuid4()), endpoint=endpoint,
                            request_key=request_key, status=TaskStatus.ACTIVE,
                            start_ms=now, progress=OperationProgress())
            self._tasks[task.task_id] = task
            self._by_key[request_key] = task.task_id

        def run():
            # The worker thread has an empty span stack, so this span is the
            # trace ROOT; every span the operation opens (facade → monitor →
            # analyzer → executor) nests under it.
            with TRACE.span(f"request.{endpoint}", task_id=task.task_id) as sp:
                try:
                    task.result = fn(task.progress)
                    task.status = TaskStatus.COMPLETED
                except Exception as e:  # noqa: BLE001 — surfaced via the API
                    task.error = f"{type(e).__name__}: {e}"
                    task.status = TaskStatus.COMPLETED_WITH_ERROR
                finally:
                    task.progress.finish()
                    task.end_ms = int(time.time() * 1000)
                    sp.annotate(status=task.status)
            if sp.trace_id is not None:
                task.trace = TRACE.get(sp.trace_id)

        threading.Thread(target=run, name=f"user-task-{task.task_id[:8]}",
                         daemon=True).start()
        return task

    def get(self, task_id: str) -> Optional[UserTask]:
        with self._lock:
            return self._tasks.get(task_id)

    def find_by_key(self, request_key: Tuple) -> Optional[UserTask]:
        with self._lock:
            tid = self._by_key.get(request_key)
            return self._tasks.get(tid) if tid else None

    def list_tasks(self) -> List[Dict[str, object]]:
        with self._lock:
            self._gc(int(time.time() * 1000))
            return [t.summary() for t in
                    sorted(self._tasks.values(), key=lambda t: t.start_ms)]
