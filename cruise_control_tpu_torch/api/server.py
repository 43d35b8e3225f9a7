"""REST API server.

Counterpart of ``cruise_control_tpu/api/server.py`` on the port's facade,
telemetry and detectors (no ``app`` module: the realm file is read by
``api.security.load_credentials``).

Parity with the servlet layer (servlet/KafkaCruiseControlServlet.java:40 +
CruiseControlEndPoint.java:16-37): the 20 endpoints in their 4 permission
groups, served under ``/kafkacruisecontrol/<endpoint>`` by a stdlib
ThreadingHTTPServer (the Jetty analogue — no external deps):

GET  (KAFKA_MONITOR):   LOAD, PARTITION_LOAD, PROPOSALS, KAFKA_CLUSTER_STATE
GET  (CC_MONITOR):      STATE, USER_TASKS, REVIEW_BOARD
POST (KAFKA_ADMIN):     ADD_BROKER, REMOVE_BROKER, FIX_OFFLINE_REPLICAS,
                        REBALANCE, DEMOTE_BROKER, TOPIC_CONFIGURATION
POST (CC_ADMIN):        STOP_PROPOSAL_EXECUTION, PAUSE_SAMPLING,
                        RESUME_SAMPLING, ADMIN, REVIEW, BOOTSTRAP, TRAIN

Long-running operations run through the ``UserTaskManager`` — the response
carries a ``User-Task-ID`` header; polling the same URL (or ``user_tasks``)
returns progress until the result is ready (UserTaskManager.java:55-66).
POST endpoints optionally require 2-step verification via the purgatory
(``two_step_verification=True``).  Security is a pluggable
``SecurityProvider`` (servlet/security/SecurityProvider.java) with
HTTP-Basic and permissive defaults; roles ADMIN > USER > VIEWER.

Incremental telemetry (``/stream`` cursor semantics — the same
resume-by-id discipline as the purgatory's ``review_id`` above): every
point published into the telemetry store carries a contiguous, monotone
sequence number.  ``GET /stream?since=N`` returns the retained events with
``seq > N`` as newline-delimited JSON objects (``text/plain`` body, one
object per line) plus an ``X-Stream-Cursor`` header naming the last seq in
the batch; a client that reconnects with ``since=<last cursor>`` sees no
gaps and no duplicates while its cursor is inside the log's retention ring
(``X-Stream-Truncated: true`` says it fell behind and must re-sync from
``GET /timeseries``).
"""

from __future__ import annotations

import base64
import dataclasses
import hmac
import json
import mimetypes
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cruise_control_tpu_torch.api.facade import CruiseControl
from cruise_control_tpu_torch.api.purgatory import Purgatory
from cruise_control_tpu_torch.api.user_tasks import TaskStatus, UserTaskManager
from cruise_control_tpu_torch.common.sensors import SENSORS
from cruise_control_tpu_torch.common.timeseries import TELEMETRY
from cruise_control_tpu_torch.common.tracing import TRACE
from cruise_control_tpu_torch.detector.anomalies import AnomalyType

PREFIX = "/kafkacruisecontrol"

GET_ENDPOINTS = {"bootstrap", "train", "load", "partition_load", "proposals",
                 "state", "kafka_cluster_state", "user_tasks", "review_board",
                 "metrics", "trace", "flight", "executor_state",
                 "timeseries", "stream"}
POST_ENDPOINTS = {"add_broker", "remove_broker", "fix_offline_replicas",
                  "rebalance", "stop_proposal_execution", "pause_sampling",
                  "resume_sampling", "demote_broker", "admin", "review",
                  "topic_configuration"}

# Permission groups (CruiseControlEndPoint.java:16-37).
ROLE_VIEWER, ROLE_USER, ROLE_ADMIN = "VIEWER", "USER", "ADMIN"
_ENDPOINT_ROLE = {e: ROLE_VIEWER for e in GET_ENDPOINTS}
_ENDPOINT_ROLE.update({e: ROLE_ADMIN for e in POST_ENDPOINTS})
_ENDPOINT_ROLE.update({"user_tasks": ROLE_USER, "review_board": ROLE_USER,
                       "bootstrap": ROLE_ADMIN, "train": ROLE_ADMIN})
_ROLE_RANK = {ROLE_VIEWER: 0, ROLE_USER: 1, ROLE_ADMIN: 2}


class SecurityProvider:
    """servlet/security/SecurityProvider.java analogue."""

    def authenticate(self, headers) -> Optional[str]:
        """Return the caller's role, or None to reject."""
        return ROLE_ADMIN


class BasicSecurityProvider(SecurityProvider):
    """HTTP Basic (servlet/security/BasicSecurityProvider.java): credentials
    {user: (password, role)}."""

    def __init__(self, credentials: Optional[Dict[str, Tuple[str, str]]] = None):
        self._creds = credentials if credentials is not None else {}

    def configure(self, config: Dict[str, object]) -> None:
        """Plugin-style init (webserver.security.provider): loads the
        realm file named by webserver.auth.credentials.file."""
        from cruise_control_tpu_torch.api.security import load_credentials
        from cruise_control_tpu_torch.config import constants as C
        path = config.get(C.WEBSERVER_AUTH_CREDENTIALS_FILE_CONFIG)
        if path:
            self._creds = load_credentials(str(path))

    def authenticate(self, headers) -> Optional[str]:
        auth = headers.get("Authorization", "")
        if not auth.startswith("Basic "):
            return None
        try:
            user, pw = base64.b64decode(auth[6:]).decode().split(":", 1)
        except Exception:  # noqa: BLE001 — malformed header
            return None
        entry = self._creds.get(user)
        # Compare as bytes: compare_digest on str raises for non-ASCII input,
        # which would crash the request instead of returning 401.
        if entry is None or not hmac.compare_digest(entry[0].encode(), pw.encode()):
            return None
        return entry[1]


class BadRequest(Exception):
    pass


def _parse_bool(q: Dict[str, str], key: str, default: bool) -> bool:
    v = q.get(key)
    if v is None:
        return default
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise BadRequest(f"invalid boolean for {key!r}: {v!r}")


def _parse_ids(q: Dict[str, str], key: str) -> List[int]:
    raw = q.get(key, "")
    if not raw:
        return []
    try:
        return [int(x) for x in raw.split(",") if x]
    except ValueError as e:
        raise BadRequest(f"invalid id list for {key!r}: {raw!r}") from e


def _parse_goals(q: Dict[str, str]) -> Optional[List[str]]:
    raw = q.get("goals", "")
    return [g for g in raw.split(",") if g] or None


def _parse_excluded_topics(q: Dict[str, str]) -> Optional[str]:
    """Per-request excluded-topics regex (ParameterUtils.java:898) —
    overrides the boot topics.excluded.from.partition.movement pattern."""
    raw = q.get("excluded_topics")
    if not raw:
        return None
    try:
        re.compile(raw)
    except re.error as e:
        raise BadRequest(f"invalid excluded_topics regex {raw!r}: {e}") from e
    return raw


def _parse_strategies(q: Dict[str, str]) -> Optional[List[str]]:
    """Per-request movement-strategy chain (ParameterUtils.java:733)."""
    names = [s for s in q.get("replica_movement_strategies", "").split(",") if s]
    if not names:
        return None
    from cruise_control_tpu_torch.executor.strategy import resolve_strategy
    try:
        resolve_strategy(names)
    except ValueError as e:
        raise BadRequest(str(e)) from e
    return names


def _parse_throttle(q: Dict[str, str]) -> Optional[int]:
    """Per-request replication throttle rate (ParameterUtils.java:418)."""
    raw = q.get("replication_throttle")
    if raw is None:
        return None
    try:
        rate = int(raw)
    except ValueError as e:
        raise BadRequest(f"invalid replication_throttle {raw!r}") from e
    if rate <= 0:
        raise BadRequest(f"replication_throttle must be positive, got {rate}")
    return rate


class CruiseControlApi:
    """Endpoint dispatch, decoupled from HTTP plumbing for testability."""

    def __init__(self, cc: CruiseControl, detector_manager=None, sampler=None,
                 two_step_verification: bool = False,
                 security: Optional[SecurityProvider] = None,
                 user_tasks: Optional[UserTaskManager] = None,
                 purgatory: Optional[Purgatory] = None,
                 telemetry=None):
        self.cc = cc
        self.detector_manager = detector_manager
        self.sampler = sampler
        # The telemetry time-series store /timeseries and /stream read
        # from; defaults to the process-wide singleton the facade /
        # detector / ledger publishers write into.
        self.telemetry = telemetry or TELEMETRY
        self.user_tasks = user_tasks or UserTaskManager()
        self.purgatory = (purgatory or Purgatory()) if two_step_verification \
            else None
        self.security = security or SecurityProvider()
        self.request_meters: Dict[str, int] = {}
        self._local = threading.local()  # per-request purgatory review key

    # -- dispatch ----------------------------------------------------------
    def handle(self, method: str, endpoint: str, query: Dict[str, str],
               headers=None) -> Tuple[int, Dict[str, object], Dict[str, str]]:
        """Returns (http_status, json_body, extra_headers).  Every request
        to a known endpoint is metered: a latency histogram and a
        status-code counter, both labeled by endpoint (the reference's
        successful-request-execution-timer per endpoint,
        KafkaCruiseControlServlet.java)."""
        endpoint = endpoint.lower()
        valid = GET_ENDPOINTS if method == "GET" else POST_ENDPOINTS
        if endpoint not in valid:
            # Unknown endpoints are NOT metered — arbitrary request paths
            # would make the label set unbounded.
            return 404, {"error": f"unknown {method} endpoint {endpoint!r}",
                         "validEndpoints": sorted(valid)}, {}
        t0 = time.monotonic()
        status, body, extra = self._handle(method, endpoint, query, headers)
        SENSORS.histogram(
            "webserver.request-duration-seconds",
            labels={"endpoint": endpoint},
            help="Wall time spent handling an API request, by endpoint",
        ).observe(time.monotonic() - t0)
        SENSORS.counter(
            "webserver.responses-total",
            labels={"endpoint": endpoint, "code": status},
            help="API responses by endpoint and HTTP status code",
        ).inc()
        return status, body, extra

    def _handle(self, method: str, endpoint: str, query: Dict[str, str],
                headers=None) -> Tuple[int, Dict[str, object], Dict[str, str]]:
        role = self.security.authenticate(headers or {})
        if role is None:
            # Challenge-based schemes (SPNEGO's Negotiate) advertise the
            # mechanism on rejection (RFC 4559 §4.1).
            challenge = getattr(self.security, "challenge_headers", None)
            return 401, {"error": "authentication required"}, \
                (challenge() if callable(challenge) else {})
        if _ROLE_RANK[role] < _ROLE_RANK[_ENDPOINT_ROLE[endpoint]]:
            return 403, {"error": f"endpoint {endpoint} requires "
                                  f"{_ENDPOINT_ROLE[endpoint]}"}, {}
        self.request_meters[endpoint] = self.request_meters.get(endpoint, 0) + 1

        # Purgatory gate for mutating POSTs (Purgatory.java:43).
        mutating = endpoint in ("add_broker", "remove_broker", "rebalance",
                                "demote_broker", "fix_offline_replicas",
                                "topic_configuration")
        review_key = None
        if self.purgatory is not None and method == "POST" and mutating:
            rid = query.get("review_id")
            if rid is None:
                req = self.purgatory.add(endpoint, query)
                return 202, {"reviewId": req.review_id,
                             "status": req.status,
                             "message": "request parked for review"}, {}
            try:
                rid = int(rid)
            except ValueError:
                return 400, {"error": f"invalid review_id {rid!r}"}, {}
            try:
                req = self.purgatory.take_approved(rid, endpoint)
            except (KeyError, ValueError) as e:
                # Polling an already-SUBMITTED review must keep returning the
                # running/completed task instead of failing the client.
                task = self.user_tasks.find_by_key(("review", endpoint, rid))
                if task is not None:
                    return self._task_response(task)
                return 400, {"error": str(e)}, {}
            # Execute EXACTLY the reviewed parameters — overriding them at
            # resubmission would bypass the review (two-step verification).
            passthrough = {k: v for k, v in query.items() if k == "max_wait_s"}
            query = {**req.query, **passthrough}
            review_key = ("review", endpoint, req.review_id)

        try:
            self._local.review_key = review_key
            return getattr(self, f"_ep_{endpoint}")(query)
        except BadRequest as e:
            return 400, {"error": str(e)}, {}
        except Exception as e:  # noqa: BLE001 — servlet-style error payload
            return 500, {"error": f"{type(e).__name__}: {e}",
                         "stackTrace": True}, {}

    def _async(self, endpoint: str, query: Dict[str, str],
               fn: Callable) -> Tuple[int, Dict[str, object], Dict[str, str]]:
        """Run via UserTaskManager; identical re-requests join while active.
        A purgatory-approved request is keyed by its review id so it executes
        exactly once and re-polls keep returning its result."""
        review_key = getattr(self._local, "review_key", None)
        key = review_key or (endpoint, tuple(sorted(query.items())))
        task = self.user_tasks.submit(endpoint, key, fn,
                                      join_completed=review_key is not None)
        return self._task_response(task, float(query.get("max_wait_s", "10")))

    def _task_response(self, task, max_wait_s: float = 0.0
                       ) -> Tuple[int, Dict[str, object], Dict[str, str]]:
        deadline = time.monotonic() + max_wait_s
        while task.status == TaskStatus.ACTIVE and time.monotonic() < deadline:
            time.sleep(0.02)
        headers = {"User-Task-ID": task.task_id}
        if task.status == TaskStatus.ACTIVE:
            return 202, {"progress": task.progress.to_list(),
                         "userTaskId": task.task_id}, headers
        if task.status == TaskStatus.COMPLETED_WITH_ERROR:
            return 500, {"error": task.error, "userTaskId": task.task_id}, headers
        result = task.result
        if dataclasses.is_dataclass(result):
            result = result.to_dict()
        elif not isinstance(result, (dict, list)):
            result = {"result": result}
        return 200, result, headers

    # -- GET endpoints -----------------------------------------------------
    def _ep_state(self, q):
        payload = self.cc.state(self.detector_manager)
        substates = q.get("substates")
        if substates:
            # Accept monitor / executor / analyzer / anomaly_detector in any
            # underscore/camel spelling.
            want = {s.strip().lower().replace("_", "") for s in substates.split(",")}
            payload = {k: v for k, v in payload.items()
                       if k.lower().replace("state", "") in want}
        return 200, payload, {}

    def _ep_kafka_cluster_state(self, q):
        return 200, self.cc.kafka_cluster_state(), {}

    def _ep_executor_state(self, q):
        """Execution-ledger progress: live per-broker in-flight, bytes
        moved/total, ETA, adjuster decisions, per-phase records and the
        balancedness-over-time checkpoints.  ``?verbose=true`` adds the
        per-broker map, checkpoint curve and recent lifecycle events (the
        reference's ExecutorState verbose JSON, ExecutorState.java:332)."""
        verbose = _parse_bool(q, "verbose", False)
        return 200, self.cc.executor.progress(verbose=verbose), {}

    def _ep_metrics(self, q):
        """Sensor registry (Sensors.md): JSON by default; Prometheus
        exposition text with ?format=prometheus (the /metrics surface the
        reference exports via JMX)."""
        if q.get("format") == "prometheus":
            return 200, PlainText(SENSORS.prometheus_text()), {}
        return 200, SENSORS.snapshot(), {}

    def _ep_timeseries(self, q):
        """Windowed rollups from the telemetry time-series store
        (docs/OBSERVABILITY.md "Telemetry time-series & SLA").  Without
        ``?series=`` lists the known series names and store config; with a
        comma-separated ``?series=`` returns per-step aggregate buckets
        (count/sum/min/max/last/mean) over ``?window=`` seconds at
        ``?step=`` seconds granularity.  Entirely host-side reads — never
        triggers a device fetch."""
        names = q.get("series")
        if not names:
            return 200, {"series": self.telemetry.series_names(),
                         "config": self.telemetry.config_dict()}, {}
        try:
            window_s = float(q.get("window", "3600"))
            step_s = float(q.get("step", "60"))
        except ValueError as exc:
            raise BadRequest(f"bad window/step: {exc}")
        if window_s <= 0:
            raise BadRequest("window must be > 0 seconds")
        out = {}
        for name in (n.strip() for n in names.split(",")):
            if not name:
                continue
            out[name] = self.telemetry.query(
                name, window_ms=int(window_s * 1000),
                step_ms=int(step_s * 1000))
        return 200, {"windowMs": int(window_s * 1000),
                     "stepMs": int(step_s * 1000), "series": out}, {}

    def _ep_stream(self, q):
        """Incremental point stream, resumable by sequence number (the
        cursor discipline documented in the module docstring above).  Body
        is JSON lines; ``X-Stream-Cursor`` carries the next ``since`` and
        ``X-Stream-Truncated: true`` means the client fell behind the ring
        and must re-sync from ``/timeseries``."""
        try:
            since = int(q.get("since", "0"))
            limit = int(q.get("limit", "1000"))
        except ValueError as exc:
            raise BadRequest(f"bad since/limit: {exc}")
        if since < 0 or limit <= 0:
            raise BadRequest("since must be >= 0 and limit > 0")
        events, cursor, truncated = self.telemetry.stream_since(since, limit)
        body = "".join(json.dumps(e, sort_keys=True) + "\n" for e in events)
        return 200, PlainText(body), {
            "X-Stream-Cursor": str(cursor),
            "X-Stream-Truncated": "true" if truncated else "false"}

    def _ep_trace(self, q):
        """Finished operation traces.  ``?task_id=`` returns the span tree
        attached to that user task; ``?trace_id=`` looks up the global ring
        buffer; with neither, lists recent root traces."""
        task_id = q.get("task_id")
        if task_id:
            task = self.user_tasks.get(task_id)
            if task is None:
                return 404, {"error": f"unknown task_id {task_id!r}"}, {}
            if task.trace is None:
                if task.status == TaskStatus.ACTIVE:
                    return 202, {"userTaskId": task.task_id,
                                 "status": task.status,
                                 "message": "trace not finished yet"}, {}
                return 404, {"error": f"no trace recorded for task "
                                      f"{task_id!r}"}, {}
            return 200, {"userTaskId": task.task_id, "status": task.status,
                         "trace": task.trace}, {}
        trace_id = q.get("trace_id")
        if trace_id:
            t = TRACE.get(trace_id)
            if t is None:
                return 404, {"error": f"unknown trace_id {trace_id!r}"}, {}
            return 200, {"trace": t}, {}
        limit = int(q.get("limit", "20"))
        return 200, {"traces": TRACE.recent(limit),
                     "rollup": TRACE.rollup()}, {}

    def _ep_flight(self, q):
        """Flight-recorder convergence timelines of a task's optimization:
        the per-goal per-step telemetry the analyzer attached to its
        ``analyzer.goal`` spans (CRUISE_FLIGHT_RECORDER=1 runs only).
        ``?task_id=`` is required; 202 while the task is still ACTIVE."""
        task_id = q.get("task_id")
        if not task_id:
            return 400, {"error": "flight requires ?task_id="}, {}
        task = self.user_tasks.get(task_id)
        if task is None:
            return 404, {"error": f"unknown task_id {task_id!r}"}, {}
        if task.trace is None:
            if task.status == TaskStatus.ACTIVE:
                return 202, {"userTaskId": task.task_id,
                             "status": task.status,
                             "message": "trace not finished yet"}, {}
            return 404, {"error": f"no trace recorded for task "
                                  f"{task_id!r}"}, {}
        goals = []

        def walk(span):
            attrs = span.get("attrs") or {}
            if span.get("name") == "analyzer.goal" and "flight" in attrs:
                goals.append({"goal": attrs.get("goal"),
                              "steps": attrs.get("steps"),
                              "actions": attrs.get("actions"),
                              "durationMs": span.get("durationMs"),
                              "flight": attrs["flight"]})
            for c in span.get("children") or []:
                walk(c)

        walk(task.trace)
        if not goals:
            return 404, {"error": "no flight data on this task's trace — "
                                  "was CRUISE_FLIGHT_RECORDER=1 (or "
                                  "analyzer.flight.recorder) set when the "
                                  "task ran?"}, {}
        return 200, {"userTaskId": task.task_id, "status": task.status,
                     "goals": goals}, {}

    def _ep_load(self, q):
        def fn(progress):
            progress.add_step("WaitingForClusterModel")
            progress.add_step("GeneratingClusterModel")
            return self.cc.broker_load()
        return self._async("load", q, fn)

    def _ep_partition_load(self, q):
        max_entries = int(q.get("entries", "100"))
        return 200, {"records": self.cc.partition_load(max_entries)}, {}

    def _ep_proposals(self, q):
        ignore_cache = _parse_bool(q, "ignore_proposal_cache", False)
        goals = _parse_goals(q)
        excluded = _parse_excluded_topics(q)
        # Tri-state: absent defers to analyzer.warm.start.enabled,
        # warm=true/false overrides per request.
        warm = None if "warm" not in q else _parse_bool(q, "warm", True)

        def fn(progress):
            progress.add_step("GeneratingClusterModel")
            progress.add_step("OptimizationProposalGeneration")
            return self.cc.proposals(goals=goals, ignore_proposal_cache=ignore_cache,
                                     excluded_topics_pattern=excluded,
                                     warm=warm)
        return self._async("proposals", q, fn)

    def _ep_user_tasks(self, q):
        return 200, {"userTasks": self.user_tasks.list_tasks()}, {}

    def _ep_review_board(self, q):
        if self.purgatory is None:
            return 400, {"error": "two-step verification is disabled"}, {}
        return 200, {"requests": self.purgatory.board()}, {}

    def _ep_bootstrap(self, q):
        if self.sampler is None:
            return 400, {"error": "no sampler configured for bootstrap"}, {}
        start = int(q.get("start", "0"))
        end = int(q.get("end", str(start + 1)))

        def fn(progress):
            progress.add_step("Bootstrapping")
            n = self.cc.load_monitor.bootstrap(self.sampler, start, end)
            return {"samplesLoaded": n}
        return self._async("bootstrap", q, fn)

    def _ep_train(self, q):
        from cruise_control_tpu_torch.model.cpu_model import CpuModelTrainer
        from cruise_control_tpu_torch.monitor.metricdef import KAFKA_METRIC_DEF

        def fn(progress):
            progress.add_step("Training")
            trainer = CpuModelTrainer()
            agg = self.cc.load_monitor.broker_aggregator.aggregate()
            cpu = KAFKA_METRIC_DEF.metric_info("CPU_USAGE").metric_id
            bin_ = KAFKA_METRIC_DEF.metric_info("LEADER_BYTES_IN").metric_id
            bout = KAFKA_METRIC_DEF.metric_info("LEADER_BYTES_OUT").metric_id
            rep = KAFKA_METRIC_DEF.metric_info("REPLICATION_BYTES_IN_RATE").metric_id
            for row in range(agg.values.shape[0]):
                for w in range(agg.values.shape[1]):
                    if agg.window_valid[row, w]:
                        v = agg.values[row, w]
                        trainer.add_observation(v[bin_], v[bout], v[rep], v[cpu])
            params = trainer.train()
            return {"trained": params.trained, "numSamples": params.num_samples,
                    "coefficients": {
                        "leaderBytesIn": params.coef_leader_bytes_in,
                        "leaderBytesOut": params.coef_leader_bytes_out,
                        "followerBytesIn": params.coef_follower_bytes_in}}
        return self._async("train", q, fn)

    # -- POST endpoints ----------------------------------------------------
    def _ep_rebalance(self, q):
        dryrun = _parse_bool(q, "dryrun", True)
        goals = _parse_goals(q)
        dests = _parse_ids(q, "destination_broker_ids")
        fast = _parse_bool(q, "fast_mode", False)
        rebalance_disk = _parse_bool(q, "rebalance_disk", False)
        excluded = _parse_excluded_topics(q)
        strategies = _parse_strategies(q)
        throttle = _parse_throttle(q)
        warm = None if "warm" not in q else _parse_bool(q, "warm", True)

        def fn(progress):
            progress.add_step("GeneratingClusterModel")
            progress.add_step("OptimizationForGoals")
            return self.cc.rebalance(goals=goals, dryrun=dryrun,
                                     destination_broker_ids=dests or None,
                                     fast_mode=fast,
                                     rebalance_disk=rebalance_disk,
                                     excluded_topics_pattern=excluded,
                                     replica_movement_strategies=strategies,
                                     replication_throttle=throttle,
                                     warm=warm)
        return self._async("rebalance", q, fn)

    def _ep_add_broker(self, q):
        ids = _parse_ids(q, "brokerid")
        if not ids:
            raise BadRequest("brokerid parameter is required")
        dryrun = _parse_bool(q, "dryrun", True)
        excluded = _parse_excluded_topics(q)
        strategies = _parse_strategies(q)
        throttle = _parse_throttle(q)

        def fn(progress):
            progress.add_step("OptimizationForGoals")
            return self.cc.add_brokers(ids, dryrun=dryrun,
                                       excluded_topics_pattern=excluded,
                                       replica_movement_strategies=strategies,
                                       replication_throttle=throttle)
        return self._async("add_broker", q, fn)

    def _ep_remove_broker(self, q):
        ids = _parse_ids(q, "brokerid")
        if not ids:
            raise BadRequest("brokerid parameter is required")
        dryrun = _parse_bool(q, "dryrun", True)
        excluded = _parse_excluded_topics(q)
        strategies = _parse_strategies(q)
        throttle = _parse_throttle(q)

        def fn(progress):
            progress.add_step("OptimizationForGoals")
            ok = self.cc.remove_brokers(ids, dryrun=dryrun,
                                        excluded_topics_pattern=excluded,
                                        replica_movement_strategies=strategies,
                                        replication_throttle=throttle)
            return {"ok": ok, "removedBrokers": ids, "dryrun": dryrun}
        return self._async("remove_broker", q, fn)

    def _ep_demote_broker(self, q):
        ids = _parse_ids(q, "brokerid")
        if not ids:
            raise BadRequest("brokerid parameter is required")
        dryrun = _parse_bool(q, "dryrun", True)

        def fn(progress):
            progress.add_step("OptimizationForGoals")
            ok = self.cc.demote_brokers(ids, dryrun=dryrun)
            return {"ok": ok, "demotedBrokers": ids, "dryrun": dryrun}
        return self._async("demote_broker", q, fn)

    def _ep_fix_offline_replicas(self, q):
        dryrun = _parse_bool(q, "dryrun", True)

        def fn(progress):
            progress.add_step("OptimizationForGoals")
            ok = self.cc.fix_offline_replicas(dryrun=dryrun)
            return {"ok": ok, "dryrun": dryrun}
        return self._async("fix_offline_replicas", q, fn)

    def _ep_topic_configuration(self, q):
        topic = q.get("topic")
        rf = q.get("replication_factor")
        if not topic or rf is None:
            raise BadRequest("topic and replication_factor are required")
        dryrun = _parse_bool(q, "dryrun", True)

        def fn(progress):
            progress.add_step("UpdatingTopicConfiguration")
            ok = self.cc.update_topic_replication_factor({topic: int(rf)},
                                                         dryrun=dryrun)
            return {"ok": ok, "topic": topic, "replicationFactor": int(rf),
                    "dryrun": dryrun}
        return self._async("topic_configuration", q, fn)

    def _ep_stop_proposal_execution(self, q):
        force = _parse_bool(q, "force_stop", False)
        self.cc.stop_proposal_execution(force=force)
        return 200, {"message": "execution stop requested", "force": force}, {}

    def _ep_pause_sampling(self, q):
        self.cc.pause_sampling(reason=q.get("reason", ""))
        return 200, {"message": "sampling paused"}, {}

    def _ep_resume_sampling(self, q):
        self.cc.resume_sampling()
        return 200, {"message": "sampling resumed"}, {}

    def _ep_admin(self, q):
        """ADMIN endpoint (servlet AdminRequest): self-healing toggles,
        concurrency changes, dropping recently-removed brokers."""
        out: Dict[str, object] = {}
        enable = q.get("enable_self_healing_for")
        disable = q.get("disable_self_healing_for")
        if (enable or disable) and self.detector_manager is None:
            raise BadRequest("anomaly detector is not configured")
        for raw, value in ((enable, True), (disable, False)):
            if raw:
                for name in raw.split(","):
                    try:
                        at = AnomalyType[name.strip().upper()]
                    except KeyError as e:
                        raise BadRequest(f"unknown anomaly type {name!r}") from e
                    old = self.detector_manager.notifier.set_self_healing_for(at, value)
                    out.setdefault("selfHealing", {})[at.name] = \
                        {"before": old, "after": value}
        conc = q.get("concurrent_partition_movements_per_broker")
        if conc is not None:
            limits = dataclasses.replace(self.cc.executor.limits,
                                         inter_broker_per_broker=int(conc))
            self.cc.executor.set_concurrency(limits)
            out["interBrokerPartitionMovementConcurrency"] = int(conc)
        drop = _parse_ids(q, "drop_recently_removed_brokers")
        if drop:
            self.cc.executor.drop_recently_removed_brokers(drop)
            out["droppedRecentlyRemovedBrokers"] = drop
        return 200, out or {"message": "no admin action requested"}, {}

    def _ep_review(self, q):
        if self.purgatory is None:
            return 400, {"error": "two-step verification is disabled"}, {}
        approve = tuple(_parse_ids(q, "approve"))
        discard = tuple(_parse_ids(q, "discard"))
        return 200, {"requests": self.purgatory.review(
            approve, discard, q.get("reason", ""))}, {}


class PlainText(str):
    """Marker: endpoint result is preformatted text, not JSON."""


class HtmlText(str):
    """Marker: endpoint result is an HTML page."""


# Minimal status UI (the reference bundles the separate cruise-control-ui
# webapp behind the same Jetty server, KafkaCruiseControlApp.java:100-195;
# this build ships a single self-contained page driven by the JSON API).
_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>cruise-control-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:72rem}
 h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.5rem}
 pre{background:#f6f8fa;padding:0.8rem;border-radius:6px;overflow:auto}
 a{color:#0969da;text-decoration:none} .row a{margin-right:1rem}
</style></head>
<body>
<h1>cruise-control-tpu</h1>
<div class="row">
 <a href="%PREFIX%/state">state</a>
 <a href="%PREFIX%/kafka_cluster_state">kafka_cluster_state</a>
 <a href="%PREFIX%/proposals">proposals</a>
 <a href="%PREFIX%/metrics">metrics</a>
 <a href="%PREFIX%/executor_state?verbose=true">executor_state</a>
 <a href="%PREFIX%/trace">trace</a>
 <a href="%PREFIX%/user_tasks">user_tasks</a>
</div>
<h2>State</h2><pre id="state">loading…</pre>
<h2>Sensors</h2><pre id="sensors">loading…</pre>
<script>
 fetch("%PREFIX%/state").then(r=>r.json()).then(s=>{
   document.getElementById("sensors").textContent =
     JSON.stringify(s.Sensors ?? {}, null, 2);
   delete s.Sensors;
   document.getElementById("state").textContent = JSON.stringify(s, null, 2);
 }).catch(e=>{document.getElementById("state").textContent = String(e)});
</script>
</body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    api: CruiseControlApi = None  # injected by serve()
    ui_dir: Optional[str] = None  # webserver.ui.diskpath static assets

    def _serve_static(self, path: str) -> bool:
        """Serve a file from ``ui_dir`` (the reference mounts the
        cruise-control-ui webapp dist dir this way,
        KafkaCruiseControlApp.java:100-143).  Returns False when the path
        resolves outside the dir or to no file — callers fall through to
        the built-in status page / 404."""
        rel = urllib.parse.unquote(path).lstrip("/") or "index.html"
        base = os.path.realpath(self.ui_dir)
        full = os.path.realpath(os.path.join(base, rel))
        if full != base and not full.startswith(base + os.sep):
            return False
        if os.path.isdir(full):
            full = os.path.join(full, "index.html")
        if not os.path.isfile(full):
            return False
        with open(full, "rb") as f:
            payload = f.read()
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)
        return True

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        under_api = parsed.path.startswith(PREFIX + "/")
        if method == "GET" and not under_api and self.ui_dir:
            # The UI sits behind the same security provider as the API
            # (the reference's Jetty security handler covers the mounted
            # webapp context too).
            if self.api.security.authenticate(dict(self.headers)) is None:
                challenge = getattr(self.api.security, "challenge_headers", None)
                self._reply(401, {"error": "authentication required"},
                            challenge() if callable(challenge) else {})
                return
            if self._serve_static(parsed.path):
                return
        if method == "GET" and parsed.path.rstrip("/") in ("", PREFIX):
            self._reply(200, HtmlText(_INDEX_HTML.replace("%PREFIX%", PREFIX)),
                        {})
            return
        if not under_api:
            self._reply(404, {"error": f"paths live under {PREFIX}/"}, {})
            return
        endpoint = parsed.path[len(PREFIX) + 1:].strip("/")
        query = {k: v[-1] for k, v in
                 urllib.parse.parse_qs(parsed.query, keep_blank_values=True).items()}
        status, body, headers = self.api.handle(method, endpoint, query,
                                                dict(self.headers))
        self._reply(status, body, headers)

    def _reply(self, status: int, body: Dict, headers: Dict[str, str]) -> None:
        if isinstance(body, HtmlText):
            payload = str(body).encode()
            ctype = "text/html; charset=utf-8"
        elif isinstance(body, PlainText):
            payload = str(body).encode()
            ctype = "text/plain; version=0.0.4"
        else:
            payload = json.dumps(body, default=str).encode()
            ctype = "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def log_message(self, fmt, *args):  # NCSA-style access log, stderr
        import sys
        print(f"{self.address_string()} - [{self.log_date_time_string()}] "
              f"{fmt % args}", file=sys.stderr)


def serve(api: CruiseControlApi, host: str = "127.0.0.1", port: int = 9090,
          ui_dir: Optional[str] = None) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; returns the server object
    (KafkaCruiseControlApp.start analogue).  ``ui_dir`` serves static
    web-UI assets at / (webserver.ui.diskpath)."""
    handler = type("BoundHandler", (_Handler,), {"api": api, "ui_dir": ui_dir})
    server = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="cc-http-server").start()
    return server
